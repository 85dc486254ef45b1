"""Model names to builders: the part of ``acr_wsss_tpu/models/registry.py``
(``register_model`` ``:23``, ``create_model`` ``:130``) that resolves the
Swin and PiT names.

``models/swin.py`` and ``models/pit.py`` register their builders when
they are imported; ``create_model`` imports them. Each builder sets the
JAX builder's defaults (the timm names' ``num_classes`` 1000, or 21841 for
the ``_in22k`` releases, ``distilled`` for the ``_distilled_224`` ones)
and the input size the model is built for (``img_size``): the JAX modules
take their position embedding's (PiT) and window tables' (Swin) shapes
from the input at init, the port's from ``img_size`` at construction.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch.nn as nn

_MODELS: Dict[str, Callable[..., nn.Module]] = {}


def register_model(fn: Callable[..., nn.Module]) -> Callable[..., nn.Module]:
    """Register ``fn`` under its ``__name__``; a name is taken once."""
    if fn.__name__ in _MODELS:
        raise ValueError(f"model {fn.__name__!r} already registered")
    _MODELS[fn.__name__] = fn
    return fn


def _load_builders() -> None:
    from acr_wsss_tpu_torch.models import pit, swin  # noqa: F401  (they register)


def list_models() -> List[str]:
    _load_builders()
    return sorted(_MODELS)


def create_model(name: str, **kwargs) -> nn.Module:
    """The registered model ``name`` built with ``kwargs`` over its defaults;
    an unknown name raises and names the known ones."""
    _load_builders()
    if name not in _MODELS:
        raise ValueError(f"Unknown model {name!r}. Known: {sorted(_MODELS)}")
    return _MODELS[name](**kwargs)
