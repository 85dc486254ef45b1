"""Model names to builders: the port of ``acr_wsss_tpu/models/registry.py``.

``register_model`` (``:23``) files a builder under its name and its
module's; the query helpers (``:34-127``) answer as JAX's do for every
name the port has: ``is_model``, ``model_entrypoint``, ``list_models``
(fnmatch filters, a module, ``pretrained``: names with a zoo URL),
``list_modules``, ``is_model_in_modules``, ``is_model_pretrained``, the
data configuration of ``models/cfg.py`` (``get_default_cfg`` and its
three key helpers), ``split_model_name`` and ``safe_model_name``.

``create_model`` (``:130-236``) builds a registered name over its
defaults, ``None`` kwargs dropped. In PyTorch's idiom, timm's factory's:
it returns the module, with the weights loaded into it where asked:
``checkpoint_path`` (a flat flax ``.npz``, or a timm ``.pth``/``.tar``
through ``zoo.convert_state_dict``) strictly, ``pretrained`` from the
zoo's npz (``zoo.fetch``) through ``zoo.graft_standalone``, which keeps
the model's own head where the checkpoint's has another class count.
JAX returns ``(model, variables)``. ``features_only`` wraps the model in
``models/features.FeatureExtractor`` (``out_indices``, ``feature_cls``
"list" or "dict", ``out_map``); the weights load into the wrapped model.
``scriptable``, ``exportable`` and ``no_jit`` are accepted and ignored, as
in JAX. The ``hf_hub:`` source is not ported: it raises and says so.

The builders register when their modules are imported
(``_load_builders``): ``vit_classifier`` and ``hybrid`` (the classifier
zoo), ``swin`` and ``pit``, ``cnn`` and ``resnet_timm`` (the ResNet, VGG
and DenseNet families), ``cnn_mobile`` (EfficientNet, MobileNetV3,
RegNet), ``cnn_attn`` (SENet, SKNet, Res2Net, ResNeSt, the legacy SENets)
and ``acr`` (the ``acr_*`` names): 262 of JAX's 522 names. Each builder
sets the JAX builder's defaults; the Swin and PiT ones also the input
size the model is built for (``img_size``), which JAX takes from the
input at init. A model is returned in PyTorch's training
mode, as ``nn.Module`` makes it: call ``eval()`` for the running
BatchNorm statistics JAX's ``train=False`` uses.
"""

from __future__ import annotations

import fnmatch
import re
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Set, Union

import torch
import torch.nn as nn

_MODELS: Dict[str, Callable[..., nn.Module]] = {}
_MODULE_TO_MODELS: Dict[str, Set[str]] = defaultdict(set)
_MODEL_TO_MODULE: Dict[str, str] = {}


def register_model(fn: Callable[..., nn.Module]) -> Callable[..., nn.Module]:
    """Register ``fn`` under its ``__name__`` and its module's last name; a
    name is taken once."""
    name = fn.__name__
    if name in _MODELS:
        raise ValueError(f"model {name!r} already registered")
    module = fn.__module__.rsplit(".", 1)[-1]
    _MODELS[name] = fn
    _MODULE_TO_MODELS[module].add(name)
    _MODEL_TO_MODULE[name] = module
    return fn


def _load_builders() -> None:
    from acr_wsss_tpu_torch.models import (acr, cnn, cnn_attn,  # noqa: F401  (they register)
                                           cnn_mobile, hybrid, pit, resnet_timm, swin,
                                           vit_classifier)


def is_model(name: str) -> bool:
    _load_builders()
    return name in _MODELS


def model_entrypoint(name: str) -> Callable[..., nn.Module]:
    """The builder of ``name``; an unknown name raises and names the known
    ones."""
    _load_builders()
    try:
        return _MODELS[name]
    except KeyError:
        raise ValueError(f"Unknown model {name!r}. Known: {sorted(_MODELS)}") from None


def _natural_key(s: str):
    # 'resnet101' sorts after 'resnet50'
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s.lower())]


def list_models(filter: str = "", module: str = "", pretrained: bool = False,
                exclude_filters: Union[str, Sequence[str]] = "") -> List[str]:
    """Registered names, naturally sorted: fnmatch include and exclude
    filters, one module's names, and with ``pretrained`` the names the zoo
    has a URL for."""
    _load_builders()
    names: Sequence[str] = sorted(_MODULE_TO_MODELS.get(module, ())) if module else list(_MODELS)
    if filter:
        names = fnmatch.filter(names, filter)
    if exclude_filters:
        for xf in [exclude_filters] if isinstance(exclude_filters, str) else exclude_filters:
            excluded = set(fnmatch.filter(names, xf))
            names = [n for n in names if n not in excluded]
    if pretrained:
        names = [n for n in names if is_model_pretrained(n)]
    return sorted(names, key=_natural_key)


def list_modules() -> List[str]:
    _load_builders()
    return sorted(_MODULE_TO_MODELS)


def is_model_in_modules(name: str, module_names) -> bool:
    if not isinstance(module_names, (tuple, list, set)):
        raise TypeError(f"module_names must be a tuple, list or set, got {module_names!r}")
    _load_builders()
    return _MODEL_TO_MODULE.get(name) in set(module_names)


def is_model_pretrained(name: str) -> bool:
    from acr_wsss_tpu_torch.models import zoo
    return bool(zoo.ZOO_URLS.get(name))


def get_default_cfg(name: str) -> Optional[Dict]:
    """The data configuration of a registered name (``models/cfg.py``)."""
    if not is_model(name):
        return None
    from acr_wsss_tpu_torch.models.cfg import default_cfg
    return default_cfg(name)


def has_model_default_key(name: str, cfg_key: str) -> bool:
    cfg = get_default_cfg(name)
    return cfg is not None and cfg_key in cfg


def is_model_default_key(name: str, cfg_key: str) -> bool:
    cfg = get_default_cfg(name)
    return bool(cfg and cfg.get(cfg_key, False))


def get_model_default_value(name: str, cfg_key: str):
    cfg = get_default_cfg(name)
    return None if cfg is None else cfg.get(cfg_key, None)


def split_model_name(model_name: str):
    """'hf_hub:org/name' -> ('hf_hub', 'org/name'); a bare name -> ('', name)."""
    parts = model_name.split(":", 1)
    if len(parts) == 1:
        return "", parts[0]
    source, name = parts
    if source not in ("timm", "hf_hub"):
        raise ValueError(f"unknown model source {source!r} in {model_name!r}")
    return source, name


def safe_model_name(model_name: str, remove_source: bool = True) -> str:
    if remove_source:
        model_name = split_model_name(model_name)[-1]
    return "".join(c if c.isalnum() else "_" for c in model_name).rstrip("_")


def _load_weights(model: nn.Module, name: str, checkpoint_path: str) -> None:
    """``checkpoint_path`` into ``model``, strictly: a flat flax npz, or a
    timm state dict (optionally under "model" or "state_dict")."""
    from acr_wsss_tpu_torch.models import zoo
    from acr_wsss_tpu_torch.models.convert import flax_to_state_dict
    from acr_wsss_tpu_torch.utils.checkpoint import load_params_npz

    if checkpoint_path.endswith(".npz"):
        flat = load_params_npz(checkpoint_path)
    else:
        state = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        for key in ("model", "state_dict"):
            if isinstance(state, dict) and key in state:
                state = state[key]
        flat = zoo.convert_state_dict(name, state)
    model.load_state_dict(flax_to_state_dict(flat, model.state_dict()))


def create_model(name: str, pretrained: bool = False, features_only: bool = False,
                 out_indices=None, feature_cls: str = "list", out_map=None,
                 checkpoint_path: str = "", scriptable=None, exportable=None, no_jit=None,
                 **kwargs) -> nn.Module:
    """The registered model ``name`` built with ``kwargs`` over its defaults
    (``None`` values dropped), its weights from ``checkpoint_path`` or, with
    ``pretrained``, from the zoo; with ``features_only`` wrapped in a
    ``FeatureExtractor``."""
    source, name = split_model_name(name)
    if source == "hf_hub":
        raise NotImplementedError("the hf_hub: model source is not ported; convert the "
                                  "repository's checkpoint and pass checkpoint_path")
    kwargs = {k: v for k, v in kwargs.items() if v is not None}
    model = model_entrypoint(name)(**kwargs)
    if checkpoint_path:
        _load_weights(model, name, checkpoint_path)
    elif pretrained:
        from acr_wsss_tpu_torch.models import zoo
        from acr_wsss_tpu_torch.utils.checkpoint import load_params_npz
        zoo.graft_standalone(model, load_params_npz(zoo.fetch(name)))
    if features_only:
        from acr_wsss_tpu_torch.models.features import FeatureExtractor
        model = FeatureExtractor(model, out_indices=out_indices, name=name,
                                 as_dict=feature_cls == "dict", out_map=out_map)
    return model
