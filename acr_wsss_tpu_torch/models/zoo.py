"""ImageNet-pretrained trunk weights from the zoo npz: the slice of
``acr_wsss_tpu/models/zoo.py`` that ``--pretrained`` needs (``zoo_dir``,
``npz_path``, ``load_backbone_params``, ``init_with_pretrained``;
``:478-486``, ``:908-940``).

The zoo file ``<ACR_WSSS_ZOO>/<backbone>_in21k.npz`` is a flat flax npz
whose ``params/trunk/...`` entries hold the backbone. The trunk comes from
it through ``models/convert.py``; the classifier head keeps its seeded
init, as the reference's classifier-filtered ``load_pretrained`` leaves
it. The port has no ``fetch``: the JAX package's
``python -m acr_wsss_tpu.models.zoo fetch <backbone>`` writes the file.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch.nn as nn

from acr_wsss_tpu_torch.models.acr import init_random_
from acr_wsss_tpu_torch.models.convert import (flax_to_state_dict, scanned_to_unrolled,
                                               state_dict_to_flax)
from acr_wsss_tpu_torch.utils.checkpoint import load_params_npz

TRUNK = "params/trunk/"


def zoo_dir() -> str:
    return os.environ.get("ACR_WSSS_ZOO",
                          os.path.join(os.path.expanduser("~"), ".cache", "acr_wsss_tpu", "zoo"))


def npz_path(backbone: str, directory: Optional[str] = None) -> str:
    return os.path.join(directory or zoo_dir(), f"{backbone}_in21k.npz")


def load_backbone_params(backbone: str, directory: Optional[str] = None) -> Dict[str, np.ndarray]:
    """The zoo npz as a flat ``{flax_path: array}`` dict."""
    path = npz_path(backbone, directory)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} not found; write it with the JAX package's "
                                f"`python -m acr_wsss_tpu.models.zoo fetch {backbone}`")
    return load_params_npz(path)


def init_with_pretrained(model: nn.Module, seed: int, directory: Optional[str] = None
                         ) -> nn.Module:
    """``init_random_(model, seed)``, then every trunk parameter from the
    zoo npz of ``model.backbone_name``; the head stays as the seed made it.
    Raises if the npz's trunk and the model's differ in a name or shape."""
    init_random_(model, seed)
    pretrained = scanned_to_unrolled(load_backbone_params(model.backbone_name, directory))
    flat = state_dict_to_flax(model)
    want = {k for k in flat if k.startswith(TRUNK)}
    have = {k for k in pretrained if k.startswith(TRUNK)}
    if want != have:
        raise ValueError(f"zoo npz trunk does not match the model: missing "
                         f"{sorted(want - have)[:8]}, unused {sorted(have - want)[:8]}")
    flat.update({k: pretrained[k] for k in want})
    model.load_state_dict(flax_to_state_dict(flat, model.state_dict()))
    return model
