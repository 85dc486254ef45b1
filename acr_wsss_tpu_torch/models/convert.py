"""Carry weights between the JAX package and the port, with numpy alone.

``flax_to_state_dict``: a flat ``{flax_path: np.ndarray}`` dict in
(exactly what ``np.load`` of a ``save_params_npz`` file gives; see
``utils/checkpoint.py``), the port's ``state_dict`` out;
``state_dict_to_flax`` is its inverse, so that weights the port trains load
in the JAX package. The port's module names follow the flax ones, so a
path maps one to one:

* ``params/`` in front is optional; "/" becomes "."; ``blocks_<i>`` of the
  trunk becomes ``blocks.<i>``;
* a Dense ``kernel`` (in, out) becomes ``weight`` (out, in);
* a conv ``kernel`` HWIO becomes ``weight`` OIHW;
* LayerNorm ``scale``/``bias`` become ``weight``/``bias``; GroupNorm's
  sit one level down in flax (``norm1/GroupNorm_0/scale``) and become
  ``norm1.weight``/``norm1.bias``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from acr_wsss_tpu_torch.models.layers import GroupNormAct, WSConv

_TRUNK_BLOCK = re.compile(r"^trunk/blocks_(\d+)/")


def _torch_key(path: str) -> str:
    if path.startswith("params/"):
        path = path[len("params/"):]
    path = _TRUNK_BLOCK.sub(r"trunk/blocks/\1/", path)
    path = path.replace("/GroupNorm_0/", "/")
    key = path.replace("/", ".")
    if key.endswith(".kernel"):
        return key[: -len("kernel")] + "weight"
    if key.endswith(".scale"):
        return key[: -len("scale")] + "weight"
    return key


def _torch_value(path: str, value: np.ndarray) -> np.ndarray:
    if path.endswith("/kernel"):
        if value.ndim == 2:                       # Dense (in, out)
            return value.T
        if value.ndim == 4:                       # conv HWIO
            return value.transpose(3, 2, 0, 1)
        raise ValueError(f"{path}: kernel of rank {value.ndim}")
    return value


def flax_to_state_dict(flat: Mapping[str, np.ndarray],
                       reference: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Convert every entry of ``flat`` for a module whose ``state_dict()`` is
    ``reference``. Raises if a key is left unused, is missing, or has a
    shape the module does not take."""
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for path, value in flat.items():
        key = _torch_key(path)
        if key not in reference:
            unused.append(path)
            continue
        val = np.ascontiguousarray(_torch_value(path, np.asarray(value)))
        if tuple(val.shape) != tuple(reference[key].shape):
            raise ValueError(f"{path} -> {key}: shape {val.shape}, the module "
                             f"takes {tuple(reference[key].shape)}")
        out[key] = torch.from_numpy(val.astype(np.float32, copy=False))
    missing = sorted(set(reference) - set(out))
    if unused or missing:
        raise ValueError(f"flax params do not match the module: unused "
                         f"{sorted(unused)[:8]} ({len(unused)}), missing "
                         f"{missing[:8]} ({len(missing)})")
    return out


def state_dict_to_flax(module: nn.Module) -> Dict[str, np.ndarray]:
    """The flat ``{flax_path: np.ndarray}`` dict of ``module``'s parameters,
    "params/"-prefixed as the JAX trainer saves them: the inverse of
    :func:`flax_to_state_dict`. Module types decide the leaf names
    (GroupNorm one level down, ``kernel`` for Dense and conv weights)."""
    kinds = {name: type(m) for name, m in module.named_modules()}
    flat: Dict[str, np.ndarray] = {}
    for key, tensor in module.state_dict().items():
        owner, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        value = tensor.detach().cpu().float().numpy()
        kind = kinds.get(owner)
        if leaf == "weight" and kind in (nn.Linear,):
            leaf, value = "kernel", value.T
        elif leaf == "weight" and kind in (nn.Conv2d, WSConv):
            leaf, value = "kernel", value.transpose(2, 3, 1, 0)
        elif leaf == "weight" and kind is nn.LayerNorm:
            leaf = "scale"
        elif kind is GroupNormAct:
            owner, leaf = owner + ".GroupNorm_0", "scale" if leaf == "weight" else leaf
        path = (owner + "." + leaf if owner else leaf).replace(".", "/")
        path = re.sub(r"^trunk/blocks/(\d+)/", r"trunk/blocks_\1/", path)
        flat["params/" + path] = np.ascontiguousarray(value)
    return flat
