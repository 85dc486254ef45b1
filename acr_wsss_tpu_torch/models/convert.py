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
* a ConvTranspose ``kernel`` (kh, kw, in, out), which flax applies
  unflipped, becomes ``weight`` (in, out, kh, kw) flipped in both spatial
  axes, which ``conv_transpose2d`` applies flipped; the DPT's ``up4`` and
  ``up2`` are the transposed convs, told by their flax names, since their
  kernels are square with in == out and a shape check cannot tell;
* LayerNorm and GroupNorm ``scale``/``bias`` become ``weight``/``bias``;
  the stem's GroupNorms sit one level down in flax
  (``norm1/GroupNorm_0/scale``) and become ``norm1.weight``/``norm1.bias``;
* the layers of a flax ``nn.Sequential`` (``seg_head/layers_0/``) are the
  torch ``nn.Sequential``'s indices (``seg_head.0.``).

``scanned_to_unrolled`` / ``unrolled_to_scanned`` are the numpy side of
the JAX functions of the same names (``models/convert.py:1004-1045``): a
checkpoint of the scanned trunk holds each block parameter once, stacked
over the layers under ``trunk/blocks_scan/block/``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from acr_wsss_tpu_torch.models.layers import GroupNormAct, WSConv

_TRUNK_BLOCK = re.compile(r"^trunk/blocks_(\d+)/")
_SEQUENTIAL = re.compile(r"/layers_(\d+)/")
_TRANSPOSED = re.compile(r"(^|/)up\d+/kernel$")
_UNROLLED = re.compile(r"^(.*?)trunk/blocks_(\d+)/(.*)$")
SCANNED = "trunk/blocks_scan/block/"


def scanned_to_unrolled(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``.../trunk/blocks_scan/block/<leaf>`` of leading dim L to
    ``.../trunk/blocks_<i>/<leaf>``, i < L; every other entry as it is."""
    out: Dict[str, np.ndarray] = {}
    for path, value in flat.items():
        head, scanned, leaf = path.partition(SCANNED)
        if not scanned:
            out[path] = value
            continue
        for i, layer in enumerate(np.asarray(value)):
            out[f"{head}trunk/blocks_{i}/{leaf}"] = layer
    return out


def unrolled_to_scanned(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The inverse: every ``trunk/blocks_<i>`` leaf stacked over i in order."""
    out: Dict[str, np.ndarray] = {}
    layers: Dict[tuple, Dict[int, np.ndarray]] = {}
    for path, value in flat.items():
        m = _UNROLLED.match(path)
        if m is None:
            out[path] = value
        else:
            layers.setdefault((m[1], m[3]), {})[int(m[2])] = np.asarray(value)
    for (head, leaf), by_layer in layers.items():
        out[f"{head}{SCANNED}{leaf}"] = np.stack([by_layer[i] for i in sorted(by_layer)])
    return out


def _torch_key(path: str) -> str:
    if path.startswith("params/"):
        path = path[len("params/"):]
    path = _TRUNK_BLOCK.sub(r"trunk/blocks/\1/", path)
    path = path.replace("/GroupNorm_0/", "/")
    path = _SEQUENTIAL.sub(r"/\1/", path)
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
        if value.ndim == 4 and _TRANSPOSED.search(path):
            return value[::-1, ::-1].transpose(2, 3, 0, 1)
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
    (the stem's GroupNorm one level down, ``kernel`` for Dense and conv
    weights, a transposed conv's flipped back)."""
    kinds = {name: type(m) for name, m in module.named_modules()}
    flat: Dict[str, np.ndarray] = {}
    for key, tensor in module.state_dict().items():
        owner, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        value = tensor.detach().cpu().float().numpy()
        kind = kinds.get(owner)
        if leaf == "weight" and kind in (nn.Linear,):
            leaf, value = "kernel", value.T
        elif leaf == "weight" and kind is nn.ConvTranspose2d:
            leaf, value = "kernel", value.transpose(2, 3, 0, 1)[::-1, ::-1]
        elif leaf == "weight" and kind is not None and issubclass(kind, (nn.Conv2d, WSConv)):
            leaf, value = "kernel", value.transpose(2, 3, 1, 0)
        elif leaf == "weight" and kind in (nn.LayerNorm, nn.GroupNorm):
            leaf = "scale"
        elif kind is GroupNormAct:
            owner, leaf = owner + ".GroupNorm_0", "scale" if leaf == "weight" else leaf
        path = (owner + "." + leaf if owner else leaf).replace(".", "/")
        path = re.sub(r"^trunk/blocks/(\d+)/", r"trunk/blocks_\1/", path)
        path = re.sub(r"/(\d+)/", r"/layers_\1/", path)
        flat["params/" + path] = np.ascontiguousarray(value)
    return flat
