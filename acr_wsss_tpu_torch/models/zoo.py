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

``graft_standalone`` (``:943-980``) puts a zoo npz onto a Swin or PiT
model of the registry (``models/registry.py``), whose npz holds the whole
model: timm's classifier filtering, and PiT's position embedding resized
to the model's grid (``resize_bilinear_antialiased``, JAX's
``jax.image.resize(..., "bilinear")``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

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


def _triangle_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 weights of JAX's ``compute_weight_mat`` for the
    triangle kernel with antialiasing (``jax/_src/image/scale.py``): the
    kernel widened by in/out when shrinking, each column normalized, and
    columns whose sample lies outside the input zeroed."""
    inv_scale = np.float32(in_size / out_size)
    sample = (np.arange(out_size, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / max(
        inv_scale, np.float32(1.0))
    weights = np.maximum(np.float32(0.0), 1 - x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


def resize_bilinear_antialiased(x: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.image.resize(x, shape, "bilinear")`` in numpy float32: each
    axis whose size changes contracted with its triangle weights (which
    antialias when the axis shrinks)."""
    out = np.asarray(x, np.float32)
    for axis, size in enumerate(shape):
        if out.shape[axis] != size:
            w = _triangle_weights(out.shape[axis], size)
            out = np.moveaxis(np.tensordot(out, w, axes=([axis], [0])), -1, axis)
    return out


def graft_standalone(model: nn.Module, flat: Dict[str, np.ndarray], verbose: bool = True
                     ) -> nn.Module:
    """Put the flat flax npz ``flat`` onto ``model`` (a Swin or PiT of the
    registry) in place, as JAX's ``graft_standalone``: entries whose shapes
    match are copied; a 4-D ``pos_embed`` of the model's channel count is
    resized over its grid; every other entry (the ImageNet head at another
    class count, names the model lacks) is reported and its parameter
    keeps the model's init."""
    params = state_dict_to_flax(model)
    skipped = []
    for path, leaf in flat.items():
        leaf = np.asarray(leaf)
        if path not in params:
            skipped.append((path, "no target"))
        elif params[path].shape == leaf.shape:
            params[path] = leaf.astype(np.float32)
        elif (path.endswith("/pos_embed") and leaf.ndim == 4
              and params[path].shape[-1] == leaf.shape[-1]):
            params[path] = resize_bilinear_antialiased(leaf, params[path].shape)
        else:
            skipped.append((path, f"{leaf.shape} vs {params[path].shape}"))
    if verbose and skipped:
        print("zoo graft skipped:", skipped, flush=True)
    model.load_state_dict(flax_to_state_dict(params, model.state_dict()))
    return model
