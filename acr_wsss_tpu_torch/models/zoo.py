"""Pretrained weights: the zoo npz, its fetch from a local file, and the
trunk's graft: the part of ``acr_wsss_tpu/models/zoo.py`` the port's
names need.

``ZOO_URLS`` holds JAX's upstream checkpoint URL (``:36``) of every name
of the port's registry that has one. ``fetch`` (``:586``) converts a
checkpoint into the zoo npz ``<ACR_WSSS_ZOO>/<name>_in21k.npz`` through
``convert_state_dict`` (``:648``: the Swin, PiT, ViT/DeiT and BiT mappers
of ``models/convert.py``), in JAX's cache layout: the upstream file sits
beside it under its own basename. The port downloads nothing: ``fetch``
reads a ``file://`` URL, or the upstream file already in the zoo
directory, so a directory that mirrors the upstream files serves
``create_model(..., pretrained=True)``. JAX's checks of a fetched file
come along (``_validate_checkpoint_file`` ``:880``: a size floor, the
sha256 prefix of timm's file names). The ``hf_hub:`` source is not ported.

``init_with_pretrained`` (``:908-940``) puts a zoo npz's ``params/trunk/``
entries onto an ACR model; the classifier head keeps its seeded init, as
the reference's classifier-filtered ``load_pretrained`` leaves it.

``graft_standalone`` (``:943-980``) puts a zoo npz onto a model of the
registry, whose npz holds the whole model: timm's classifier filtering,
and PiT's position embedding resized to the model's grid
(``resize_bilinear_antialiased``, JAX's ``jax.image.resize(...,
"bilinear")``).
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from acr_wsss_tpu_torch.models.acr import init_random_
from acr_wsss_tpu_torch.models.convert import (bit_npz_to_torch_names, flax_to_state_dict,
                                               pit_state_dict_to_flax,
                                               resnetv2_bit_state_dict_to_flax,
                                               scanned_to_unrolled, state_dict_to_flax,
                                               swin_state_dict_to_flax,
                                               vit_timm_state_dict_to_flax)
from acr_wsss_tpu_torch.utils.checkpoint import load_params_npz, save_params_npz

TRUNK = "params/trunk/"

ZOO_URLS: Dict[str, str] = {
    "pit_b":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_b_820.pth",
    "pit_b_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_b_820.pth",
    "pit_b_distilled_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_b_distill_840.pth",
    "pit_s":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_s_809.pth",
    "pit_s_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_s_809.pth",
    "pit_s_distilled_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_s_distill_819.pth",
    "pit_ti_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_ti_730.pth",
    "pit_ti_distilled_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_ti_distill_746.pth",
    "pit_xs_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_xs_781.pth",
    "pit_xs_distilled_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_xs_distill_791.pth",
    "resnetv2_50x1_bitm":
        "https://storage.googleapis.com/bit_models/BiT-M-R50x1-ILSVRC2012.npz",
    "resnetv2_50x1_bitm_in21k":
        "https://storage.googleapis.com/bit_models/BiT-M-R50x1.npz",
    "resnetv2_50x3_bitm":
        "https://storage.googleapis.com/bit_models/BiT-M-R50x3-ILSVRC2012.npz",
    "resnetv2_50x3_bitm_in21k":
        "https://storage.googleapis.com/bit_models/BiT-M-R50x3.npz",
    "resnetv2_101x1_bitm":
        "https://storage.googleapis.com/bit_models/BiT-M-R101x1-ILSVRC2012.npz",
    "resnetv2_101x1_bitm_in21k":
        "https://storage.googleapis.com/bit_models/BiT-M-R101x1.npz",
    "resnetv2_101x3_bitm":
        "https://storage.googleapis.com/bit_models/BiT-M-R101x3-ILSVRC2012.npz",
    "resnetv2_101x3_bitm_in21k":
        "https://storage.googleapis.com/bit_models/BiT-M-R101x3.npz",
    "resnetv2_152x2_bitm":
        "https://storage.googleapis.com/bit_models/BiT-M-R152x2-ILSVRC2012.npz",
    "resnetv2_152x2_bitm_in21k":
        "https://storage.googleapis.com/bit_models/BiT-M-R152x2.npz",
    "resnetv2_152x4_bitm":
        "https://storage.googleapis.com/bit_models/BiT-M-R152x4-ILSVRC2012.npz",
    "resnetv2_152x4_bitm_in21k":
        "https://storage.googleapis.com/bit_models/BiT-M-R152x4.npz",
    "swin_base_384":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_base_patch4_window12_384_22kto1k.pth",
    "swin_base_patch4_window7_224":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_base_patch4_window7_224_22kto1k.pth",
    "swin_base_patch4_window7_224_in22k":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_base_patch4_window7_224_22k.pth",
    "swin_base_patch4_window12_384":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_base_patch4_window12_384_22kto1k.pth",
    "swin_base_patch4_window12_384_in22k":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_base_patch4_window12_384_22k.pth",
    "swin_large_384":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_large_patch4_window12_384_22kto1k.pth",
    "swin_large_patch4_window7_224":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_large_patch4_window7_224_22kto1k.pth",
    "swin_large_patch4_window7_224_in22k":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_large_patch4_window7_224_22k.pth",
    "swin_large_patch4_window12_384":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_large_patch4_window12_384_22kto1k.pth",
    "swin_large_patch4_window12_384_in22k":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_large_patch4_window12_384_22k.pth",
    "swin_small":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_small_patch4_window7_224.pth",
    "swin_small_patch4_window7_224":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_small_patch4_window7_224.pth",
    "swin_tiny":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_tiny_patch4_window7_224.pth",
    "swin_tiny_patch4_window7_224":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_tiny_patch4_window7_224.pth",
    "vit_base_patch16_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_base_p16_224-80ecf9dd.pth",
    "vit_base_patch16_224_in21k":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_base_patch16_224_in21k-e5005f0a.pth",
    "vit_base_patch16_224_miil":
        "https://miil-public-eu.oss-eu-central-1.aliyuncs.com/model-zoo/ImageNet_21K_P/models/timm/vit_base_patch16_224_1k_miil_84_4.pth",
    "vit_base_patch16_224_miil_in21k":
        "https://miil-public-eu.oss-eu-central-1.aliyuncs.com/model-zoo/ImageNet_21K_P/models/timm/vit_base_patch16_224_in21k_miil.pth",
    "vit_base_patch16_384":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_base_p16_384-83fb41ba.pth",
    "vit_base_patch32_224_in21k":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_base_patch32_224_in21k-8db57226.pth",
    "vit_base_patch32_384":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_base_p32_384-830016f5.pth",
    "vit_base_r50_s16_224_in21k":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_base_resnet50_224_in21k-6f7c7740.pth",
    "vit_base_r50_s16_384":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_base_resnet50_384-9fd3c705.pth",
    "vit_base_resnet50_224_in21k":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_base_resnet50_224_in21k-6f7c7740.pth",
    "vit_base_resnet50_384":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_base_resnet50_384-9fd3c705.pth",
    "vit_deit_base_distilled_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_base_distilled_patch16_224-df68dfff.pth",
    "vit_deit_base_distilled_patch16_384":
        "https://dl.fbaipublicfiles.com/deit/deit_base_distilled_patch16_384-d0272ac0.pth",
    "vit_deit_base_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_base_patch16_224-b5f2ef4d.pth",
    "vit_deit_base_patch16_384":
        "https://dl.fbaipublicfiles.com/deit/deit_base_patch16_384-8de9b5d1.pth",
    "vit_deit_small_distilled_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_small_distilled_patch16_224-649709d9.pth",
    "vit_deit_small_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_small_patch16_224-cd65a155.pth",
    "vit_deit_tiny_distilled_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_tiny_distilled_patch16_224-b40b3cf7.pth",
    "vit_deit_tiny_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_tiny_patch16_224-a1311bcf.pth",
    "vit_huge_patch14_224_in21k":
        "hf_hub:timm/vit_huge_patch14_224_in21k",
    "vit_large_patch16_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_large_p16_224-4ee7a4dc.pth",
    "vit_large_patch16_224_in21k":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_large_patch16_224_in21k-606da67d.pth",
    "vit_large_patch16_384":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_large_p16_384-b3be5167.pth",
    "vit_large_patch32_224_in21k":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_large_patch32_224_in21k-9046d2e7.pth",
    "vit_large_patch32_384":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_large_p32_384-9b920ba8.pth",
    "vit_small_patch16_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/vit_small_p16_224-15ec54c9.pth",
}


def zoo_dir() -> str:
    return os.environ.get("ACR_WSSS_ZOO",
                          os.path.join(os.path.expanduser("~"), ".cache", "acr_wsss_tpu", "zoo"))


def npz_path(backbone: str, directory: Optional[str] = None) -> str:
    return os.path.join(directory or zoo_dir(), f"{backbone}_in21k.npz")


def convert_state_dict(backbone: str, state: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A timm state dict of the registry name ``backbone`` as its flat flax
    dict, by the mapper of its family: Swin, PiT, ViT/DeiT, BiT."""
    if backbone.startswith("swin"):
        return swin_state_dict_to_flax(state)
    if backbone.startswith("pit"):
        return pit_state_dict_to_flax(state)
    if backbone.startswith("vit_"):
        return vit_timm_state_dict_to_flax(state)
    if backbone.startswith("resnetv2") and "_bitm" in backbone:
        return resnetv2_bit_state_dict_to_flax(state)
    raise ValueError(f"no timm checkpoint mapper for {backbone!r} in the port: it maps the "
                     "swin_*, pit_*, vit_* and resnetv2_*_bitm names (resnetv2_50 and "
                     "resnetv2_101 load from a flat flax .npz)")


def _validate_checkpoint_file(path: str) -> None:
    """Raise on a file too small to be a checkpoint (a truncated copy or an
    error page), and on one whose sha256 does not start with the 8 hex
    digits of a timm file name (``...-83fb41ba.pth``)."""
    size = os.path.getsize(path)
    if size < 1 << 20:
        raise RuntimeError(f"{path} is only {size} bytes: truncated, or an error page. "
                           "Delete it and fetch it again.")
    m = re.search(r"-([0-9a-f]{8})\.pth$", os.path.basename(path))
    if m:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if not h.hexdigest().startswith(m[1]):
            raise RuntimeError(f"{path}: sha256 {h.hexdigest()[:8]} is not the file name's "
                               f"{m[1]}: a corrupt copy. Delete it and fetch it again.")


def fetch(backbone: str, directory: Optional[str] = None, url: Optional[str] = None) -> str:
    """The zoo npz of ``backbone``, converted at first use from its
    checkpoint: ``<directory>/<basename of url>``, copied there from a
    ``file://`` URL when it is not there yet (``url`` or ``ZOO_URLS``).
    Returns the npz's path. Any other URL raises: nothing is downloaded."""
    url = url or ZOO_URLS.get(backbone)
    if not url:
        raise ValueError(f"no zoo URL for backbone {backbone!r}")
    if url.startswith("hf_hub:"):
        raise NotImplementedError(f"{backbone!r} ships by the hf_hub: source ({url}), which "
                                  "the port does not fetch")
    directory = directory or zoo_dir()
    os.makedirs(directory, exist_ok=True)
    out = npz_path(backbone, directory)
    if os.path.exists(out):
        return out
    path = os.path.join(directory, os.path.basename(url))
    if not os.path.exists(path):
        if not url.startswith("file://"):
            raise RuntimeError(f"{path} not found, and the port downloads nothing: put the "
                               f"file of {url} there, or pass url='file://<path>'")
        shutil.copyfile(url[len("file://"):], path + ".part")
        os.replace(path + ".part", path)
    _validate_checkpoint_file(path)
    if path.endswith(".npz"):           # BiT ships TF-layout npz files
        with np.load(path) as f:
            state = bit_npz_to_torch_names(dict(f))
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
        for key in ("model", "state_dict"):
            if isinstance(state, dict) and key in state:
                state = state[key]
    save_params_npz(out, convert_state_dict(backbone, state))
    return out


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
    """Put the flat flax npz ``flat`` onto ``model`` (a model of the
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
