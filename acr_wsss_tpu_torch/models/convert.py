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
over the layers under ``trunk/blocks_scan/block/``. The port's trunk is
unrolled, and ``flax_to_state_dict`` unrolls such a checkpoint.

The reference-checkpoint import (``models/convert.py:44-225``,
``:1049-1160``): ``torch_state_dict_to_flax`` maps an ACR ``state_dict``
of the original implementation (``DPT/ACR.py`` over timm's ViT, names
like ``pretrained.model.blocks.3.attn.qkv.weight``) to the flat flax
dict; ``flax_params_to_torch_state_dict`` is its inverse. One table,
``_REFERENCE``, holds the names both ways. The CLI writes the npz that
``infer_cam --weights`` loads (``--scan``: JAX's stacked layout)::

    python -m acr_wsss_tpu_torch.models.convert ref.pth out.npz \
        --backbone vitb_hybrid [--scan]

It reads the checkpoint with ``torch.load(weights_only=True)``: a state
dict of tensors, optionally under ``"model"``, ``module.`` prefixes
stripped (the reference's ``BaseModel.load`` and DDP formats).
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, Mapping, Optional, Sequence

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
    ``reference``; a scanned trunk is unrolled first. Raises if a key is
    left unused, is missing, or has a shape the module does not take."""
    flat = scanned_to_unrolled(flat)
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


def state_dict_to_flax(module: nn.Module, state_dict: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> Dict[str, np.ndarray]:
    """The flat ``{flax_path: np.ndarray}`` dict of ``module``'s parameters
    (or of ``state_dict``, full tensors of ``module``'s, e.g. FSDP's
    gathered), "params/"-prefixed as the JAX trainer saves them: the
    inverse of :func:`flax_to_state_dict`. Module types decide the leaf
    names (the stem's GroupNorm one level down, ``kernel`` for Dense and
    conv weights, a transposed conv's flipped back)."""
    kinds = {name: type(m) for name, m in module.named_modules()}
    flat: Dict[str, np.ndarray] = {}
    state_dict = module.state_dict() if state_dict is None else state_dict
    for key, tensor in state_dict.items():
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


# --- the reference checkpoint (``acr_wsss_tpu/models/convert.py:44-225``) ---

IGNORED = re.compile(
    r"^(scratch\.|pretrained\.model\.(bkg_token|head\.|head_dist\.|pre_logits\.))")


def _linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def _conv(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _ident(w: np.ndarray) -> np.ndarray:
    return w


# A parameter's (reference leaf: (flax leaf, reference -> flax transform))
# by the kind of its module; None: the name is the parameter itself.
_LEAVES = {"linear": {"weight": ("kernel", _linear), "bias": ("bias", _ident)},
           "conv": {"weight": ("kernel", _conv), "bias": ("bias", _ident)},
           "norm": {"weight": ("scale", _ident), "bias": ("bias", _ident)},
           None: {"": ("", _ident)}}
_INVERSE = {_linear: lambda w: np.ascontiguousarray(w.T),
            _conv: lambda w: np.ascontiguousarray(w.transpose(3, 2, 0, 1)),
            _ident: _ident}
_BACKBONE = r"pretrained\.model\.patch_embed\.backbone\."
_STAGE = r"stages\.(\d+)\.blocks\.(\d+)\."
# (reference module regex, flax module path with "{}" for its groups in
# order, kind): ``_map_name`` and ``_map_block_inner`` of the JAX package.
_REFERENCE = (
    (r"cls_head", "cls_head", "linear"),
    (r"pretrained\.model\.(cls_token|dist_token|pos_embed)", "trunk/{}", None),
    (r"pretrained\.model\.norm", "trunk/norm", "norm"),
    (r"pretrained\.model\.patch_embed\.proj", "trunk/patch_embed/proj", "conv"),
    (_BACKBONE + r"stem\.conv", "trunk/backbone/stem_conv", "conv"),
    (_BACKBONE + r"stem\.norm", "trunk/backbone/stem_norm/GroupNorm_0", "norm"),
    (_BACKBONE + _STAGE + r"(conv\d)", "trunk/backbone/stages_{}_blocks_{}/{}", "conv"),
    (_BACKBONE + _STAGE + r"downsample\.conv",
     "trunk/backbone/stages_{}_blocks_{}/downsample_conv", "conv"),
    (_BACKBONE + _STAGE + r"(norm\d)", "trunk/backbone/stages_{}_blocks_{}/{}/GroupNorm_0",
     "norm"),
    (_BACKBONE + _STAGE + r"downsample\.norm",
     "trunk/backbone/stages_{}_blocks_{}/downsample_norm/GroupNorm_0", "norm"),
    (r"pretrained\.model\.blocks\.(\d+)\.(norm\d)", "trunk/blocks_{}/{}", "norm"),
    (r"pretrained\.model\.blocks\.(\d+)\.attn\.(qkv|proj)", "trunk/blocks_{}/attn/{}", "linear"),
    (r"pretrained\.model\.blocks\.(\d+)\.mlp\.(fc\d)", "trunk/blocks_{}/mlp/{}", "linear"),
)


def _join(module: str, leaf: str, sep: str) -> str:
    return module + sep + leaf if leaf else module


def _map_name(name: str):
    """(flax path, transform) of a reference name, or None to skip it."""
    for module, path, kind in _REFERENCE:
        for ref_leaf, (leaf, transform) in _LEAVES[kind].items():
            m = re.fullmatch(_join(module, re.escape(ref_leaf), r"\."), name)
            if m:
                return _join(path.format(*m.groups()), leaf, "/"), transform
    return None


def _reference_name(path: str):
    """(reference name, flax -> reference transform) of a flax path: the
    inverse of :func:`_map_name`, read from the same table; or None."""
    for module, fmt, kind in _REFERENCE:
        groups = re.findall(r"\(([^()]*)\)", module)
        pattern = "".join(re.escape(part) + (f"({groups[i]})" if i < len(groups) else "")
                          for i, part in enumerate(fmt.split("{}")))
        ref = re.sub(r"\([^()]*\)", "{}", module).replace("\\.", ".")
        for ref_leaf, (leaf, transform) in _LEAVES[kind].items():
            m = re.fullmatch(_join(pattern, re.escape(leaf), "/"), path)
            if m:
                return _join(ref.format(*m.groups()), ref_leaf, "."), _INVERSE[transform]
    return None


def _numpy(value) -> np.ndarray:
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def torch_state_dict_to_flax(state_dict: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A reference ACR state dict (numpy arrays or tensors) as the flat
    ``{"params/...": float32 array}`` dict of ``utils/checkpoint.py``;
    names off the ACR forward (``IGNORED``, unknown ones) are dropped."""
    flat: Dict[str, np.ndarray] = {}
    for name, value in state_dict.items():
        mapped = None if IGNORED.match(name) else _map_name(name)
        if mapped is not None:
            path, transform = mapped
            flat["params/" + path] = transform(_numpy(value).astype(np.float32))
    return flat


def flax_params_to_torch_state_dict(flat: Mapping[str, np.ndarray],
                                    template: Optional[Mapping[str, object]] = None
                                    ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`torch_state_dict_to_flax`, a scanned trunk
    unrolled first. With a ``template`` (a reference state dict; only its
    names and shapes are read), its entries filled from ``flat``: names off
    the ACR forward are left out, so ``load_state_dict(..., strict=False)``
    keeps the template's values. Without one, every entry of ``flat`` that
    the reference ACR holds. The transforms are transposes, so a round
    trip is exact."""
    flat = {k[len("params/"):] if k.startswith("params/") else k: v
            for k, v in scanned_to_unrolled(flat).items()}
    if template is None:
        out = {}
        for path, value in flat.items():
            named = _reference_name(path)
            if named is not None:
                out[named[0]] = named[1](np.asarray(value, np.float32))
        return out
    out = {}
    for name, tv in template.items():
        shape = tuple(tv.shape)
        mapped = None if IGNORED.match(name) else _map_name(name)
        if mapped is None:
            continue
        path = mapped[0]
        if path not in flat:
            raise KeyError(f"flax params are missing {path} (needed for {name!r})")
        value = _INVERSE[mapped[1]](np.asarray(flat[path], np.float32))
        if tuple(value.shape) != shape:
            raise ValueError(f"shape mismatch exporting {name}: flax {value.shape} vs "
                             f"template {shape}")
        out[name] = value
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Convert a reference checkpoint to the flat flax npz."""
    from acr_wsss_tpu_torch.models.acr import ACR
    from acr_wsss_tpu_torch.utils.checkpoint import save_params_npz

    parser = argparse.ArgumentParser(description="reference ACR .pth -> flat flax .npz")
    parser.add_argument("torch_ckpt")
    parser.add_argument("out_npz")
    parser.add_argument("--backbone", default="vitb_hybrid")
    parser.add_argument("--scan", action="store_true",
                        help="write JAX's stacked layout (trunk/blocks_scan/block/...)")
    args = parser.parse_args(argv)
    state = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "model" in state:
        state = state["model"]           # the reference's BaseModel.load format
    state = {k[len("module."):] if k.startswith("module.") else k: v for k, v in state.items()}
    flat = torch_state_dict_to_flax(state)
    # Raises unless every parameter of the backbone's model is there, in its shape.
    num_classes = len(flat.get("params/cls_head/bias", range(20)))
    model = ACR(num_classes=num_classes, backbone_name=args.backbone, attn_impl="plain")
    flax_to_state_dict(flat, model.state_dict())
    if args.scan:
        flat = unrolled_to_scanned(flat)
    save_params_npz(args.out_npz, flat)
    print(f"wrote {args.out_npz}: {sum(v.size for v in flat.values()) / 1e6:.1f}M params "
          f"({args.backbone}, {'scanned' if args.scan else 'unrolled'} layout)")


if __name__ == "__main__":
    main()
