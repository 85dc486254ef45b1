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
  torch ``nn.Sequential``'s indices (``seg_head.0.``);
* a 1-D conv ``kernel`` (width, in, out) becomes ``weight`` (out, in,
  width) (the ECA module);
* BatchNorm (``models/layers.BatchNorm``): ``params/.../scale`` and
  ``bias`` become ``weight`` and ``bias``, the running statistics
  ``batch_stats/.../mean`` and ``var`` the buffers ``mean`` and ``var``.

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

The timm classifiers (``:84``, ``:1563-1615``): ``vit_timm_state_dict_to_flax``
maps a ViT or DeiT checkpoint (the trunk's names of ``_REFERENCE`` without
the ``pretrained.model.`` prefix, ``head``, ``head_dist``,
``pre_logits.fc``) to the flat dict of ``models/vit_classifier.py``;
``resnetv2_bit_state_dict_to_flax`` a BiT one (its 1x1 conv head as a
Dense) to ``models/hybrid.BiTResNetV2``'s; ``bit_npz_to_torch_names``
renames BiT's TF ``.npz`` releases to timm's names first (``:3086``).
``zoo.convert_state_dict`` picks the mapper of a registry name's family.

The CNN families (``:353-418``, ``:600-716``, ``:3214-3306``):
``resnet_state_dict_to_flax`` (torchvision's ResNet layout, to
``models/cnn.ResNet``), ``densenet_state_dict_to_flax`` (its legacy
``norm.1`` names renamed, the deep stem told by ``features.conv2``),
``vgg_state_dict_to_flax`` (convs by rank among the ``features.<i>``
layers, the ``_bn`` names' BatchNorms after them; the 7x7-flatten
classifier has no counterpart and is left out) and
``timm_resnet_state_dict_to_flax`` (``models/resnet_timm.TimmResNet``: the
deep stem ``conv1.{0,3,6}``, the ResNet-RS ``maxpool.{0,1}``, a conv or
average-pool downsample told by its 4-D weight, SE and ECA). The mobile
and attention families (``:420-598``, ``:721-836``, ``:1426-1501``,
``:2400-2507``, ``:2660-2725``): ``efficientnet_state_dict_to_flax`` and
``mobilenetv3_state_dict_to_flax`` (timm's depthwise-separable stage 0
and inverted residuals; MobileNetV3's stages flattened, its post-pool
``conv_head`` a Dense), ``regnet_state_dict_to_flax``,
``attn_resnet_state_dict_to_flax`` (SEResNet, Res2Net, ResNeSt),
``sknet_state_dict_to_flax`` and ``legacy_senet_state_dict_to_flax``, to
``models/cnn_mobile`` and ``models/cnn_attn``. BatchNorm's running mean
and variance land in ``batch_stats/``, its scale and bias in ``params/``;
``num_batches_tracked`` is dropped.

The timm Swin and PiT checkpoints (``:228-350``):
``swin_state_dict_to_flax`` and ``pit_state_dict_to_flax`` map them, by
the tables ``_SWIN`` and ``_PIT``, to the flat dict of ``models/swin.py``
and ``models/pit.py`` (Swin's recomputed buffers skipped, PiT's NCHW
``pos_embed`` to NHWC, torch's ``transformers.<s>.pool`` to ``pool<s+1>``,
``head`` and ``head_dist`` kept). With ``--backbone`` a name of the
registry (Swin, PiT, the ViT/DeiT classifiers, the BiT names, the CNN
families) the CLI
writes that npz, checked against the registry's model, which
``--pretrained``, ``create_model(..., pretrained=True)`` and
``zoo.graft_standalone`` read (as ``<ACR_WSSS_ZOO>/<name>_in21k.npz``).
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from acr_wsss_tpu_torch.models.layers import BatchNorm, GroupNormAct, WSConv

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
    for collection in ("params/", "batch_stats/"):
        if path.startswith(collection):
            path = path[len(collection):]
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
        if value.ndim == 3:                       # 1-D conv (W, I, O)
            return value.transpose(2, 1, 0)
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
    conv weights, a transposed conv's flipped back, BatchNorm's statistics
    under ``batch_stats/``)."""
    kinds = {name: type(m) for name, m in module.named_modules()}
    flat: Dict[str, np.ndarray] = {}
    state_dict = module.state_dict() if state_dict is None else state_dict
    for key, tensor in state_dict.items():
        owner, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        value = tensor.detach().cpu().float().numpy()
        kind = kinds.get(owner)
        collection = "params/"
        if leaf == "weight" and kind in (nn.Linear,):
            leaf, value = "kernel", value.T
        elif leaf == "weight" and kind is nn.ConvTranspose2d:
            leaf, value = "kernel", value.transpose(2, 3, 0, 1)[::-1, ::-1]
        elif leaf == "weight" and kind is not None and issubclass(kind, (nn.Conv2d, WSConv)):
            leaf, value = "kernel", value.transpose(2, 3, 1, 0)
        elif leaf == "weight" and kind is nn.Conv1d:
            leaf, value = "kernel", value.transpose(2, 1, 0)
        elif leaf == "weight" and kind in (nn.LayerNorm, nn.GroupNorm, BatchNorm):
            leaf = "scale"
        elif kind is BatchNorm and leaf in ("mean", "var"):
            collection = "batch_stats/"
        elif kind is GroupNormAct:
            owner, leaf = owner + ".GroupNorm_0", "scale" if leaf == "weight" else leaf
        path = (owner + "." + leaf if owner else leaf).replace(".", "/")
        path = re.sub(r"^trunk/blocks/(\d+)/", r"trunk/blocks_\1/", path)
        path = re.sub(r"/(\d+)/", r"/layers_\1/", path)
        flat[collection + path] = np.ascontiguousarray(value)
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


def _nhwc(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(0, 2, 3, 1))


def _conv1x1_to_dense(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w[:, :, 0, 0].T)


def _conv1d(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 1, 0))


# A parameter's (reference leaf: (flax leaf, reference -> flax transform))
# by the kind of its module; None: the name is the parameter itself.
_LEAVES = {"linear": {"weight": ("kernel", _linear), "bias": ("bias", _ident)},
           "conv": {"weight": ("kernel", _conv), "bias": ("bias", _ident)},
           "norm": {"weight": ("scale", _ident), "bias": ("bias", _ident)},
           "conv1x1": {"weight": ("kernel", _conv1x1_to_dense), "bias": ("bias", _ident)},
           "conv1d": {"weight": ("kernel", _conv1d)},
           "bn": {"weight": ("scale", _ident), "bias": ("bias", _ident),
                  "running_mean": ("mean", _ident), "running_var": ("var", _ident)},
           "nchw": {"": ("", _nhwc)},
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


# timm's Swin and PiT (``_map_swin_name`` :253, ``_map_pit_name`` :317,
# ``_map_block_inner`` :207); a path may be a function of the groups.
_BLOCK_INNER = ((r"(norm\d)", "{}", "norm"), (r"attn\.(qkv|proj)", "attn/{}", "linear"),
                (r"mlp\.(fc\d)", "mlp/{}", "linear"))
_SWIN_BLOCK = r"layers\.(\d+)\.blocks\.(\d+)\."
_PIT_BLOCK = r"transformers\.(\d+)\.blocks\.(\d+)\."
_SWIN = (
    (r"patch_embed\.proj", "patch_embed", "conv"),
    (r"patch_embed\.norm", "embed_norm", "norm"),
    (_SWIN_BLOCK + r"attn\.relative_position_bias_table",
     "stage{}_block{}/attn/relative_position_bias_table", None),
    *((_SWIN_BLOCK + m, "stage{}_block{}/" + p, k) for m, p, k in _BLOCK_INNER),
    (r"layers\.(\d+)\.downsample\.norm", "merge{}/norm", "norm"),
    (r"layers\.(\d+)\.downsample\.reduction", "merge{}/reduction", "linear"),
    (r"norm", "norm", "norm"),
    (r"head", "head", "linear"),
)
_PIT = (
    (r"pos_embed", "pos_embed", "nchw"),
    (r"cls_token", "cls_token", None),
    (r"patch_embed\.conv", "patch_embed", "conv"),
    *((_PIT_BLOCK + m, "stage{}_block{}/" + p, k) for m, p, k in _BLOCK_INNER),
    # torch runs stage s's pool after its blocks, flax's pool<s+1> before
    # stage s + 1
    (r"transformers\.(\d+)\.pool\.conv", lambda s: f"pool{int(s) + 1}/conv", "conv"),
    (r"transformers\.(\d+)\.pool\.fc", lambda s: f"pool{int(s) + 1}/fc", "linear"),
    (r"norm", "norm", "norm"),
    (r"head", "head", "linear"),
    (r"head_dist", "head_dist", "linear"),
)


# timm's ViT and DeiT classifiers (``vit_timm_state_dict_to_flax`` :84): the
# trunk's names of the reference table without its ``pretrained.model.``
# prefix, and the heads of ``models/vit_classifier.py``.
_VIT_TIMM = (
    (r"(head|head_dist)", "{}", "linear"),
    (r"pre_logits\.fc", "pre_logits", "linear"),
    *((m[len(r"pretrained\.model\."):], p, k) for m, p, k in _REFERENCE
      if m.startswith(r"pretrained\.model\.")),
)
# timm's pre-activation ResNetV2, BiT (``_map_resnetv2_bit_name`` :1586):
# the blocks ``s<s>_b<b>`` of ``models/hybrid.BiTResNetV2``, the 1x1 conv
# head as a Dense.
_BIT = (
    (r"stem\.conv", "stem_conv", "conv"),
    (r"norm", "norm/GroupNorm_0", "norm"),
    (r"head\.fc", "head", "conv1x1"),
    (_STAGE + r"(conv\d)", "s{}_b{}/{}", "conv"),
    (_STAGE + r"(norm\d)", "s{}_b{}/{}/GroupNorm_0", "norm"),
    (_STAGE + r"downsample\.conv", "s{}_b{}/downsample_conv", "conv"),
)


def _join(module: str, leaf: str, sep: str) -> str:
    return module + sep + leaf if leaf else module


def _map_name(name: str, table=_REFERENCE):
    """(flax path, transform) of a name of ``table``'s checkpoints, or None
    to skip it."""
    for module, path, kind in table:
        for ref_leaf, (leaf, transform) in _LEAVES[kind].items():
            m = re.fullmatch(_join(module, re.escape(ref_leaf), r"\."), name)
            if m:
                target = path(*m.groups()) if callable(path) else path.format(*m.groups())
                return _join(target, leaf, "/"), transform
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


# BatchNorm's running statistics: flax's ``batch_stats`` collection.
_STATS = ("mean", "var")


def _table_to_flax(state_dict: Mapping[str, object], table, ignored=None
                   ) -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for name, value in state_dict.items():
        skip = ignored is not None and ignored.search(name)
        mapped = None if skip else _map_name(name, table)
        if mapped is not None:
            path, transform = mapped
            collection = "batch_stats/" if path.rsplit("/", 1)[-1] in _STATS else "params/"
            flat[collection + path] = transform(_numpy(value).astype(np.float32))
    return flat


def torch_state_dict_to_flax(state_dict: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A reference ACR state dict (numpy arrays or tensors) as the flat
    ``{"params/...": float32 array}`` dict of ``utils/checkpoint.py``;
    names off the ACR forward (``IGNORED``, unknown ones) are dropped."""
    return _table_to_flax(state_dict, _REFERENCE, IGNORED)


_SWIN_BUFFERS = re.compile(r"(relative_position_index|attn_mask)$")


def swin_state_dict_to_flax(state_dict: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A timm Swin state dict as the flat dict of ``models/swin.py``; the
    buffers the model recomputes and unknown names are dropped."""
    return _table_to_flax(state_dict, _SWIN, _SWIN_BUFFERS)


def pit_state_dict_to_flax(state_dict: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A timm PiT state dict as the flat dict of ``models/pit.py``."""
    return _table_to_flax(state_dict, _PIT)


def vit_timm_state_dict_to_flax(state_dict: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A timm ViT or DeiT classifier's state dict (bare ``cls_token``,
    ``blocks.<i>``, the hybrid's ``patch_embed.backbone``, ``head``, and
    ``head_dist`` and ``pre_logits.fc`` where the release has them) as the
    flat dict of ``models/vit_classifier.py``; unknown names are dropped."""
    return _table_to_flax(state_dict, _VIT_TIMM)


def resnetv2_bit_state_dict_to_flax(state_dict: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A timm BiT (pre-activation ResNetV2) state dict as the flat dict of
    ``models/hybrid.BiTResNetV2``; unknown names are dropped."""
    return _table_to_flax(state_dict, _BIT)


# torchvision's ResNet v1 (``_map_resnet_name`` :385), onto ``models/cnn.ResNet``.
_LAYER = r"layer(\d+)\.(\d+)\."
_RESNET = (
    (r"conv1", "stem/conv", "conv"),
    (r"bn1", "stem/bn", "bn"),
    (_LAYER + r"conv(\d)", "layer{}_{}/conv{}/conv", "conv"),
    (_LAYER + r"bn(\d)", "layer{}_{}/conv{}/bn", "bn"),
    (_LAYER + r"downsample\.0", "layer{}_{}/downsample/conv", "conv"),
    (_LAYER + r"downsample\.1", "layer{}_{}/downsample/bn", "bn"),
    (r"fc", "fc", "linear"),
)


def resnet_state_dict_to_flax(state_dict: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A torchvision/timm ResNet v1 state dict as the flat dict of
    ``models/cnn.ResNet``, ``fc`` included."""
    return _table_to_flax(state_dict, _RESNET)


def _minus1(fmt: str):
    """A path of 1-based torch indices as flax's 0-based ones."""
    return lambda *groups: fmt.format(*(int(g) - 1 if g.isdigit() else g for g in groups))


# torchvision's DenseNet (``_map_densenet_name`` :624): denseblock and
# denselayer and transition indices are 1-based there, 0-based here.
_DENSE_BLOCKS = (
    (r"features\.denseblock(\d+)\.denselayer(\d+)\.(norm\d)", _minus1("block{}_layer{}/{}"),
     "bn"),
    (r"features\.denseblock(\d+)\.denselayer(\d+)\.(conv\d)", _minus1("block{}_layer{}/{}"),
     "conv"),
    (r"features\.transition(\d+)\.norm", _minus1("transition{}_norm"), "bn"),
    (r"features\.transition(\d+)\.conv", _minus1("transition{}_conv"), "conv"),
    (r"features\.norm5", "norm5", "bn"),
    (r"classifier", "classifier", "linear"),
)
_DENSENET = ((r"features\.conv0", "stem/conv", "conv"),
             (r"features\.norm0", "stem/bn", "bn")) + _DENSE_BLOCKS
_DENSENET_DEEP = ((r"features\.conv(\d)", "stem{}/conv", "conv"),
                  (r"features\.norm([012])", "stem{}/bn", "bn")) + _DENSE_BLOCKS


def densenet_state_dict_to_flax(state_dict: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A torchvision/timm DenseNet state dict as the flat dict of
    ``models/cnn.DenseNet``: the legacy ``denselayer<i>.norm.1`` names as
    ``norm1`` (torchvision's own fix-up on load); the deep stem where
    ``features.conv2`` is present."""
    state = {re.sub(r"(denselayer\d+\.(?:norm|conv))\.(\d)", r"\1\2", k): v
             for k, v in state_dict.items()}
    return _table_to_flax(state, _DENSENET_DEEP if "features.conv2.weight" in state
                          else _DENSENET)


def vgg_state_dict_to_flax(state_dict: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """The convolutions of a torchvision/timm VGG state dict as the flat dict
    of ``models/cnn.VGG``: the 4-D ``features.<i>.weight`` are ``conv<r>``
    by rank r, and a ``_bn`` name's BatchNorm after conv r is ``bn<r>``.
    The classifier is left out (the port pools globally, so timm's 7x7
    flatten has no counterpart): the model keeps its own head."""
    arrays = {k: _numpy(v).astype(np.float32) for k, v in state_dict.items()}
    conv_ids = sorted(int(m[1]) for k, v in arrays.items()
                      if (m := re.fullmatch(r"features\.(\d+)\.weight", k)) and v.ndim == 4)
    rank = {fid: i for i, fid in enumerate(conv_ids)}
    flat: Dict[str, np.ndarray] = {}
    for name, v in arrays.items():
        m = re.fullmatch(r"features\.(\d+)\.(weight|bias|running_mean|running_var)", name)
        if not m:
            continue
        idx, leaf = int(m[1]), m[2]
        if idx in rank and (leaf == "bias" or (leaf == "weight" and v.ndim == 4)):
            flat[f"params/conv{rank[idx]}/{'kernel' if leaf == 'weight' else 'bias'}"] = (
                _conv(v) if leaf == "weight" else v)
        else:
            flax_leaf, _ = _LEAVES["bn"][leaf]
            collection = "batch_stats" if flax_leaf in _STATS else "params"
            before = rank[max(c for c in conv_ids if c < idx)]
            flat[f"{collection}/bn{before}/{flax_leaf}"] = v
    return flat


# timm's ResNet constructor (``timm_resnet_state_dict_to_flax`` :3214), onto
# ``models/resnet_timm.TimmResNet``; ``downsample.conv`` and
# ``downsample.bn`` stand for the downsample's indices (below).
_TIMM_RESNET = (
    (r"fc", "fc", "linear"),
    (r"conv1", "conv1", "conv"),
    (r"conv1\.([036])", lambda i: f"conv1_{'036'.index(i)}", "conv"),
    (r"conv1\.([14])", lambda i: f"bn1_{'14'.index(i)}", "bn"),
    (r"bn1", "bn1", "bn"),
    (r"maxpool\.0", "stempool_conv", "conv"),
    (r"maxpool\.1", "stempool_bn", "bn"),
    (_LAYER + r"conv(\d)", "layer{}_{}/conv{}", "conv"),
    (_LAYER + r"bn(\d)", "layer{}_{}/bn{}", "bn"),
    (_LAYER + r"se\.(fc\d)", "layer{}_{}/se/{}", "conv"),
    (_LAYER + r"se\.conv", "layer{}_{}/se/conv", "conv1d"),
    (_LAYER + r"downsample\.conv", "layer{}_{}/downsample/downsample_conv", "conv"),
    (_LAYER + r"downsample\.bn", "layer{}_{}/downsample/downsample_bn", "bn"),
)


def _downsample_by_rank(state_dict: Mapping[str, object]) -> Dict[str, object]:
    """``state_dict`` with each block's ``downsample.<i>`` renamed to
    ``downsample.conv`` where the index's weight is 4-D and to
    ``downsample.bn`` otherwise: a conv and a BatchNorm (``.0``, ``.1``),
    or an average pool, a conv and a BatchNorm (``.1``, ``.2``)."""
    conv_at = {m[1]: m[2] for k, v in state_dict.items()
               if (m := re.fullmatch(r"(layer\d+\.\d+\.downsample)\.(\d)\.weight", k))
               and _numpy(v).ndim == 4}
    state = {}
    for name, value in state_dict.items():
        m = re.fullmatch(r"(layer\d+\.\d+\.downsample)\.(\d)\.(.+)", name)
        if m:
            name = f"{m[1]}.{'conv' if conv_at.get(m[1]) == m[2] else 'bn'}.{m[3]}"
        state[name] = value
    return state


def timm_resnet_state_dict_to_flax(state_dict: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """Any timm ResNet-family state dict (``resnet.py`` and
    ``gluon_resnet.py`` layouts) as the flat dict of
    ``models/resnet_timm.TimmResNet``; a block's downsample told by rank
    (``_downsample_by_rank``)."""
    return _table_to_flax(_downsample_by_rank(state_dict), _TIMM_RESNET)


# timm's EfficientNet b0-b4 and MobileNetV3-Large (``_map_efficientnet_name``
# :446, ``_map_mbv3_name`` :544), onto ``models/cnn_mobile``: a block of
# stage 0 is depthwise-separable (``conv_dw``/``bn1`` the depthwise conv,
# ``conv_pw``/``bn2`` the project), the others inverted residuals
# (``conv_pw``/``bn1`` expand, ``conv_dw``/``bn2``, ``conv_pwl``/``bn3``
# project). ``block`` names a timm block (stage, index) by its flax path.
def _mbconv_table(block, stages: str):
    b = r"blocks\.({})\.(\d+)\.".format(stages)
    b0 = r"blocks\.(0)\.(\d+)\."
    return (
        (b0 + r"conv_dw", lambda s, j: block(s, j) + "/dw/conv", "conv"),
        (b0 + r"conv_pw", lambda s, j: block(s, j) + "/project/conv", "conv"),
        (b0 + r"bn1", lambda s, j: block(s, j) + "/dw/bn", "bn"),
        (b0 + r"bn2", lambda s, j: block(s, j) + "/project/bn", "bn"),
        (b + r"conv_pw", lambda s, j: block(s, j) + "/expand/conv", "conv"),
        (b + r"conv_dw", lambda s, j: block(s, j) + "/dw/conv", "conv"),
        (b + r"conv_pwl", lambda s, j: block(s, j) + "/project/conv", "conv"),
        (b + r"bn1", lambda s, j: block(s, j) + "/expand/bn", "bn"),
        (b + r"bn2", lambda s, j: block(s, j) + "/dw/bn", "bn"),
        (b + r"bn3", lambda s, j: block(s, j) + "/project/bn", "bn"),
        (b + r"se\.conv_(reduce|expand)", lambda s, j, r: block(s, j) + f"/se/{r}", "conv"),
        (r"conv_stem", "stem/conv", "conv"),
        (r"bn1", "stem/bn", "bn"),
        (r"classifier", "classifier", "linear"),
    )


_EFFICIENTNET = _mbconv_table(lambda s, j: f"stage{s}_block{j}", r"\d+") + (
    (r"conv_head", "head_conv/conv", "conv"),
    (r"bn2", "head_conv/bn", "bn"),
)
# timm's stages (1, 2, 3, 4, 2, 3) -> the flat ``block<i>`` of MobileNetV3;
# stage 6 (a ConvBnAct) is ``head_conv``, the post-pool ``conv_head`` (a
# biased 1x1 conv) the ``pre`` Dense.
_MBV3_STAGE_OFFSETS = (0, 1, 3, 6, 10, 12)
_MBV3 = _mbconv_table(lambda s, j: f"block{_MBV3_STAGE_OFFSETS[int(s)] + int(j)}", r"[0-5]") + (
    (r"blocks\.6\.\d+\.conv", "head_conv/conv", "conv"),
    (r"blocks\.6\.\d+\.bn1", "head_conv/bn", "bn"),
    (r"conv_head", "pre", "conv1x1"),
)


def efficientnet_state_dict_to_flax(state_dict: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A timm EfficientNet (b0-b4, not the ``tf_`` ports) state dict as the
    flat dict of ``models/cnn_mobile.EfficientNet``."""
    return _table_to_flax(state_dict, _EFFICIENTNET)


def mobilenetv3_state_dict_to_flax(state_dict: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A timm mobilenetv3_large_100 state dict as the flat dict of
    ``models/cnn_mobile.MobileNetV3``."""
    return _table_to_flax(state_dict, _MBV3)


# timm's RegNet (``_map_regnet_name`` :1453): ``s<i>.b<j>`` (1-based) ->
# ``stage<i-1>_block<j-1>``; the bare grouped ``conv2`` and its BatchNorm.
def _regnet_block(fmt: str):
    return lambda s, b, *rest: f"stage{int(s) - 1}_block{int(b) - 1}/" + fmt.format(*rest)


_RB = r"s(\d+)\.b(\d+)\."
_REGNET = (
    (r"stem\.conv", "stem/conv", "conv"),
    (r"stem\.bn", "stem/bn", "bn"),
    (r"head\.fc", "head", "linear"),
    (_RB + r"conv([13])\.conv", _regnet_block("conv{}/conv"), "conv"),
    (_RB + r"conv([13])\.bn", _regnet_block("conv{}/bn"), "bn"),
    (_RB + r"conv2\.conv", _regnet_block("conv2"), "conv"),
    (_RB + r"conv2\.bn", _regnet_block("bn2"), "bn"),
    (_RB + r"se\.fc1", _regnet_block("se/reduce"), "conv"),
    (_RB + r"se\.fc2", _regnet_block("se/expand"), "conv"),
    (_RB + r"downsample\.conv", _regnet_block("downsample/conv"), "conv"),
    (_RB + r"downsample\.bn", _regnet_block("downsample/bn"), "bn"),
)


def regnet_state_dict_to_flax(state_dict: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A timm RegNet X/Y state dict as the flat dict of
    ``models/cnn_mobile.RegNet``."""
    return _table_to_flax(state_dict, _REGNET)


# timm's SEResNet, Res2Net and ResNeSt (``_map_attn_resnet_name`` :752), onto
# ``models/cnn_attn.AttnResNet``: the ResNet layout, Res2Net's cascade
# ``convs.<i>``/``bns.<i>``, SE's ``se.fc1``/``fc2``, the split attention's
# ``conv2.{conv,bn0,fc1,bn1,fc2}``; the deep stem where ``conv1.0`` is there.
_ATTN_BLOCKS = (
    (_LAYER + r"conv(\d)", "layer{}_{}/conv{}/conv", "conv"),
    (_LAYER + r"bn(\d)", "layer{}_{}/conv{}/bn", "bn"),
    (_LAYER + r"convs\.(\d+)", "layer{}_{}/convs_{}/conv", "conv"),
    (_LAYER + r"bns\.(\d+)", "layer{}_{}/convs_{}/bn", "bn"),
    (_LAYER + r"se\.fc1", "layer{}_{}/se/reduce", "conv"),
    (_LAYER + r"se\.fc2", "layer{}_{}/se/expand", "conv"),
    (_LAYER + r"conv2\.conv", "layer{}_{}/splat/conv", "conv"),
    (_LAYER + r"conv2\.(bn[01])", "layer{}_{}/splat/{}", "bn"),
    (_LAYER + r"conv2\.(fc[12])", "layer{}_{}/splat/{}", "conv"),
    (_LAYER + r"downsample\.conv", "layer{}_{}/downsample/conv", "conv"),
    (_LAYER + r"downsample\.bn", "layer{}_{}/downsample/bn", "bn"),
    (r"fc", "fc", "linear"),
)
_DEEP_STEM = (
    (r"conv1\.([036])", lambda i: f"stem{'036'.index(i)}/conv", "conv"),
    (r"conv1\.([14])", lambda i: f"stem{'14'.index(i)}/bn", "bn"),
    (r"bn1", "stem2/bn", "bn"),
)
_STEM = ((r"conv1", "stem/conv", "conv"), (r"bn1", "stem/bn", "bn"))


def attn_resnet_state_dict_to_flax(state_dict: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A timm SEResNet, Res2Net or ResNeSt state dict as the flat dict of
    ``models/cnn_attn.AttnResNet``; a downsample told by rank."""
    stem = _DEEP_STEM if "conv1.0.weight" in state_dict else _STEM
    return _table_to_flax(_downsample_by_rank(state_dict), stem + _ATTN_BLOCKS)


# timm's SK-ResNets (``_map_sknet_name`` :2426), onto ``models/cnn_attn.SKResNet``:
# the SK conv at ``conv1`` (basic blocks) or ``conv2`` (bottlenecks), its
# ``paths.<i>.{conv,bn}`` and ``attn.{fc_reduce,bn,fc_select}``; the plain
# ConvBnActs ``conv<i>.{conv,bn}``.
_SKNET_BLOCKS = (
    (_LAYER + r"conv[12]\.paths\.(\d)\.conv", "layer{}_{}/path{}_conv", "conv"),
    (_LAYER + r"conv[12]\.paths\.(\d)\.bn", "layer{}_{}/path{}_bn", "bn"),
    (_LAYER + r"conv[12]\.attn\.fc_(reduce|select)", "layer{}_{}/attn_{}", "conv"),
    (_LAYER + r"conv[12]\.attn\.bn", "layer{}_{}/attn_bn", "bn"),
    (_LAYER + r"(conv[123])\.conv", "layer{}_{}/{}/conv", "conv"),
    (_LAYER + r"(conv[123])\.bn", "layer{}_{}/{}/bn", "bn"),
    (_LAYER + r"downsample\.conv", "layer{}_{}/downsample/conv", "conv"),
    (_LAYER + r"downsample\.bn", "layer{}_{}/downsample/bn", "bn"),
    (r"fc", "fc", "linear"),
)


def sknet_state_dict_to_flax(state_dict: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A timm SK-ResNet state dict (skresnet18/34/50/50d, skresnext50) as
    the flat dict of ``models/cnn_attn.SKResNet``; the deep stem where
    ``conv1.6`` is there, a downsample told by rank."""
    stem = _DEEP_STEM if "conv1.6.weight" in state_dict else _STEM
    return _table_to_flax(_downsample_by_rank(state_dict), stem + _SKNET_BLOCKS)


# timm's legacy SENets (``_map_legacy_senet_name`` :2681), onto
# ``models/cnn_attn.LegacySENet``: the ``layer0`` stem, biased SE convs,
# the Sequential downsample.
_LEGACY_SENET = (
    (r"last_linear", "last_linear", "linear"),
    (r"layer0\.(conv\d)", "layer0_{}", "conv"),
    (r"layer0\.(bn\d)", "layer0_{}", "bn"),
    (_LAYER + r"(conv\d)", "layer{}_{}/{}", "conv"),
    (_LAYER + r"(bn\d)", "layer{}_{}/{}", "bn"),
    (_LAYER + r"se_module\.(fc[12])", "layer{}_{}/se_module/{}", "conv"),
    (_LAYER + r"downsample\.0", "layer{}_{}/downsample_conv", "conv"),
    (_LAYER + r"downsample\.1", "layer{}_{}/downsample_bn", "bn"),
)


def legacy_senet_state_dict_to_flax(state_dict: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A timm legacy SENet state dict (``legacy_se*``, senet154) as the flat
    dict of ``models/cnn_attn.LegacySENet``."""
    return _table_to_flax(state_dict, _LEGACY_SENET)


def bit_npz_to_torch_names(weights: Mapping[str, np.ndarray], prefix: str = "resnet/"
                           ) -> Dict[str, np.ndarray]:
    """An official BiT ``.npz`` release as timm's names, which
    :func:`resnetv2_bit_state_dict_to_flax` reads (``convert.py:3086``):
    HWIO kernels to OIHW, ``block<i>/unit<j>/{a,b,c}`` to
    ``stages.<i-1>.blocks.<j-1>.{1,2,3}``, ``a/proj`` to the downsample."""
    out: Dict[str, np.ndarray] = {}
    sub = {"a": "1", "b": "2", "c": "3"}
    named = {"root_block/standardized_conv2d/kernel": "stem.conv.weight",
             "group_norm/gamma": "norm.weight", "group_norm/beta": "norm.bias",
             "head/conv2d/kernel": "head.fc.weight", "head/conv2d/bias": "head.fc.bias"}
    for name, v in weights.items():
        if not name.startswith(prefix):
            continue
        name = name[len(prefix):]
        v = np.asarray(v)
        v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.reshape(-1)
        if name in named:
            out[named[name]] = v
            continue
        m = re.match(r"block(\d+)/unit(\d+)/(a|b|c)(/proj)?/"
                     r"(?:standardized_conv2d/kernel|group_norm/(gamma|beta))$", name)
        if not m:
            continue
        base = f"stages.{int(m[1]) - 1}.blocks.{int(m[2]) - 1}"
        if m[4]:
            out[f"{base}.downsample.conv.weight"] = v
        elif m[5]:
            out[f"{base}.norm{sub[m[3]]}.{'weight' if m[5] == 'gamma' else 'bias'}"] = v
        else:
            out[f"{base}.conv{sub[m[3]]}.weight"] = v
    return out


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


def _check_standalone(name: str, flat: Mapping[str, np.ndarray]) -> None:
    """Raise unless ``flat`` holds every parameter (and BatchNorm statistic)
    of the registry's model ``name`` in its shape, at the class count of its
    head and, for PiT, the input size its position embedding's grid gives.
    A VGG's classifier is not converted (``vgg_state_dict_to_flax``)."""
    from acr_wsss_tpu_torch.models.registry import create_model

    head = next((h for h in ("head", "fc", "classifier", "fc3", "last_linear")
                 if f"params/{h}/bias" in flat),
                None)
    kwargs = {} if head is None else {"num_classes": len(flat[f"params/{head}/bias"])}
    with torch.device("meta"):
        model = create_model(name, **kwargs)
        pos = flat.get("params/pos_embed")
        if name.startswith("pit") and pos is not None and tuple(pos.shape[1:3]) != model.grid:
            conv = model.patch_embed
            kwargs["img_size"] = tuple((g - 1) * conv.stride[0] + conv.kernel_size[0]
                                       for g in pos.shape[1:3])
            model = create_model(name, **kwargs)
    reference = model.state_dict()
    if name.startswith("vgg"):
        reference = {k: v for k, v in reference.items()
                     if not k.startswith(("fc1.", "fc2.", "fc3."))}
    flax_to_state_dict(flat, reference)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Convert a reference ACR checkpoint, or a timm one of a registry name,
    to the flat flax npz."""
    from acr_wsss_tpu_torch.models.acr import ACR
    from acr_wsss_tpu_torch.models.registry import is_model
    from acr_wsss_tpu_torch.utils.checkpoint import save_params_npz

    parser = argparse.ArgumentParser(description="reference ACR or timm .pth -> flat flax .npz")
    parser.add_argument("torch_ckpt")
    parser.add_argument("out_npz")
    parser.add_argument("--backbone", default="vitb_hybrid",
                        help="an ACR backbone (vitb_hybrid, vit_small, ...), or a name of "
                             "the registry: swin_*, pit_*, vit_*_224/384... (the ViT and DeiT "
                             "classifiers), resnetv2_*_bitm, the ResNet, VGG, DenseNet, "
                             "EfficientNet, MobileNetV3, RegNet, SENet, SK-ResNet, Res2Net "
                             "and ResNeSt families (resnet50, resnet50d, efficientnet_b0, "
                             "regnety_032, seresnet50, resnest50d, legacy_senet154, ...)")
    parser.add_argument("--scan", action="store_true",
                        help="write JAX's stacked layout (trunk/blocks_scan/block/...)")
    args = parser.parse_args(argv)
    standalone = is_model(args.backbone)
    if standalone and args.scan:
        parser.error("--scan is the ACR trunk's layout")
    state = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "model" in state:
        state = state["model"]           # the reference's BaseModel.load format
    state = {k[len("module."):] if k.startswith("module.") else k: v for k, v in state.items()}
    if standalone:
        from acr_wsss_tpu_torch.models.zoo import convert_state_dict
        flat = convert_state_dict(args.backbone, state)
        _check_standalone(args.backbone, flat)
        layout = "standalone"
    else:
        flat = torch_state_dict_to_flax(state)
        # Raises unless every parameter of the backbone's model is there, in its shape.
        num_classes = len(flat.get("params/cls_head/bias", range(20)))
        model = ACR(num_classes=num_classes, backbone_name=args.backbone, attn_impl="plain")
        flax_to_state_dict(flat, model.state_dict())
        if args.scan:
            flat = unrolled_to_scanned(flat)
        layout = "scanned" if args.scan else "unrolled"
    save_params_npz(args.out_npz, flat)
    print(f"wrote {args.out_npz}: {sum(v.size for v in flat.values()) / 1e6:.1f}M params "
          f"({args.backbone}, {layout} layout)")


if __name__ == "__main__":
    main()
