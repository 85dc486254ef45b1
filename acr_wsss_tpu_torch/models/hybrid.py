"""ResNetV2 trunks: the stem of the R50+ViT-B/16 hybrid backbone and the
ResNetV2 and BiT classifiers of the registry.

Counterpart of ``acr_wsss_tpu/models/hybrid.py``: ``Bottleneck`` and
``ResNetV2Stem`` (``:33-58``, ``:111-147``): non-pre-activation
bottlenecks of weight-standardized 'SAME' convs and GroupNorm(32), any
stage plan and channels (``layers=()`` is the bare stem). For a 384 input
and the (3, 4, 9) plan: 7x7/2 stem conv and 3x3/2 max pool -> 96, stage 0
-> 96, stage 1 -> 48, stage 2 -> 24. ``s2d_stem`` computes the 7x7/2 stem
conv as space-to-depth and a folded 4x4/1 conv (``WSConvS2D``,
``:61-110``): the same parameter and the same function.

The classifiers (``:150-296``): ``ResNetV2`` (``resnetv2_50``,
``resnetv2_101``) is the stem's trunk over four stages with a mean pool
and a Dense head; ``BiTResNetV2`` is BiT's pre-activation ResNetV2
(``PreActBottleneck``; the 'fixed' stem: a 7x7/2 conv padded 3, zero pad
1 and a 3x3/2 max pool; a final GroupNorm and ReLU), registered under the
``_bitm`` names and their ``_in21k`` twins (21843 classes). Each takes an
NHWC image and returns ``logits``, ``features`` (the last stage's map,
after BiT's final norm) and ``taps`` (the stages' maps: "stage0".. for
``ResNetV2``, 0.. for BiT), maps in NCHW, PyTorch's layout.
``TimmResNetStem`` (``:298-316``) is the ResNet-D trunk of
``models/resnet_timm.py`` (resnet26d or resnet50d, the deep stem and
average-pool downsampling) under the four ViT hybrids on it: its stage
``out_index`` is the map the patch embedding reads; its BatchNorms keep
their running statistics in training too, as JAX calls that trunk with
``train=False``.

Module names follow the flax ones so the converter maps paths one to one.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from acr_wsss_tpu_torch.models.layers import GroupNormAct, WSConv, max_pool_same
from acr_wsss_tpu_torch.models.registry import register_model
from acr_wsss_tpu_torch.models.resnet_timm import TimmResNet


class Bottleneck(nn.Module):
    def __init__(self, in_chs: int, out_chs: int, stride: int = 1,
                 bottle_ratio: float = 0.25):
        super().__init__()
        mid = max(8, int(out_chs * bottle_ratio + 4) // 8 * 8)
        self.has_downsample = in_chs != out_chs or stride != 1
        if self.has_downsample:
            self.downsample_conv = WSConv(in_chs, out_chs, 1, stride)
            self.downsample_norm = GroupNormAct(out_chs, apply_act=False)
        self.conv1 = WSConv(in_chs, mid, 1)
        self.norm1 = GroupNormAct(mid)
        self.conv2 = WSConv(mid, mid, 3, stride)
        self.norm2 = GroupNormAct(mid)
        self.conv3 = WSConv(mid, out_chs, 1)
        self.norm3 = GroupNormAct(out_chs, apply_act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.has_downsample:
            shortcut = self.downsample_norm(self.downsample_conv(x))
        y = self.norm1(self.conv1(x))
        y = self.norm2(self.conv2(y))
        y = self.norm3(self.conv3(y))
        return F.relu(y + shortcut)


class WSConvS2D(WSConv):
    """The 7x7/2 weight-standardized 'SAME' conv on an even-sized input as
    a 2x2 space-to-depth (``pixel_unshuffle``) and a 4x4/1 VALID conv over
    the folded kernel (``acr_wsss_tpu/models/hybrid.py:61-110``). Same
    ``weight`` (out, in, 7, 7), standardized before the fold; the eighth
    tap is zero."""

    def __init__(self, in_chs: int, out_chs: int, eps: float = 1e-5):
        super().__init__(in_chs, out_chs, 7, 2, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-2] % 2 or x.shape[-1] % 2:
            raise ValueError(f"the s2d stem needs an even input size, got {tuple(x.shape)}")
        w = self.standardized_weight()
        out_chs, in_chs = w.shape[:2]
        # kf[o, (p, q, c), a, b] = w8[o, c, 2a + p, 2b + q]
        kf = F.pad(w, (0, 1, 0, 1)).reshape(out_chs, in_chs, 4, 2, 4, 2)
        kf = kf.permute(0, 3, 5, 1, 2, 4).reshape(out_chs, 4 * in_chs, 4, 4)
        # 'SAME' for 7/2 on an even size pads (2, 3); one more high pad makes
        # the extent even and meets only the zero tap.
        z = F.pixel_unshuffle(F.pad(x, (2, 4, 2, 4)), 2)         # channels (c, p, q)
        b, _, hz, wz = z.shape
        z = z.reshape(b, in_chs, 4, hz, wz).transpose(1, 2).reshape(b, 4 * in_chs, hz, wz)
        return F.conv2d(z, kf.to(x.dtype))


class ResNetV2Stem(nn.Module):
    """NCHW image -> (stride-16 feature map, {"stage0".."stage2": taps})."""

    def __init__(self, layers: Sequence[int] = (3, 4, 9),
                 channels: Sequence[int] = (256, 512, 1024),
                 stem_chs: int = 64, in_chs: int = 3, s2d_stem: bool = False):
        super().__init__()
        self.stem_conv = (WSConvS2D(in_chs, stem_chs) if s2d_stem
                          else WSConv(in_chs, stem_chs, 7, 2))
        self.stem_norm = GroupNormAct(stem_chs)
        self.block_names = []
        prev = stem_chs
        for si, (depth, chs) in enumerate(zip(layers, channels)):
            for bi in range(depth):
                stride = (1 if si == 0 else 2) if bi == 0 else 1
                name = f"stages_{si}_blocks_{bi}"
                self.add_module(name, Bottleneck(prev, chs, stride))
                self.block_names.append((si, name))
                prev = chs
        self.num_features = prev

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x = max_pool_same(self.stem_norm(self.stem_conv(x)), 3, 2)
        taps: Dict[str, torch.Tensor] = {}
        for si, name in self.block_names:
            x = getattr(self, name)(x)
            taps[f"stage{si}"] = x
        return x, taps


def _nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).to(dtype)


class ResNetV2(nn.Module):
    """The stem generalized to four stages, a float32 mean pool and a Dense
    head (``:150-178``); ``width_factor`` multiplies every width."""

    def __init__(self, num_classes: int = 1000, layers: Sequence[int] = (3, 4, 6, 3),
                 channels: Sequence[int] = (256, 512, 1024, 2048), width_factor: int = 1,
                 stem_chs: int = 64, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.trunk = ResNetV2Stem(layers, tuple(c * width_factor for c in channels),
                                  stem_chs * width_factor)
        self.head = nn.Linear(self.trunk.num_features, num_classes)

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        x, taps = self.trunk(_nchw(x, self.dtype))
        logits = self.head(x.float().mean(dim=(2, 3)))
        return {"logits": logits, "features": x, "taps": taps}


@register_model
def resnetv2_50(**kwargs):
    return ResNetV2(layers=(3, 4, 6, 3), **kwargs)


@register_model
def resnetv2_101(**kwargs):
    return ResNetV2(layers=(3, 4, 23, 3), **kwargs)


class PreActBottleneck(nn.Module):
    """BiT's pre-activation bottleneck (``:191-220``): GroupNorm and ReLU
    first; the projection shortcut takes the pre-activated input; the
    stride is on the 3x3, padded 1 on every side (BiT's checkpoints were
    trained so, not 'SAME')."""

    def __init__(self, in_chs: int, out_chs: int, stride: int = 1, bottle_ratio: float = 0.25):
        super().__init__()
        mid = max(8, int(out_chs * bottle_ratio + 4) // 8 * 8)
        self.norm1 = GroupNormAct(in_chs)
        self.has_downsample = in_chs != out_chs or stride != 1
        if self.has_downsample:
            self.downsample_conv = WSConv(in_chs, out_chs, 1, stride)
        self.conv1 = WSConv(in_chs, mid, 1)
        self.norm2 = GroupNormAct(mid)
        self.conv2 = WSConv(mid, mid, 3, stride, padding=1)
        self.norm3 = GroupNormAct(mid)
        self.conv3 = WSConv(mid, out_chs, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_pre = self.norm1(x)
        shortcut = self.downsample_conv(x_pre) if self.has_downsample else x
        y = self.norm2(self.conv1(x_pre))
        y = self.norm3(self.conv2(y))
        return self.conv3(y) + shortcut


def _bit_width(chs: int, width_factor: int) -> int:
    return max(8, int(chs * width_factor + 4) // 8 * 8)


class BiTResNetV2(nn.Module):
    """Pre-activation BiT ResNetV2 (``:223-268``): weight-standardized convs
    and GroupNorm throughout, a final GroupNorm and ReLU before the float32
    mean pool, and the 1x1 conv head as a Dense."""

    def __init__(self, num_classes: int = 1000, layers: Sequence[int] = (3, 4, 6, 3),
                 channels: Sequence[int] = (256, 512, 1024, 2048), width_factor: int = 1,
                 stem_chs: int = 64, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        prev = _bit_width(stem_chs, width_factor)
        self.stem_conv = WSConv(3, prev, 7, 2, padding=3)
        self.block_names = []
        for si, (depth, chs) in enumerate(zip(layers, channels)):
            for bi in range(depth):
                name = f"s{si}_b{bi}"
                out = _bit_width(chs, width_factor)
                self.add_module(name, PreActBottleneck(prev, out, (1 if si == 0 else 2)
                                                       if bi == 0 else 1))
                self.block_names.append((si, name))
                prev = out
        self.norm = GroupNormAct(prev)
        self.head = nn.Linear(prev, num_classes)

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        x = self.stem_conv(_nchw(x, self.dtype))
        x = F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)
        taps: Dict[int, torch.Tensor] = {}
        for si, name in self.block_names:
            x = getattr(self, name)(x)
            taps[si] = x
        x = self.norm(x)
        logits = self.head(x.float().mean(dim=(2, 3)))
        return {"logits": logits, "features": x, "taps": taps}


@register_model
def resnetv2_50x1_bitm(**kwargs):
    return BiTResNetV2(layers=(3, 4, 6, 3), **kwargs)


@register_model
def resnetv2_101x1_bitm(**kwargs):
    return BiTResNetV2(layers=(3, 4, 23, 3), **kwargs)


# BiT's width and depth sweep (``:271-296``); the _in21k releases carry the
# 21843-way head.
_BITM_CFGS = {
    "resnetv2_50x3_bitm": ((3, 4, 6, 3), 3),
    "resnetv2_101x3_bitm": ((3, 4, 23, 3), 3),
    "resnetv2_152x2_bitm": ((3, 8, 36, 3), 2),
    "resnetv2_152x4_bitm": ((3, 8, 36, 3), 4),
}


def _register_bitm(name: str, layers: Tuple[int, ...], width_factor: int,
                   num_classes: int = 1000) -> None:
    def builder(**kwargs):
        kwargs.setdefault("layers", layers)
        kwargs.setdefault("width_factor", width_factor)
        kwargs.setdefault("num_classes", num_classes)
        return BiTResNetV2(**kwargs)

    builder.__name__ = name
    register_model(builder)


for _n, (_l, _wf) in _BITM_CFGS.items():
    _register_bitm(_n, _l, _wf)
for _n, (_l, _wf) in {**_BITM_CFGS, "resnetv2_50x1_bitm": ((3, 4, 6, 3), 1),
                      "resnetv2_101x1_bitm": ((3, 4, 23, 3), 1)}.items():
    _register_bitm(f"{_n}_in21k", _l, _wf, num_classes=21843)


class TimmResNetStem(nn.Module):
    """NCHW image -> (stage ``out_index`` of resnet26d or resnet50d, {}):
    3 the stride-32 last stage, 2 the stride-16 third. The whole trunk is
    held (its later stages and head too, as in JAX's parameters); the
    forward stops at the tap."""

    def __init__(self, variant: str = "resnet26d", out_index: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        layers = (2, 2, 2, 2) if variant == "resnet26d" else (3, 4, 6, 3)
        self.backbone = TimmResNet(layers=layers, stem_width=32, stem_type="deep",
                                   avg_down=True, dtype=dtype)
        self.backbone.train(False)
        self.out_index = out_index
        self.num_features = self.backbone.stage_chs[out_index]

    def train(self, mode: bool = True) -> "TimmResNetStem":
        super().train(mode)
        self.backbone.train(False)
        return self

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return self.backbone.stages(x, self.out_index)[self.out_index], {}
