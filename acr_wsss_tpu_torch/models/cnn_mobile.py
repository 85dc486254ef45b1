"""Mobile and efficient CNN families: EfficientNet, MobileNetV3, RegNet.

Counterpart of ``acr_wsss_tpu/models/cnn_mobile.py``: ``SqueezeExcite``
(``:36``, float32 global pool, biased 1x1 reduce and expand convs, a
sigmoid or hard-sigmoid gate), ``DepthwiseConvBN`` (``:56``),
``MBConv`` (``:79``, the inverted residual: 1x1 expand, depthwise conv,
SE, 1x1 project), ``EfficientNet`` (``:147``, b0's stage table scaled by
width and depth), ``MobileNetV3`` (``:208``, the large variant, its
post-pool ``pre`` Dense), ``RegNetBottleneck`` and ``RegNet`` (``:246``,
``:286``, X and Y, the Y's SE from the block's input width), and the 32
registry names with JAX's defaults.

``SqueezeExcite`` is the root of the rest of the zoo: ``cnn_attn`` and the
families after it import it. BatchNorm is flax's
(``models/layers.BatchNorm``); module names follow the flax ones, so the
converter maps paths one to one. The forward takes an NHWC image and
returns ``logits``, ``features`` (the last map) and ``taps``, maps in
NCHW. Channel counts are computed with JAX's own float expressions
(``int(in_chs * expand_ratio)``), so every width is JAX's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from acr_wsss_tpu_torch.models.cnn import ConvBN, _register
from acr_wsss_tpu_torch.models.layers import (BatchNorm, check_bn_axis_name, classifier_head,
                                              conv2d)
from acr_wsss_tpu_torch.models.registry import register_model


def hardsigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def hardswish(x: torch.Tensor) -> torch.Tensor:
    return x * hardsigmoid(x)


_ACTS = {"silu": F.silu, "hardswish": hardswish, "relu": F.relu}


class SqueezeExcite(nn.Module):
    """SE block: float32 global pool -> 1x1 reduce -> act (relu or silu)
    -> 1x1 expand -> gate (sigmoid, or ``"hard"``) -> x times the gate in
    x's dtype."""

    def __init__(self, chs: int, reduced_chs: int, gate: str = "sigmoid", act: str = "relu"):
        super().__init__()
        self.reduce = nn.Conv2d(chs, reduced_chs, 1)
        self.expand = nn.Conv2d(reduced_chs, chs, 1)
        self.gate, self.act = gate, act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean(dim=(2, 3), keepdim=True)
        s = _ACTS[self.act](self.reduce(s))
        s = self.expand(s)
        s = hardsigmoid(s) if self.gate == "hard" else torch.sigmoid(s)
        return (x * s.to(x.dtype)).to(x.dtype)


class DepthwiseConvBN(nn.Module):
    """Depthwise k x k conv (padded k // 2, no bias) -> BatchNorm, out in
    the compute dtype."""

    def __init__(self, chs: int, kernel_size: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = nn.Conv2d(chs, chs, kernel_size, stride, kernel_size // 2, groups=chs,
                              bias=False)
        self.bn = BatchNorm(chs)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(conv2d(x, self.conv, self.dtype)).to(self.dtype)


def round_chs(chs: float, multiplier: float, divisor: int = 8) -> int:
    """timm's width rounding (``cnn_mobile.py:139``)."""
    chs *= multiplier
    new = max(divisor, int(chs + divisor / 2) // divisor * divisor)
    if new < 0.9 * chs:
        new += divisor
    return int(new)


class MBConv(nn.Module):
    """Inverted-residual block (MobileNetV2/EfficientNet/MobileNetV3): the
    expand 1x1 where the width changes, the depthwise conv, SE of
    ``se_ratio`` of the input width (``se_divisor`` rounding for
    MobileNetV3), the project 1x1; the residual at stride 1 and equal
    widths."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int = 3, stride: int = 1,
                 expand_ratio: float = 6.0, se_ratio: float = 0.25, act: str = "silu",
                 se_gate: str = "sigmoid", se_act: str = "relu", se_divisor: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        mid = int(in_chs * expand_ratio)
        self.act, self.dtype = _ACTS[act], dtype
        self.residual = stride == 1 and in_chs == out_chs
        if mid != in_chs:
            self.expand = ConvBN(in_chs, mid, 1, apply_act=False, dtype=dtype)
        self.dw = DepthwiseConvBN(mid, kernel_size, stride, dtype)
        if se_ratio > 0:
            reduced = (max(1, int(in_chs * se_ratio)) if se_divisor == 1 else
                       round_chs(in_chs * se_ratio, 1.0, se_divisor))
            self.se = SqueezeExcite(mid, reduced, gate=se_gate, act=se_act)
        self.project = ConvBN(mid, out_chs, 1, apply_act=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.expand(x)) if hasattr(self, "expand") else x
        y = self.act(self.dw(y))
        if hasattr(self, "se"):
            y = self.se(y)
        y = self.project(y)
        if self.residual:
            y = y + x
        return y.to(self.dtype)


# EfficientNet-B0 stage table: (expand, kernel, stride, channels, repeats)
_EFFNET_B0 = (
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
)


class EfficientNet(nn.Module):
    """EfficientNet classifier (timm ``efficientnet.py``): b0's stages
    scaled by ``width_mult`` and ``depth_mult``; taps after stages 1, 2, 4
    and 6 (strides 4, 8, 16, 32)."""

    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 depth_mult: float = 1.0, dtype: torch.dtype = torch.bfloat16,
                 bn_axis_name: Optional[str] = None):
        super().__init__()
        check_bn_axis_name(bn_axis_name)
        self.dtype = dtype
        prev = round_chs(32, width_mult)
        self.stem = ConvBN(3, prev, 3, 2, apply_act=False, dtype=dtype)
        self.stages = []
        for si, (exp, k, s, chs, reps) in enumerate(_EFFNET_B0):
            chs = round_chs(chs, width_mult)
            names = []
            for bi in range(int(math.ceil(reps * depth_mult))):
                self.add_module(f"stage{si}_block{bi}", MBConv(
                    prev, chs, k, s if bi == 0 else 1, expand_ratio=exp, se_ratio=0.25,
                    act="silu", se_act="silu", dtype=dtype))
                names.append(f"stage{si}_block{bi}")
                prev = chs
            self.stages.append(names)
        head = round_chs(1280, width_mult)
        self.head_conv = ConvBN(prev, head, 1, apply_act=False, dtype=dtype)
        self.classifier = nn.Linear(head, num_classes)

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        x = F.silu(self.stem(x.permute(0, 3, 1, 2).to(self.dtype)))
        taps: Dict[int, torch.Tensor] = {}
        for si, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if si in (1, 2, 4, 6):
                taps[len(taps)] = x
        x = F.silu(self.head_conv(x))
        return {"logits": classifier_head(x, self.classifier), "features": x, "taps": taps}


# MobileNetV3-Large: (kernel, expanded_chs, out_chs, se, act, stride)
_MBV3_LARGE = (
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2),
    (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1),
    (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2),
    (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
)


class MobileNetV3(nn.Module):
    """MobileNetV3-Large classifier (timm ``mobilenetv3.py``): hard-sigmoid
    SE of make_divisible(mid / 4, 8) channels; after the pooled 960 maps a
    float32 ``pre`` Dense (1280) and hard-swish, then the classifier."""

    def __init__(self, num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
                 bn_axis_name: Optional[str] = None):
        super().__init__()
        check_bn_axis_name(bn_axis_name)
        self.dtype = dtype
        self.stem = ConvBN(3, 16, 3, 2, apply_act=False, dtype=dtype)
        prev = 16
        for bi, (k, mid, out, se, act, s) in enumerate(_MBV3_LARGE):
            self.add_module(f"block{bi}", MBConv(
                prev, out, k, s, expand_ratio=mid / prev,
                se_ratio=(0.25 * mid / prev) if se else 0.0, se_divisor=8, act=act,
                se_gate="hard", dtype=dtype))
            prev = out
        self.head_conv = ConvBN(prev, 960, 1, apply_act=False, dtype=dtype)
        self.pre = nn.Linear(960, 1280)
        self.classifier = nn.Linear(1280, num_classes)

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        x = hardswish(self.stem(x.permute(0, 3, 1, 2).to(self.dtype)))
        taps: Dict[int, torch.Tensor] = {}
        for bi in range(len(_MBV3_LARGE)):
            x = getattr(self, f"block{bi}")(x)
            if bi in (2, 5, 11, 14):
                taps[len(taps)] = x
        x = hardswish(self.head_conv(x))
        h = hardswish(self.pre(x.float().mean(dim=(2, 3))))
        return {"logits": self.classifier(h), "features": x, "taps": taps}


class RegNetBottleneck(nn.Module):
    """RegNet X/Y bottleneck: 1x1 -> grouped 3x3 (``group_width`` channels
    a group) -> SE of ``se_ratio`` of the input width (Y) -> 1x1."""

    def __init__(self, in_chs: int, out_chs: int, stride: int = 1, group_width: int = 16,
                 se_ratio: float = 0.0, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        if stride != 1 or in_chs != out_chs:
            self.downsample = ConvBN(in_chs, out_chs, 1, stride, apply_act=False, dtype=dtype)
        self.conv1 = ConvBN(in_chs, out_chs, 1, dtype=dtype)
        self.conv2 = nn.Conv2d(out_chs, out_chs, 3, stride, 1,
                               groups=max(1, out_chs // group_width), bias=False)
        self.bn2 = BatchNorm(out_chs)
        if se_ratio > 0:
            self.se = SqueezeExcite(out_chs, max(1, int(in_chs * se_ratio)))
        self.conv3 = ConvBN(out_chs, out_chs, 1, apply_act=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.downsample(x) if hasattr(self, "downsample") else x
        y = F.relu(self.bn2(conv2d(self.conv1(x), self.conv2, self.dtype))).to(self.dtype)
        if hasattr(self, "se"):
            y = self.se(y)
        return F.relu(self.conv3(y) + shortcut).to(self.dtype)


class RegNet(nn.Module):
    """RegNet classifier (timm ``regnet.py``); the Y variants add SE (0.25).
    Taps after each stage."""

    def __init__(self, num_classes: int = 1000, depths: Sequence[int] = (1, 1, 4, 7),
                 widths: Sequence[int] = (24, 56, 152, 368), group_width: int = 8,
                 se_ratio: float = 0.0, dtype: torch.dtype = torch.bfloat16,
                 bn_axis_name: Optional[str] = None):
        super().__init__()
        check_bn_axis_name(bn_axis_name)
        self.dtype = dtype
        self.stem = ConvBN(3, 32, 3, 2, dtype=dtype)
        self.stages, prev = [], 32
        for si, (depth, width) in enumerate(zip(depths, widths)):
            names = []
            for bi in range(depth):
                self.add_module(f"stage{si}_block{bi}", RegNetBottleneck(
                    prev, width, 2 if bi == 0 else 1, group_width, se_ratio, dtype))
                names.append(f"stage{si}_block{bi}")
                prev = width
            self.stages.append(names)
        self.head = nn.Linear(prev, num_classes)

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        x = self.stem(x.permute(0, 3, 1, 2).to(self.dtype))
        taps: Dict[int, torch.Tensor] = {}
        for si, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            taps[si] = x
        return {"logits": classifier_head(x, self.head), "features": x, "taps": taps}


# --- the registry (JAX ``cnn_mobile.py:302-406``) -----------------------------

for _n, _w, _d in (("efficientnet_b0", 1.0, 1.0), ("efficientnet_b1", 1.0, 1.1),
                   ("efficientnet_b2", 1.1, 1.2), ("efficientnet_b3", 1.2, 1.4),
                   ("efficientnet_b4", 1.4, 1.8)):
    _register(_n, EfficientNet, width_mult=_w, depth_mult=_d)

# the _miil names: the same architecture, ImageNet-21K-P recipe checkpoints
_register("mobilenetv3_large_100", MobileNetV3)
_register("mobilenetv3_large_100_miil", MobileNetV3)
_register("mobilenetv3_large_100_miil_in21k", MobileNetV3, num_classes=11221)

# (depths, widths, group width, SE ratio): JAX's table (``cnn_mobile.py:332``),
# derived there with the reference's quantization of its model_cfgs.
_REGNET_CFGS = {
    "regnetx_002": ((1, 1, 4, 7), (24, 56, 152, 368), 8, 0.0),
    "regnety_002": ((1, 1, 4, 7), (24, 56, 152, 368), 8, 0.25),
    "regnetx_032": ((2, 6, 15, 2), (96, 192, 432, 1008), 48, 0.0),
    "regnetx_004": ((1, 2, 7, 12), (32, 64, 160, 384), 16, 0.0),
    "regnetx_006": ((1, 3, 5, 7), (48, 96, 240, 528), 24, 0.0),
    "regnetx_008": ((1, 3, 7, 5), (64, 128, 288, 672), 16, 0.0),
    "regnetx_016": ((2, 4, 10, 2), (72, 168, 408, 912), 24, 0.0),
    "regnetx_040": ((2, 5, 14, 2), (80, 240, 560, 1360), 40, 0.0),
    "regnetx_064": ((2, 4, 10, 1), (168, 392, 784, 1624), 56, 0.0),
    "regnetx_080": ((2, 5, 15, 1), (80, 240, 720, 1920), 80, 0.0),
    "regnetx_120": ((2, 5, 11, 1), (224, 448, 896, 2240), 112, 0.0),
    "regnetx_160": ((2, 6, 13, 1), (256, 512, 896, 2048), 128, 0.0),
    "regnetx_320": ((2, 7, 13, 1), (336, 672, 1344, 2520), 168, 0.0),
    "regnety_004": ((1, 3, 6, 6), (48, 104, 208, 440), 8, 0.25),
    "regnety_006": ((1, 3, 7, 4), (48, 112, 256, 608), 16, 0.25),
    "regnety_008": ((1, 3, 8, 2), (64, 128, 320, 768), 16, 0.25),
    "regnety_016": ((2, 6, 17, 2), (48, 120, 336, 888), 24, 0.25),
    "regnety_032": ((2, 5, 13, 1), (72, 216, 576, 1512), 24, 0.25),
    "regnety_040": ((2, 6, 12, 2), (128, 192, 512, 1088), 64, 0.25),
    "regnety_064": ((2, 7, 14, 2), (144, 288, 576, 1296), 72, 0.25),
    "regnety_080": ((2, 4, 10, 1), (168, 448, 896, 2016), 56, 0.25),
    "regnety_120": ((2, 5, 11, 1), (224, 448, 896, 2240), 112, 0.25),
    "regnety_160": ((2, 4, 11, 1), (224, 448, 1232, 3024), 112, 0.25),
    "regnety_320": ((2, 5, 12, 1), (232, 696, 1392, 3712), 232, 0.25),
}
for _n, (_d, _w, _g, _s) in _REGNET_CFGS.items():
    _register(_n, RegNet, depths=_d, widths=_w, group_width=_g, se_ratio=_s)
