"""Classic CNN families: ResNet (v1), VGG, DenseNet.

Counterpart of ``acr_wsss_tpu/models/cnn.py``: ``ConvBN`` (``:32``, conv,
flax BatchNorm, ReLU or the Inplace-ABN LeakyReLU(0.01)), the torchvision
bottleneck and basic blocks (``:64``, ``:98``; ResNeXt cardinality and the
wide base width), ``ResNet`` (``:121``, the 7x7 stem and a 3x3/2 max pool
padded 1), ``VGG`` (``:158``, conv cfg lists with "M" for a 2x2 max pool,
optional BatchNorm, a global mean pool and three float32 Dense layers),
``DenseLayer`` and ``DenseNet`` (``:199``, ``:221``; the deep 3x3 stem and
the blurred stem pool of timm's ``densenet121d`` and ``densenetblur121d``),
and the 47 registry names with JAX's aliases.

BatchNorm is flax's (``models/layers.BatchNorm``; ``training`` picks batch
or running statistics). Module names follow the flax ones, so the
converter maps paths one to one. The forward takes an NHWC image and
returns ``logits``, ``features`` (the last map) and ``taps`` (the four
stage maps; VGG's last four maps before its pools), maps in NCHW.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from acr_wsss_tpu_torch.models.layers import (BatchNorm, check_bn_axis_name, classifier_head,
                                              conv2d)
from acr_wsss_tpu_torch.models.registry import model_entrypoint, register_model
from acr_wsss_tpu_torch.models.resnet_timm import blur_pool


class ConvBN(nn.Module):
    """Conv (no bias, padded k // 2) -> BatchNorm -> ReLU, LeakyReLU(0.01)
    with ``act="leaky"``, or none; out in the compute dtype."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int, stride: int = 1,
                 apply_act: bool = True, groups: int = 1, act: str = "relu",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = nn.Conv2d(in_chs, out_chs, kernel_size, stride, kernel_size // 2,
                              groups=groups, bias=False)
        self.bn = BatchNorm(out_chs)
        self.apply_act, self.act, self.dtype = apply_act, act, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(conv2d(x, self.conv, self.dtype))
        if self.apply_act:
            x = F.leaky_relu(x, 0.01) if self.act == "leaky" else F.relu(x)
        return x.to(self.dtype)


class ResNetBottleneck(nn.Module):
    """1x1 -> 3x3 (the stride, ``cardinality`` groups) -> 1x1, post-BN
    residual; mid width floor(out / 4 * base_width / 64) * cardinality."""

    def __init__(self, in_chs: int, out_chs: int, stride: int = 1, cardinality: int = 1,
                 base_width: int = 64, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        mid = int((out_chs // 4) * base_width / 64.0) * cardinality
        self.dtype = dtype
        if stride != 1 or in_chs != out_chs:
            self.downsample = ConvBN(in_chs, out_chs, 1, stride, apply_act=False, dtype=dtype)
        self.conv1 = ConvBN(in_chs, mid, 1, dtype=dtype)
        self.conv2 = ConvBN(mid, mid, 3, stride, groups=cardinality, dtype=dtype)
        self.conv3 = ConvBN(mid, out_chs, 1, apply_act=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.downsample(x) if hasattr(self, "downsample") else x
        y = self.conv3(self.conv2(self.conv1(x)))
        return F.relu(y + shortcut).to(self.dtype)


class ResNetBasicBlock(nn.Module):
    """Two 3x3 convs (resnet18/34)."""

    def __init__(self, in_chs: int, out_chs: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        if stride != 1 or in_chs != out_chs:
            self.downsample = ConvBN(in_chs, out_chs, 1, stride, apply_act=False, dtype=dtype)
        self.conv1 = ConvBN(in_chs, out_chs, 3, stride, dtype=dtype)
        self.conv2 = ConvBN(out_chs, out_chs, 3, apply_act=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.downsample(x) if hasattr(self, "downsample") else x
        return F.relu(self.conv2(self.conv1(x)) + shortcut).to(self.dtype)


class ResNet(nn.Module):
    """torchvision's ResNet v1 classifier (timm ``resnet.py:1440``)."""

    def __init__(self, num_classes: int = 1000, layers: Sequence[int] = (3, 4, 6, 3),
                 bottleneck: bool = True, cardinality: int = 1, base_width: int = 64,
                 dtype: torch.dtype = torch.bfloat16, bn_axis_name: Optional[str] = None):
        super().__init__()
        check_bn_axis_name(bn_axis_name)
        self.dtype = dtype
        self.stem = ConvBN(3, 64, 7, 2, dtype=dtype)
        widths = (256, 512, 1024, 2048) if bottleneck else (64, 128, 256, 512)
        self.stage_blocks, prev = [], 64
        for si, (depth, width) in enumerate(zip(layers, widths)):
            names = []
            for bi in range(depth):
                stride = 2 if bi == 0 and si > 0 else 1
                block = (ResNetBottleneck(prev, width, stride, cardinality, base_width, dtype)
                         if bottleneck else ResNetBasicBlock(prev, width, stride, dtype))
                self.add_module(f"layer{si + 1}_{bi}", block)
                names.append(f"layer{si + 1}_{bi}")
                prev = width
            self.stage_blocks.append(names)
        self.fc = nn.Linear(prev, num_classes)

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        # torch's MaxPool2d(3, 2, padding=1), not the v2 stem's TF 'SAME'
        x = F.max_pool2d(self.stem(x.permute(0, 3, 1, 2).to(self.dtype)), 3, 2, 1)
        taps: Dict[int, torch.Tensor] = {}
        for si, names in enumerate(self.stage_blocks):
            for name in names:
                x = getattr(self, name)(x)
            taps[si] = x
        return {"logits": classifier_head(x, self.fc), "features": x, "taps": taps}


class VGG(nn.Module):
    """VGG (timm ``vgg.py:260``) over a conv cfg list; ``batch_norm`` for
    the ``_bn`` names. A global mean pool replaces the 7x7 flatten, so any
    input size goes."""

    def __init__(self, num_classes: int = 1000,
                 cfg: Sequence = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                                  512, 512, 512, "M", 512, 512, 512, "M"),
                 batch_norm: bool = False, dtype: torch.dtype = torch.bfloat16,
                 bn_axis_name: Optional[str] = None):
        super().__init__()
        check_bn_axis_name(bn_axis_name)
        self.cfg, self.batch_norm, self.dtype = tuple(cfg), batch_norm, dtype
        prev, ci = 3, 0
        for item in self.cfg:
            if item == "M":
                continue
            self.add_module(f"conv{ci}", nn.Conv2d(prev, int(item), 3, padding=1))
            if batch_norm:
                self.add_module(f"bn{ci}", BatchNorm(int(item)))
            prev, ci = int(item), ci + 1
        self.fc1 = nn.Linear(prev, 4096)
        self.fc2 = nn.Linear(4096, 4096)
        self.fc3 = nn.Linear(4096, num_classes)

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        taps: Dict[int, torch.Tensor] = {}
        stage = ci = 0
        for item in self.cfg:
            if item == "M":
                taps[stage] = x
                stage += 1
                x = F.max_pool2d(x, 2, 2)
                continue
            x = conv2d(x, getattr(self, f"conv{ci}"), self.dtype)
            if self.batch_norm:
                x = getattr(self, f"bn{ci}")(x)
            x = F.relu(x).to(self.dtype)
            ci += 1
        h = F.relu(self.fc2(F.relu(self.fc1(x.float().mean(dim=(2, 3))))))
        return {"logits": self.fc3(h), "features": x,
                "taps": {k: v for k, v in taps.items() if k >= stage - 4}}


class DenseLayer(nn.Module):
    """BN -> ReLU -> 1x1 (4 growth) -> BN -> ReLU -> 3x3 (growth), its
    output concatenated to its input."""

    def __init__(self, in_chs: int, growth_rate: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.norm1 = BatchNorm(in_chs)
        self.conv1 = nn.Conv2d(in_chs, 4 * growth_rate, 1, bias=False)
        self.norm2 = BatchNorm(4 * growth_rate)
        self.conv2 = nn.Conv2d(4 * growth_rate, growth_rate, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d(F.relu(self.norm1(x)), self.conv1, self.dtype)
        y = conv2d(F.relu(self.norm2(y)), self.conv2, self.dtype)
        return torch.cat([x, y.to(x.dtype)], dim=1)


class DenseNet(nn.Module):
    """DenseNet (timm ``densenet.py:387``): the 7x7 stem, or ``deep_stem``'s
    three 3x3 convs; the stem pool a 3x3/2 max pool, or with ``blur`` a
    3x3/1 max pool and a stride-2 blur pool; pre-activation transitions
    (BN, ReLU, 1x1 conv halving the channels, 2x2 average pool); a final
    BN and ReLU."""

    def __init__(self, num_classes: int = 1000, growth_rate: int = 32,
                 block_config: Sequence[int] = (6, 12, 24, 16), deep_stem: bool = False,
                 blur: bool = False, dtype: torch.dtype = torch.bfloat16,
                 bn_axis_name: Optional[str] = None):
        super().__init__()
        check_bn_axis_name(bn_axis_name)
        self.dtype, self.deep_stem, self.blur = dtype, deep_stem, blur
        g = growth_rate
        if deep_stem:
            self.stem0 = ConvBN(3, g, 3, 2, dtype=dtype)
            self.stem1 = ConvBN(g, g, 3, 1, dtype=dtype)
            self.stem2 = ConvBN(g, 2 * g, 3, 1, dtype=dtype)
        else:
            self.stem = ConvBN(3, 2 * g, 7, 2, dtype=dtype)
        self.stage_blocks, prev = [], 2 * g
        for si, depth in enumerate(block_config):
            names = []
            for bi in range(depth):
                self.add_module(f"block{si}_layer{bi}", DenseLayer(prev, g, dtype))
                names.append(f"block{si}_layer{bi}")
                prev += g
            self.stage_blocks.append(names)
            if si < len(block_config) - 1:
                self.add_module(f"transition{si}_norm", BatchNorm(prev))
                self.add_module(f"transition{si}_conv", nn.Conv2d(prev, prev // 2, 1, bias=False))
                prev //= 2
        self.norm5 = BatchNorm(prev)
        self.classifier = nn.Linear(prev, num_classes)

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = self.stem2(self.stem1(self.stem0(x))) if self.deep_stem else self.stem(x)
        if self.blur:
            x = blur_pool(F.max_pool2d(x, 3, 1, 1), 2)
        else:
            x = F.max_pool2d(x, 3, 2, 1)
        taps: Dict[int, torch.Tensor] = {}
        for si, names in enumerate(self.stage_blocks):
            for name in names:
                x = getattr(self, name)(x)
            taps[si] = x
            if si < len(self.stage_blocks) - 1:
                y = F.relu(getattr(self, f"transition{si}_norm")(x))
                x = F.avg_pool2d(conv2d(y, getattr(self, f"transition{si}_conv"), self.dtype), 2)
        x = F.relu(self.norm5(x)).to(self.dtype)
        return {"logits": classifier_head(x, self.classifier), "features": x, "taps": taps}


# --- the registry (JAX ``cnn.py:265-495``) -----------------------------------

def _register(name: str, cls, **cfg) -> None:
    """Register ``name``: ``cls`` with ``cfg`` as defaults, listed under
    ``cls``'s module (the families after this one register through it)."""
    def builder(**kwargs):
        for k, v in cfg.items():
            kwargs.setdefault(k, v)
        return cls(**kwargs)

    builder.__name__, builder.__module__ = name, cls.__module__
    register_model(builder)


_R18, _R34, _R50 = (2, 2, 2, 2), (3, 4, 6, 3), (3, 4, 6, 3)
_R101, _R152 = (3, 4, 23, 3), (3, 8, 36, 3)

for _n, _l, _b in [("resnet18", _R18, False), ("resnet34", _R34, False),
                   ("resnet50", _R50, True), ("resnet101", _R101, True),
                   ("resnet152", _R152, True), ("resnet26", _R18, True),
                   # torchvision-weight aliases and the semi(-weakly)-supervised
                   # releases: plain layouts
                   ("tv_resnet34", _R34, False), ("tv_resnet50", _R50, True),
                   ("tv_resnet101", _R101, True), ("tv_resnet152", _R152, True),
                   ("ssl_resnet18", _R18, False), ("swsl_resnet18", _R18, False),
                   ("ssl_resnet50", _R50, True), ("swsl_resnet50", _R50, True)]:
    _register(_n, ResNet, layers=_l, bottleneck=_b)

for _n, _l, _bw in [("resnext50_32x4d", _R50, 4), ("resnext101_32x8d", _R101, 8),
                    ("tv_resnext50_32x4d", _R50, 4), ("ssl_resnext50_32x4d", _R50, 4),
                    ("swsl_resnext50_32x4d", _R50, 4), ("ssl_resnext101_32x4d", _R101, 4),
                    ("swsl_resnext101_32x4d", _R101, 4), ("ssl_resnext101_32x8d", _R101, 8),
                    ("swsl_resnext101_32x8d", _R101, 8), ("ssl_resnext101_32x16d", _R101, 16),
                    ("swsl_resnext101_32x16d", _R101, 16), ("ig_resnext101_32x8d", _R101, 8),
                    ("ig_resnext101_32x16d", _R101, 16), ("ig_resnext101_32x32d", _R101, 32),
                    ("ig_resnext101_32x48d", _R101, 48)]:
    _register(_n, ResNet, layers=_l, cardinality=32, base_width=_bw)

_register("wide_resnet50_2", ResNet, layers=_R50, base_width=128)
_register("wide_resnet101_2", ResNet, layers=_R101, base_width=128)

_VGG_CFGS = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
              512, 512, 512, 512, "M"),
}
for _n, _c in _VGG_CFGS.items():
    _register(_n, VGG, cfg=_c)


def _register_vgg_bn(base_name: str) -> None:
    """``<base>_bn``: the base builder with BatchNorm (``cnn.py:460``)."""
    def builder(**kwargs):
        kwargs.setdefault("batch_norm", True)
        return model_entrypoint(base_name)(**kwargs)

    builder.__name__ = f"{base_name}_bn"
    register_model(builder)


for _v in _VGG_CFGS:
    _register_vgg_bn(_v)

for _n, _cfg in {"densenet121": dict(block_config=(6, 12, 24, 16)),
                 "densenet169": dict(block_config=(6, 12, 32, 32)),
                 "densenet161": dict(growth_rate=48, block_config=(6, 12, 36, 24)),
                 "densenet201": dict(block_config=(6, 12, 48, 32)),
                 "tv_densenet121": dict(block_config=(6, 12, 24, 16)),
                 "densenet264": dict(growth_rate=48, block_config=(6, 12, 64, 48)),
                 "densenet121d": dict(deep_stem=True),
                 "densenetblur121d": dict(deep_stem=True, blur=True)}.items():
    _register(_n, DenseNet, **_cfg)
