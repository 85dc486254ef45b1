"""Attention-augmented ResNet families: SENet, SKNet, Res2Net, ResNeSt and
the legacy SENets.

Counterpart of ``acr_wsss_tpu/models/cnn_attn.py``: ResNet-shaped
classifiers whose bottleneck carries a channel or branch attention:

* ``SEBottleneck`` (``:37``): an SE gate (``cnn_mobile.SqueezeExcite``) on
  the 1x1 expand's output, before the residual;
* ``SelectiveKernel`` and ``SKBottleneck`` (``:67``, ``:105``): two 3x3
  branches (dilation 1 and 2) fused by a softmax over the branches;
  ``SelectiveKernelBasicBlock``, ``SelectiveKernelBottleneckBlock`` and
  ``SKResNet`` (``:350``, ``:724``, ``:402``): timm's SK-ResNets (split
  input, a BatchNorm in the attention, the deep stem and average-pool
  downsample of 50d);
* ``Res2NetBottleneck`` (``:131``): the 3x3 as a cascade over ``scale``
  channel splits;
* ``SplitAttentionConv`` and ``ResNeStBottleneck`` (``:183``, ``:235``):
  ``radix`` grouped branches combined by a softmax over the radix;
* ``AttnResNet`` (``:278``): the shared four-stage trunk (7x7 stem or
  the deep 3x3 stem);
* ``LegacySEModule``, ``LegacySENetBlock`` and ``LegacySENet`` (``:471``,
  ``:487``, ``:560``): the Caffe-era layouts (stride on the ResNet
  block's 1x1 conv1, biased SE convs, a ceil-mode stem pool);

and the 33 registry names with JAX's defaults. BatchNorm is flax's
(``models/layers.BatchNorm``), named as the flax modules are, so the
converter maps paths one to one. The forward takes an NHWC image and
returns ``logits``, ``features`` and the four stage ``taps``, in NCHW.
Blocks take ``(in_chs, out_chs, stride, dtype)`` (SK-ResNet's and the
legacy blocks their ``planes``), since a torch module is built before it
sees an input.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from acr_wsss_tpu_torch.models.cnn import ConvBN, _register
from acr_wsss_tpu_torch.models.cnn_mobile import SqueezeExcite
from acr_wsss_tpu_torch.models.layers import (BatchNorm, check_bn_axis_name, classifier_head,
                                              conv2d)
from acr_wsss_tpu_torch.models.registry import register_model


def _avg_pool3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """3x3 average pool padded 1, the zeros counted (flax's ``avg_pool``)."""
    return F.avg_pool2d(x, 3, stride, 1, count_include_pad=True)


def _branch_softmax(stacked: torch.Tensor, a: torch.Tensor, branches: int) -> torch.Tensor:
    """sum over the branches of ``stacked`` (B, K, C, H, W) weighted by the
    softmax over K of ``a`` (B, K * C, 1, 1), branch-major channels."""
    a = torch.softmax(a.reshape(a.shape[0], branches, -1, 1, 1), dim=1)
    return (stacked * a.to(stacked.dtype)).sum(dim=1)


class SEBottleneck(nn.Module):
    """ResNet bottleneck with SE on the 1x1 expand's output (timm's SEResNet
    bottleneck)."""

    def __init__(self, in_chs: int, out_chs: int, stride: int = 1, se_reduction: int = 16,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        mid = out_chs // 4
        self.dtype = dtype
        if stride != 1 or in_chs != out_chs:
            self.downsample = ConvBN(in_chs, out_chs, 1, stride, apply_act=False, dtype=dtype)
        self.conv1 = ConvBN(in_chs, mid, 1, dtype=dtype)
        self.conv2 = ConvBN(mid, mid, 3, stride, dtype=dtype)
        self.conv3 = ConvBN(mid, out_chs, 1, apply_act=False, dtype=dtype)
        self.se = SqueezeExcite(out_chs, max(1, out_chs // se_reduction))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.downsample(x) if hasattr(self, "downsample") else x
        y = self.se(self.conv3(self.conv2(self.conv1(x))))
        return F.relu(y + shortcut).to(self.dtype)


class SelectiveKernel(nn.Module):
    """Selective-kernel conv: a 3x3 branch per dilation, each conv,
    BatchNorm and ReLU in float32, fused by float32 Dense attention
    (``fc_reduce``, ``fc_select``) softmaxed over the branches."""

    def __init__(self, in_chs: int, out_chs: int, stride: int = 1,
                 dilations: Sequence[int] = (1, 2), reduction: int = 16,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dilations, self.dtype = tuple(dilations), dtype
        for bi, d in enumerate(self.dilations):
            self.add_module(f"branch{bi}_conv",
                            nn.Conv2d(in_chs, out_chs, 3, stride, d, d, bias=False))
            self.add_module(f"branch{bi}_bn", BatchNorm(out_chs))
        hidden = max(8, out_chs // reduction)
        self.fc_reduce = nn.Linear(out_chs, hidden)
        self.fc_select = nn.Linear(hidden, out_chs * len(self.dilations))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stacked = torch.stack([
            F.relu(getattr(self, f"branch{bi}_bn")(
                conv2d(x, getattr(self, f"branch{bi}_conv"), self.dtype)))
            for bi in range(len(self.dilations))], dim=1)
        s = stacked.sum(dim=1).float().mean(dim=(2, 3))
        a = self.fc_select(F.relu(self.fc_reduce(s)))
        return _branch_softmax(stacked, a, len(self.dilations)).to(self.dtype)


class SKBottleneck(nn.Module):
    """SKNet bottleneck: 1x1 -> selective kernel -> 1x1."""

    def __init__(self, in_chs: int, out_chs: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        mid = out_chs // 4
        self.dtype = dtype
        if stride != 1 or in_chs != out_chs:
            self.downsample = ConvBN(in_chs, out_chs, 1, stride, apply_act=False, dtype=dtype)
        self.conv1 = ConvBN(in_chs, mid, 1, dtype=dtype)
        self.sk = SelectiveKernel(mid, mid, stride, dtype=dtype)
        self.conv3 = ConvBN(mid, out_chs, 1, apply_act=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.downsample(x) if hasattr(self, "downsample") else x
        return F.relu(self.conv3(self.sk(self.conv1(x))) + shortcut).to(self.dtype)


class Res2NetBottleneck(nn.Module):
    """Res2Net bottleneck (timm's ``Bottle2neck``): the 3x3 as a cascade over
    ``scale`` splits of floor(planes * base_width / 64) * cardinality
    channels. A first block (strided or widening) restarts the cascade at
    every split and average-pools the passthrough split (3x3, the stride,
    padded 1, zeros counted)."""

    def __init__(self, in_chs: int, out_chs: int, stride: int = 1, scale: int = 4,
                 base_width: int = 26, cardinality: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        width = int((out_chs // 4) * base_width / 64.0) * cardinality
        self.scale, self.width, self.stride, self.dtype = scale, width, stride, dtype
        self.is_first = stride > 1 or in_chs != out_chs
        if self.is_first:
            self.downsample = ConvBN(in_chs, out_chs, 1, stride, apply_act=False, dtype=dtype)
        self.conv1 = ConvBN(in_chs, width * scale, 1, dtype=dtype)
        for i in range(max(1, scale - 1)):
            self.add_module(f"convs_{i}", ConvBN(width, width, 3, stride, groups=cardinality,
                                                 dtype=dtype))
        self.conv3 = ConvBN(width * scale, out_chs, 1, apply_act=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.downsample(x) if self.is_first else x
        splits = torch.split(self.conv1(x), self.width, dim=1)
        outs, sp = [], None
        for i in range(max(1, self.scale - 1)):
            sp = splits[i] if (i == 0 or self.is_first) else sp + splits[i]
            sp = getattr(self, f"convs_{i}")(sp)
            outs.append(sp)
        if self.scale > 1:
            outs.append(_avg_pool3(splits[-1], self.stride) if self.is_first else splits[-1])
        y = self.conv3(torch.cat(outs, dim=1))
        return F.relu(y + shortcut).to(self.dtype)


class SplitAttentionConv(nn.Module):
    """ResNeSt split-attention conv (timm's ``SplitAttnConv2d``): one 3x3
    conv of ``cardinality * radix`` groups (radix-major channels),
    BatchNorm, ReLU; the float32 attention fc1 -> BatchNorm -> ReLU -> fc2
    (grouped 1x1 convs, max(in * radix / reduction, 32) channels) on the
    pooled sum of the radix maps; a softmax over the radix (a sigmoid at
    radix 1) weighs the maps."""

    def __init__(self, in_chs: int, out_chs: int, stride: int = 1, radix: int = 2,
                 cardinality: int = 1, reduction: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.radix, self.cardinality, self.out_chs, self.dtype = radix, cardinality, out_chs, dtype
        attn_chs = max(in_chs * radix // reduction, 32)
        self.conv = nn.Conv2d(in_chs, out_chs * radix, 3, stride, 1,
                              groups=cardinality * radix, bias=False)
        self.bn0 = BatchNorm(out_chs * radix)
        self.fc1 = nn.Conv2d(out_chs, attn_chs, 1, groups=cardinality)
        self.bn1 = BatchNorm(attn_chs)
        self.fc2 = nn.Conv2d(attn_chs, out_chs * radix, 1, groups=cardinality)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r, g = self.radix, self.cardinality
        y = F.relu(self.bn0(conv2d(x, self.conv, self.dtype)))
        b, _, h, w = y.shape
        y = y.reshape(b, r, self.out_chs, h, w)
        gap = y.sum(dim=1).float().mean(dim=(2, 3), keepdim=True)
        att = self.fc2(F.relu(self.bn1(self.fc1(gap))))[:, :, 0, 0]
        if r > 1:
            # RadixSoftmax: (B, G, R, C / G), softmax over R, radix-major back
            att = torch.softmax(att.reshape(b, g, r, -1).transpose(1, 2), dim=1)
        else:
            att = torch.sigmoid(att)
        att = att.reshape(b, r, self.out_chs, 1, 1)
        return (y * att.to(y.dtype)).sum(dim=1).to(self.dtype)


class ResNeStBottleneck(nn.Module):
    """ResNeSt bottleneck: 1x1 -> split attention -> 1x1; a strided block
    average-pools (3x3, padded 1) after the split attention, or before it
    with ``avd_first``, and its shortcut 2x2 before the downsample's 1x1."""

    def __init__(self, in_chs: int, out_chs: int, stride: int = 1, radix: int = 2,
                 cardinality: int = 1, base_width: int = 64, avd_first: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        mid = int((out_chs // 4) * (base_width / 64.0)) * cardinality
        self.stride, self.avd_first, self.dtype = stride, avd_first, dtype
        if in_chs != out_chs:
            self.downsample = ConvBN(in_chs, out_chs, 1, 1, apply_act=False, dtype=dtype)
        self.conv1 = ConvBN(in_chs, mid, 1, dtype=dtype)
        self.splat = SplitAttentionConv(mid, mid, 1, radix, cardinality, dtype=dtype)
        self.conv3 = ConvBN(mid, out_chs, 1, apply_act=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = F.avg_pool2d(x, 2, 2) if self.stride != 1 else x
        if hasattr(self, "downsample"):
            shortcut = self.downsample(shortcut)
        y = self.conv1(x)
        if self.stride != 1 and self.avd_first:
            y = _avg_pool3(y, self.stride)
        y = self.splat(y)
        if self.stride != 1 and not self.avd_first:
            y = _avg_pool3(y, self.stride)
        return F.relu(self.conv3(y) + shortcut).to(self.dtype)


def _deep_stem(module: nn.Module, width: int, dtype: torch.dtype) -> int:
    """The three 3x3 ConvBNs stem0-2 (width, width, 2 width) on ``module``;
    returns its output width."""
    module.stem0 = ConvBN(3, width, 3, 2, dtype=dtype)
    module.stem1 = ConvBN(width, width, 3, 1, dtype=dtype)
    module.stem2 = ConvBN(width, 2 * width, 3, 1, dtype=dtype)
    return 2 * width


def _stem(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The deep or the 7x7 stem of ``module`` and the 3x3/2 max pool."""
    if hasattr(module, "stem"):
        x = module.stem(x)
    else:
        x = module.stem2(module.stem1(module.stem0(x)))
    return F.max_pool2d(x, 3, 2, 1)


class AttnResNet(nn.Module):
    """The four-stage trunk of the attention-ResNet families; ``block`` is
    built as ``block(in_chs, out_chs, stride=..., dtype=...)``."""

    def __init__(self, block: Callable[..., nn.Module] = SEBottleneck, num_classes: int = 1000,
                 layers: Sequence[int] = (3, 4, 6, 3), deep_stem: bool = False,
                 stem_width: int = 32, dtype: torch.dtype = torch.bfloat16,
                 bn_axis_name: Optional[str] = None):
        super().__init__()
        check_bn_axis_name(bn_axis_name)
        self.dtype = dtype
        if deep_stem:
            prev = _deep_stem(self, stem_width, dtype)
        else:
            self.stem, prev = ConvBN(3, 64, 7, 2, dtype=dtype), 64
        self.stages = []
        for si, (depth, width) in enumerate(zip(layers, (256, 512, 1024, 2048))):
            names = []
            for bi in range(depth):
                self.add_module(f"layer{si + 1}_{bi}", block(
                    prev, width, stride=2 if bi == 0 and si > 0 else 1, dtype=dtype))
                names.append(f"layer{si + 1}_{bi}")
                prev = width
            self.stages.append(names)
        self.fc = nn.Linear(prev, num_classes)

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        x = _stem(self, x.permute(0, 3, 1, 2).to(self.dtype))
        taps: Dict[int, torch.Tensor] = {}
        for si, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            taps[si] = x
        return {"logits": classifier_head(x, self.fc), "features": x, "taps": taps}


class _SKAttention(nn.Module):
    """The path attention of timm's SK convs, shared by both SK-ResNet
    blocks: float32 1x1 reduce (no bias) -> BatchNorm -> ReLU -> 1x1
    select to two paths' weights, softmaxed over the paths."""

    def _init_attention(self, chs: int, attn_chs: int) -> None:
        self.attn_reduce = nn.Conv2d(chs, attn_chs, 1, bias=False)
        self.attn_bn = BatchNorm(attn_chs)
        self.attn_select = nn.Conv2d(attn_chs, 2 * chs, 1, bias=False)

    def _paths(self, inputs) -> torch.Tensor:
        stacked = torch.stack([
            F.relu(getattr(self, f"path{pi}_bn")(
                conv2d(src, getattr(self, f"path{pi}_conv"), self.dtype))).to(self.dtype)
            for pi, src in enumerate(inputs)], dim=1)
        pooled = stacked.float().sum(dim=1).mean(dim=(2, 3), keepdim=True)
        a = self.attn_select(F.relu(self.attn_bn(self.attn_reduce(pooled))))
        return _branch_softmax(stacked, a, 2)


class SelectiveKernelBasicBlock(_SKAttention):
    """timm's ``SelectiveKernelBasic``: the input halved over two 3x3 paths
    (dilation 1 and 2), their attention (max(planes / 8, 16) channels),
    an activation-free 3x3 conv2, ReLU after the residual."""

    def __init__(self, in_chs: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype, self.half = dtype, in_chs // 2
        if stride != 1 or in_chs != planes:
            self.downsample = ConvBN(in_chs, planes, 1, stride, apply_act=False, dtype=dtype)
        for pi, dil in enumerate((1, 2)):
            self.add_module(f"path{pi}_conv", nn.Conv2d(self.half, planes, 3, stride, dil, dil,
                                                        bias=False))
            self.add_module(f"path{pi}_bn", BatchNorm(planes))
        self._init_attention(planes, max(planes // 8, 16))
        self.conv2 = ConvBN(planes, planes, 3, apply_act=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.downsample(x) if hasattr(self, "downsample") else x
        y = self._paths(torch.split(x, self.half, dim=1)[:2])
        return F.relu(self.conv2(y) + shortcut).to(self.dtype)


class SelectiveKernelBottleneckBlock(_SKAttention):
    """timm's ``SelectiveKernelBottleneck``: 1x1 -> SK conv (two
    cardinality-grouped 3x3 paths, the input halved over them with
    ``split_input``; attention of max(width / 16, 32) channels) -> 1x1,
    out 4 planes; with ``avg_down`` a strided shortcut pools 2x2 before
    its 1x1."""

    def __init__(self, in_chs: int, planes: int, stride: int = 1, cardinality: int = 1,
                 base_width: int = 64, split_input: bool = True, avg_down: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        out_chs = planes * 4
        width = int(math.floor(planes * (base_width / 64))) * cardinality
        self.dtype, self.width, self.split_input = dtype, width, split_input
        self.pool_shortcut = avg_down and stride != 1
        if stride != 1 or in_chs != out_chs:
            self.downsample = ConvBN(in_chs, out_chs, 1, 1 if avg_down else stride,
                                     apply_act=False, dtype=dtype)
        self.conv1 = ConvBN(in_chs, width, 1, dtype=dtype)
        src = width // 2 if split_input else width
        for pi, dil in enumerate((1, 2)):
            self.add_module(f"path{pi}_conv", nn.Conv2d(src, width, 3, stride, dil, dil,
                                                        groups=cardinality, bias=False))
            self.add_module(f"path{pi}_bn", BatchNorm(width))
        self._init_attention(width, max(width // 16, 32))
        self.conv3 = ConvBN(width, out_chs, 1, apply_act=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if hasattr(self, "downsample"):
            shortcut = self.downsample(F.avg_pool2d(x, 2, 2) if self.pool_shortcut else x)
        y = self.conv1(x)
        y = self._paths(torch.split(y, self.width // 2, dim=1)[:2] if self.split_input
                        else (y, y))
        return F.relu(self.conv3(y) + shortcut).to(self.dtype)


class SKResNet(nn.Module):
    """SK-ResNet trunk (timm ``sknet.py``): basic SK blocks (skresnet18/34),
    or SK bottlenecks (skresnet50, 50d with the deep stem and average-pool
    downsample, skresnext50 with 32 groups and no split input)."""

    def __init__(self, num_classes: int = 1000, layers: Sequence[int] = (2, 2, 2, 2),
                 bottleneck: bool = False, cardinality: int = 1, base_width: int = 64,
                 split_input: bool = True, deep_stem: bool = False, avg_down: bool = False,
                 dtype: torch.dtype = torch.bfloat16, bn_axis_name: Optional[str] = None):
        super().__init__()
        check_bn_axis_name(bn_axis_name)
        self.dtype = dtype
        if deep_stem:
            prev = _deep_stem(self, 32, dtype)
        else:
            self.stem, prev = ConvBN(3, 64, 7, 2, dtype=dtype), 64
        self.stages = []
        for si, depth in enumerate(layers):
            planes, names = 64 * (2 ** si), []
            for bi in range(depth):
                stride = 2 if bi == 0 and si > 0 else 1
                if bottleneck:
                    block = SelectiveKernelBottleneckBlock(
                        prev, planes, stride, cardinality, base_width, split_input, avg_down,
                        dtype)
                    prev = planes * 4
                else:
                    block = SelectiveKernelBasicBlock(prev, planes, stride, dtype)
                    prev = planes
                self.add_module(f"layer{si + 1}_{bi}", block)
                names.append(f"layer{si + 1}_{bi}")
            self.stages.append(names)
        self.fc = nn.Linear(prev, num_classes)

    forward = AttnResNet.forward


class LegacySEModule(nn.Module):
    """timm's legacy ``SEModule``: biased float32 1x1 fc convs, ReLU, a
    sigmoid gate."""

    def __init__(self, chs: int, rd_chs: int):
        super().__init__()
        self.fc1 = nn.Conv2d(chs, rd_chs, 1)
        self.fc2 = nn.Conv2d(rd_chs, chs, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.fc2(F.relu(self.fc1(x.float().mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(g).to(x.dtype)


class LegacySENetBlock(nn.Module):
    """The four legacy block layouts: ``basic`` (SEResNetBlock, ReLU after
    bn2 before the SE), ``resnet`` (the stride on the 1x1 conv1),
    ``resnext`` (base width 4) and ``senet154`` (a 2x-wide conv1, the
    grouped conv2 to 4x); a conv and BatchNorm downsample of
    ``ds_kernel``."""

    def __init__(self, in_chs: int, planes: int, kind: str = "resnet", groups: int = 1,
                 reduction: int = 16, stride: int = 1, ds_kernel: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        p, s, self.dtype = planes, stride, dtype
        out_chs = p * (1 if kind == "basic" else 4)
        # (in, out, kernel, stride, groups) of conv1, conv2 and conv3
        layout = {
            "basic": ((in_chs, p, 3, s, 1), (p, p, 3, 1, groups)),
            "resnet": ((in_chs, p, 1, s, 1), (p, p, 3, 1, groups), (p, out_chs, 1, 1, 1)),
            "resnext": ((in_chs, (p * 4 // 64) * groups, 1, 1, 1),
                        ((p * 4 // 64) * groups, (p * 4 // 64) * groups, 3, s, groups),
                        ((p * 4 // 64) * groups, out_chs, 1, 1, 1)),
            "senet154": ((in_chs, 2 * p, 1, 1, 1), (2 * p, 4 * p, 3, s, groups),
                         (4 * p, out_chs, 1, 1, 1)),
        }[kind]
        self.n_convs = len(layout)
        for i, (cin, cout, k, st, g) in enumerate(layout):
            self.add_module(f"conv{i + 1}", nn.Conv2d(cin, cout, k, st, k // 2, groups=g,
                                                      bias=False))
            self.add_module(f"bn{i + 1}", BatchNorm(cout))
        if s != 1 or in_chs != out_chs:
            self.downsample_conv = nn.Conv2d(in_chs, out_chs, ds_kernel, s, ds_kernel // 2,
                                             bias=False)
            self.downsample_bn = BatchNorm(out_chs)
        self.se_module = LegacySEModule(out_chs, out_chs // reduction)

    def _conv_bn(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return getattr(self, f"bn{i}")(conv2d(x, getattr(self, f"conv{i}"), self.dtype)
                                       ).to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self._conv_bn(x, 1))
        y = self._conv_bn(y, 2)
        y = F.relu(y) if self.n_convs == 2 else self._conv_bn(F.relu(y), 3)
        shortcut = x
        if hasattr(self, "downsample_conv"):
            shortcut = self.downsample_bn(conv2d(x, self.downsample_conv, self.dtype)
                                          ).to(self.dtype)
        return F.relu(self.se_module(y) + shortcut).to(self.dtype)


class LegacySENet(nn.Module):
    """Legacy SENet classifier (timm ``senet.py``): the 7x7 stem, or
    senet154's three 3x3 convs (``layer0_conv1-3``); a 3x3/2 ceil-mode
    max pool; blocks of ``block_kind``."""

    def __init__(self, num_classes: int = 1000, layers: Sequence[int] = (3, 4, 6, 3),
                 block_kind: str = "resnet", groups: int = 1, reduction: int = 16,
                 inplanes: int = 64, input_3x3: bool = False, ds_kernel: int = 1,
                 dtype: torch.dtype = torch.bfloat16, bn_axis_name: Optional[str] = None):
        super().__init__()
        check_bn_axis_name(bn_axis_name)
        self.dtype = dtype
        stem = ([(3, 64, 2), (64, 64, 1), (64, inplanes, 1)] if input_3x3
                else [(3, inplanes, 2)])
        for i, (cin, cout, s) in enumerate(stem):
            k = 3 if input_3x3 else 7
            self.add_module(f"layer0_conv{i + 1}", nn.Conv2d(cin, cout, k, s, k // 2,
                                                             bias=False))
            self.add_module(f"layer0_bn{i + 1}", BatchNorm(cout))
        self.n_stem = len(stem)
        self.stages, prev = [], inplanes
        for li, depth in enumerate(layers):
            planes, names = 64 * (2 ** li), []
            for bi in range(depth):
                self.add_module(f"layer{li + 1}_{bi}", LegacySENetBlock(
                    prev, planes, block_kind, groups, reduction,
                    2 if bi == 0 and li > 0 else 1, ds_kernel if li > 0 else 1, dtype))
                names.append(f"layer{li + 1}_{bi}")
                prev = planes * (1 if block_kind == "basic" else 4)
            self.stages.append(names)
        self.last_linear = nn.Linear(prev, num_classes)

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for i in range(1, self.n_stem + 1):
            x = F.relu(getattr(self, f"layer0_bn{i}")(
                conv2d(x, getattr(self, f"layer0_conv{i}"), self.dtype)).to(self.dtype))
        # MaxPool2d(3, 2, ceil_mode=True): -inf rows and columns where the
        # last window runs over
        h, w = x.shape[-2:]
        x = F.max_pool2d(F.pad(x, (0, (w - 3) % 2, 0, (h - 3) % 2), value=-math.inf), 3, 2)
        taps: Dict[int, torch.Tensor] = {}
        for si, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            taps[si] = x
        return {"logits": classifier_head(x, self.last_linear), "features": x, "taps": taps}


# --- the registry (JAX ``cnn_attn.py:319-824``) -------------------------------

_R50, _R101 = (3, 4, 6, 3), (3, 4, 23, 3)
for _n, _block, _cfg in (
        ("seresnet50", SEBottleneck, dict(layers=_R50)),
        ("seresnet101", SEBottleneck, dict(layers=_R101)),
        ("sknet50", SKBottleneck, dict(layers=_R50)),
        ("res2net50", Res2NetBottleneck, dict(layers=_R50)),
        ("resnest50d", ResNeStBottleneck, dict(layers=_R50, deep_stem=True)),
        ("res2net50_26w_4s", Res2NetBottleneck, dict(layers=_R50)),
        ("res2net101_26w_4s", Res2NetBottleneck, dict(layers=_R101)),
        ("res2net50_26w_6s", functools.partial(Res2NetBottleneck, scale=6), dict(layers=_R50)),
        ("res2net50_26w_8s", functools.partial(Res2NetBottleneck, scale=8), dict(layers=_R50)),
        ("res2net50_48w_2s", functools.partial(Res2NetBottleneck, base_width=48, scale=2),
         dict(layers=_R50)),
        ("res2net50_14w_8s", functools.partial(Res2NetBottleneck, base_width=14, scale=8),
         dict(layers=_R50)),
        ("res2next50", functools.partial(Res2NetBottleneck, base_width=4, cardinality=8,
                                         scale=4), dict(layers=_R50)),
        ("resnest14d", ResNeStBottleneck, dict(layers=(1, 1, 1, 1), deep_stem=True)),
        ("resnest26d", ResNeStBottleneck, dict(layers=(2, 2, 2, 2), deep_stem=True)),
        ("resnest101e", ResNeStBottleneck, dict(layers=_R101, deep_stem=True, stem_width=64)),
        ("resnest200e", ResNeStBottleneck, dict(layers=(3, 24, 36, 3), deep_stem=True,
                                                stem_width=64)),
        ("resnest269e", ResNeStBottleneck, dict(layers=(3, 30, 48, 8), deep_stem=True,
                                                stem_width=64)),
        ("resnest50d_1s4x24d", functools.partial(ResNeStBottleneck, radix=1, cardinality=4,
                                                 base_width=24, avd_first=True),
         dict(layers=_R50, deep_stem=True)),
        ("resnest50d_4s2x40d", functools.partial(ResNeStBottleneck, radix=4, cardinality=2,
                                                 base_width=40, avd_first=True),
         dict(layers=_R50, deep_stem=True))):
    _register(_n, AttnResNet, block=_block, **_cfg)

for _n, _cfg in (("skresnet18", dict(layers=(2, 2, 2, 2))),
                 ("skresnet34", dict(layers=_R50)),
                 ("skresnet50", dict(layers=_R50, bottleneck=True)),
                 ("skresnet50d", dict(layers=_R50, bottleneck=True, deep_stem=True,
                                      avg_down=True)),
                 ("skresnext50_32x4d", dict(layers=_R50, bottleneck=True, cardinality=32,
                                            base_width=4, split_input=False))):
    _register(_n, SKResNet, **_cfg)

for _n, _cfg in (("legacy_seresnet18", dict(layers=(2, 2, 2, 2), block_kind="basic")),
                 ("legacy_seresnet34", dict(layers=_R50, block_kind="basic")),
                 ("legacy_seresnet50", dict(layers=_R50)),
                 ("legacy_seresnet101", dict(layers=_R101)),
                 ("legacy_seresnet152", dict(layers=(3, 8, 36, 3))),
                 ("legacy_senet154", dict(layers=(3, 8, 36, 3), block_kind="senet154",
                                          groups=64, inplanes=128, input_3x3=True,
                                          ds_kernel=3)),
                 ("legacy_seresnext26_32x4d", dict(layers=(2, 2, 2, 2), block_kind="resnext",
                                                   groups=32)),
                 ("legacy_seresnext50_32x4d", dict(layers=_R50, block_kind="resnext",
                                                   groups=32)),
                 ("legacy_seresnext101_32x4d", dict(layers=_R101, block_kind="resnext",
                                                    groups=32))):
    _register(_n, LegacySENet, **_cfg)
