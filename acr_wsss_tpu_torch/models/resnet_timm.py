"""The timm ResNet families: one parameterized trunk behind the long tail of
timm's ``resnet.py`` and ``gluon_resnet.py`` names.

Counterpart of ``acr_wsss_tpu/models/resnet_timm.py``: ``SEModule``
(``:49``, reduction by a divisor or a ratio, rounded with a floor of 8),
``EcaModule`` (``:72``, a bias-free 1-D conv over the pooled channels, its
kernel from the channel count), ``blur_pool`` (``:90``, reflect pad and a
fixed binomial 3x3 depthwise conv), ``Downsample`` (``:115``, a strided conv
or a 2x2 average pool and a 1x1 conv), ``TimmBasicBlock`` and
``TimmBottleneck`` (``:140``, ``:177``) and ``TimmResNet`` (``:229``): the
7x7 stem or the 'deep' and 'deep_tiered' 3x3 stems, the ResNet-RS stem-pool
conv, grouped 3x3s, SE or ECA per block, SENet's ``block_reduce_first``
and 3x3 downsample kernels, BlurPool striding, and the pruned ECA-ResNets'
per-block widths (``block_overrides``). As in JAX, the downsample's
average pool is VALID (timm pools with ``ceil_mode=True``).

BatchNorm is flax's (``models/layers.BatchNorm``): the module's
``training`` flag picks batch or running statistics, as flax's ``train``
argument. Module names follow the flax ones, so the converter maps paths
one to one. The forward takes an NHWC image and returns ``logits``,
``features`` (the last stage's map) and ``taps`` ({0..3: the four stages'
maps}), maps in NCHW.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from acr_wsss_tpu_torch.models.layers import (BatchNorm, check_bn_axis_name, classifier_head,
                                              conv2d, make_divisible)
from acr_wsss_tpu_torch.models.registry import register_model


def _conv(in_chs: int, out_chs: int, k: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    """A bias-free k x k conv padded k // 2 on every side (``:43``)."""
    return nn.Conv2d(in_chs, out_chs, k, stride, k // 2, groups=groups, bias=False)


class SEModule(nn.Module):
    """Squeeze-and-excitation in float32 over the input's ``channels``."""

    def __init__(self, channels: int, reduction: int = 16,
                 reduction_ratio: Optional[float] = None):
        super().__init__()
        if reduction_ratio is not None:
            red = make_divisible(channels * reduction_ratio, 1, 8)
        else:
            red = make_divisible(channels // reduction, 1, 8)
        self.fc1 = nn.Conv2d(channels, red, 1)
        self.fc2 = nn.Conv2d(red, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = x.float().mean(dim=(2, 3), keepdim=True)
        y = self.fc2(F.relu(self.fc1(pooled)))
        return (x.float() * torch.sigmoid(y)).to(x.dtype)


class EcaModule(nn.Module):
    """Efficient channel attention; ``channels`` sets the kernel size only
    (the pruned names keep their unpruned count)."""

    def __init__(self, channels: int):
        super().__init__()
        t = int(abs(math.log(channels, 2) + 1) / 2)
        k = max(t if t % 2 else t + 1, 3)
        self.conv = nn.Conv1d(1, 1, k, padding=k // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = x.float().mean(dim=(2, 3))                    # (B, C)
        gate = torch.sigmoid(self.conv(pooled[:, None, :])[:, 0])
        return (x.float() * gate[:, :, None, None]).to(x.dtype)


def blur_pool(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Anti-aliased striding: reflect pad 1, the binomial [1, 2, 1] x [1, 2,
    1] / 16 filter per channel, stride ``stride``; float32, returned in the
    input's dtype. No parameters."""
    coeffs = np.poly1d((0.5, 0.5)) ** 2
    filt = torch.from_numpy(np.outer(coeffs.coeffs, coeffs.coeffs).astype(np.float32))
    c = x.shape[1]
    y = F.pad(x.float(), (1, 1, 1, 1), mode="reflect")
    out = F.conv2d(y, filt.to(x.device).expand(c, 1, 3, 3), stride=stride, groups=c)
    return out.to(x.dtype)


def _attn(attn: Optional[str], channels: int, attn_chs: int,
          se_ratio: Optional[float]) -> Optional[nn.Module]:
    """The block's attention (named ``se`` either way, as timm's): SE over
    the ``channels`` it sees, ECA sized by ``attn_chs``."""
    if attn == "se":
        return SEModule(channels, reduction_ratio=se_ratio)
    if attn == "eca":
        return EcaModule(attn_chs)
    return None


class Downsample(nn.Module):
    """The shortcut's projection: a conv (``kernel_size`` where it strides)
    or a 2x2 average pool and a 1x1 conv, then BatchNorm (float32 out)."""

    def __init__(self, in_chs: int, out_chs: int, stride: int = 1, kernel_size: int = 1,
                 avg: bool = False):
        super().__init__()
        self.stride, self.avg = stride, avg
        if avg:
            self.downsample_conv = _conv(in_chs, out_chs, 1)
        else:
            k = kernel_size if stride > 1 else 1
            self.downsample_conv = _conv(in_chs, out_chs, k, stride)
        self.downsample_bn = BatchNorm(out_chs)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.avg and self.stride > 1:
            x = F.avg_pool2d(x, 2, self.stride)
        return self.downsample_bn(conv2d(x, self.downsample_conv, dtype))


class TimmBasicBlock(nn.Module):
    """Two 3x3 convs (timm ``resnet.py:279-344``)."""

    def __init__(self, in_chs: int, planes: int, stride: int = 1, reduce_first: int = 1,
                 attn: Optional[str] = None, se_ratio: Optional[float] = None,
                 avg_down: bool = False, down_kernel_size: int = 1, blur: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        first = planes // reduce_first
        self.stride, self.blur, self.dtype = stride, blur, dtype
        if stride != 1 or in_chs != planes:
            self.downsample = Downsample(in_chs, planes, stride, down_kernel_size, avg_down)
        self.conv1 = _conv(in_chs, first, 3, 1 if blur else stride)
        self.bn1 = BatchNorm(first)
        self.conv2 = _conv(first, planes, 3)
        self.bn2 = BatchNorm(planes)
        self.se = _attn(attn, planes, planes, se_ratio)
        self.out_chs = planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.downsample(x, self.dtype) if hasattr(self, "downsample") else x
        y = F.relu(self.bn1(conv2d(x, self.conv1, self.dtype)))
        if self.blur and self.stride > 1:
            y = blur_pool(y, self.stride)
        y = self.bn2(conv2d(y, self.conv2, self.dtype))
        if self.se is not None:
            y = self.se(y)
        return F.relu(y + shortcut).to(self.dtype)


class TimmBottleneck(nn.Module):
    """1x1 -> grouped 3x3 -> 1x1 (timm ``resnet.py:347-420``); ``override``
    gives a pruned block's (conv1, conv2, out) widths."""

    def __init__(self, in_chs: int, planes: int, stride: int = 1, cardinality: int = 1,
                 base_width: int = 64, reduce_first: int = 1, attn: Optional[str] = None,
                 se_ratio: Optional[float] = None, avg_down: bool = False,
                 down_kernel_size: int = 1, blur: bool = False,
                 override: Tuple[int, ...] = (), dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64))) * cardinality
        first = width // reduce_first
        out_chs = attn_chs = planes * 4
        if override:
            first, width, out_chs = override
        self.stride, self.blur, self.dtype = stride, blur, dtype
        if stride != 1 or in_chs != out_chs:
            self.downsample = Downsample(in_chs, out_chs, stride, down_kernel_size, avg_down)
        self.conv1 = _conv(in_chs, first, 1)
        self.bn1 = BatchNorm(first)
        self.conv2 = _conv(first, width, 3, 1 if blur else stride, groups=cardinality)
        self.bn2 = BatchNorm(width)
        self.conv3 = _conv(width, out_chs, 1)
        self.bn3 = BatchNorm(out_chs)
        self.se = _attn(attn, out_chs, attn_chs, se_ratio)
        self.out_chs = out_chs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.downsample(x, self.dtype) if hasattr(self, "downsample") else x
        y = F.relu(self.bn1(conv2d(x, self.conv1, self.dtype)))
        y = F.relu(self.bn2(conv2d(y, self.conv2, self.dtype)))
        if self.blur and self.stride > 1:
            y = blur_pool(y, self.stride)
        y = self.bn3(conv2d(y, self.conv3, self.dtype))
        if self.se is not None:
            y = self.se(y)
        return F.relu(y + shortcut).to(self.dtype)


class TimmResNet(nn.Module):
    """timm's ResNet constructor surface (``resnet.py:575-648``) as one model."""

    def __init__(self, num_classes: int = 1000, bottleneck: bool = True,
                 layers: Sequence[int] = (3, 4, 6, 3), cardinality: int = 1,
                 base_width: int = 64, stem_width: int = 64, stem_type: str = "",
                 replace_stem_pool: bool = False, block_reduce_first: int = 1,
                 down_kernel_size: int = 1, avg_down: bool = False,
                 attn: Optional[str] = None, se_ratio: Optional[float] = None,
                 blur: bool = False, block_overrides: Sequence[Tuple[int, int, int]] = (),
                 dtype: torch.dtype = torch.bfloat16, bn_axis_name: Optional[str] = None):
        super().__init__()
        check_bn_axis_name(bn_axis_name)
        self.dtype = dtype
        self.deep = "deep" in stem_type
        self.replace_stem_pool, self.blur = replace_stem_pool, blur
        inplanes = stem_width * 2 if self.deep else 64
        if self.deep:
            c0 = 3 * (stem_width // 4) if "tiered" in stem_type else stem_width
            self.conv1_0 = _conv(3, c0, 3, 2)
            self.bn1_0 = BatchNorm(c0)
            self.conv1_1 = _conv(c0, stem_width, 3)
            self.bn1_1 = BatchNorm(stem_width)
            self.conv1_2 = _conv(stem_width, inplanes, 3)
        else:
            self.conv1 = _conv(3, inplanes, 7, 2)
        self.bn1 = BatchNorm(inplanes)
        if replace_stem_pool:   # ResNet-RS (:607-613)
            self.stempool_conv = _conv(inplanes, inplanes, 3, 2)
            self.stempool_bn = BatchNorm(inplanes)
        block_kw = dict(reduce_first=block_reduce_first, attn=attn, se_ratio=se_ratio,
                        avg_down=avg_down, blur=blur, dtype=dtype)
        self.stage_blocks, stage_chs = [], []
        prev, flat_bi = inplanes, 0
        for si, (depth, planes) in enumerate(zip(layers, (64, 128, 256, 512))):
            names = []
            for bi in range(depth):
                stride = 2 if bi == 0 and si > 0 else 1
                dks = down_kernel_size if bi == 0 else 1
                if bottleneck:
                    ov = tuple(block_overrides[flat_bi]) if block_overrides else ()
                    block = TimmBottleneck(prev, planes, stride, cardinality, base_width,
                                           down_kernel_size=dks, override=ov, **block_kw)
                else:
                    block = TimmBasicBlock(prev, planes, stride, down_kernel_size=dks,
                                           **block_kw)
                flat_bi += 1
                self.add_module(f"layer{si + 1}_{bi}", block)
                names.append(f"layer{si + 1}_{bi}")
                prev = block.out_chs
            self.stage_blocks.append(names)
            stage_chs.append(prev)
        self.stage_chs = tuple(stage_chs)
        self.num_features = prev
        self.fc = nn.Linear(prev, num_classes)

    def stages(self, x: torch.Tensor, last: int = 3) -> Dict[int, torch.Tensor]:
        """The stage maps {0..last} of an NCHW image in the compute dtype."""
        x = x.to(self.dtype)
        if self.deep:
            x = F.relu(self.bn1_0(conv2d(x, self.conv1_0, self.dtype)))
            x = F.relu(self.bn1_1(conv2d(x, self.conv1_1, self.dtype)))
            x = conv2d(x, self.conv1_2, self.dtype)
        else:
            x = conv2d(x, self.conv1, self.dtype)
        x = F.relu(self.bn1(x))
        if self.replace_stem_pool:
            x = F.relu(self.stempool_bn(conv2d(x, self.stempool_conv, self.dtype)))
        elif self.blur:
            x = blur_pool(F.max_pool2d(x, 3, 1, 1), 2)
        else:
            x = F.max_pool2d(x, 3, 2, 1)
        taps: Dict[int, torch.Tensor] = {}
        for si, names in enumerate(self.stage_blocks[:last + 1]):
            for name in names:
                x = getattr(self, name)(x)
            taps[si] = x
        return taps

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        taps = self.stages(x.permute(0, 3, 1, 2))
        x = taps[len(taps) - 1]
        return {"logits": classifier_head(x, self.fc), "features": x, "taps": taps}


# --- the registry: timm's resnet.py / gluon_resnet.py long tail --------------

_D = dict(stem_width=32, stem_type="deep", avg_down=True)
_T = dict(stem_width=32, stem_type="deep_tiered", avg_down=True)

_TIMM_RESNET_CFGS = {
    # d/t-stem ResNets (resnet.py:656-780)
    "resnet18d": dict(bottleneck=False, layers=(2, 2, 2, 2), **_D),
    "resnet26d": dict(layers=(2, 2, 2, 2), **_D),
    "resnet34d": dict(bottleneck=False, layers=(3, 4, 6, 3), **_D),
    "resnet50d": dict(layers=(3, 4, 6, 3), **_D),
    "resnet50t": dict(layers=(3, 4, 6, 3), **_T),
    "resnet101d": dict(layers=(3, 4, 23, 3), **_D),
    "resnet152d": dict(layers=(3, 8, 36, 3), **_D),
    "resnet200": dict(layers=(3, 24, 36, 3)),
    "resnet200d": dict(layers=(3, 24, 36, 3), **_D),
    # ResNeXt tail (:861-900)
    "resnext101_32x4d": dict(layers=(3, 4, 23, 3), cardinality=32, base_width=4),
    "resnext101_64x4d": dict(layers=(3, 4, 23, 3), cardinality=64, base_width=4),
    "resnext50d_32x4d": dict(layers=(3, 4, 6, 3), cardinality=32, base_width=4, **_D),
    # ECA-ResNets (:1031-1108; the pruned ones below)
    "ecaresnet26t": dict(layers=(2, 2, 2, 2), attn="eca", **_T),
    "ecaresnet50d": dict(layers=(3, 4, 6, 3), attn="eca", **_D),
    "ecaresnet50t": dict(layers=(3, 4, 6, 3), attn="eca", **_T),
    "ecaresnetlight": dict(layers=(1, 1, 11, 3), attn="eca", stem_width=32, avg_down=True),
    "ecaresnet101d": dict(layers=(3, 4, 23, 3), attn="eca", **_D),
    "ecaresnet200d": dict(layers=(3, 24, 36, 3), attn="eca", **_D),
    "ecaresnet269d": dict(layers=(3, 30, 48, 8), attn="eca", **_D),
    "ecaresnext26t_32x4d": dict(layers=(2, 2, 2, 2), cardinality=32, base_width=4, attn="eca",
                                **_T),
    "ecaresnext50t_32x4d": dict(layers=(2, 2, 2, 2), cardinality=32, base_width=4, attn="eca",
                                **_T),
    # ResNet-RS (:1110-1180): deep stem, stem-pool conv, SE ratio 0.25
    "resnetrs50": dict(layers=(3, 4, 6, 3), attn="se", se_ratio=0.25, replace_stem_pool=True,
                       **_D),
    "resnetrs101": dict(layers=(3, 4, 23, 3), attn="se", se_ratio=0.25,
                        replace_stem_pool=True, **_D),
    "resnetrs152": dict(layers=(3, 8, 36, 3), attn="se", se_ratio=0.25,
                        replace_stem_pool=True, **_D),
    "resnetrs200": dict(layers=(3, 24, 36, 3), attn="se", se_ratio=0.25,
                        replace_stem_pool=True, **_D),
    "resnetrs270": dict(layers=(4, 29, 53, 4), attn="se", se_ratio=0.25,
                        replace_stem_pool=True, **_D),
    "resnetrs350": dict(layers=(4, 36, 72, 4), attn="se", se_ratio=0.25,
                        replace_stem_pool=True, **_D),
    "resnetrs420": dict(layers=(4, 44, 87, 4), attn="se", se_ratio=0.25,
                        replace_stem_pool=True, **_D),
    # anti-aliased (:1186-1199)
    "resnetblur18": dict(bottleneck=False, layers=(2, 2, 2, 2), blur=True),
    "resnetblur50": dict(layers=(3, 4, 6, 3), blur=True),
    # SE-ResNet tail (:1203-1310)
    "seresnet18": dict(bottleneck=False, layers=(2, 2, 2, 2), attn="se"),
    "seresnet34": dict(bottleneck=False, layers=(3, 4, 6, 3), attn="se"),
    "seresnet152": dict(layers=(3, 8, 36, 3), attn="se"),
    "seresnet50t": dict(layers=(3, 4, 6, 3), attn="se", **_T),
    "seresnet152d": dict(layers=(3, 8, 36, 3), attn="se", **_D),
    "seresnet200d": dict(layers=(3, 24, 36, 3), attn="se", **_D),
    "seresnet269d": dict(layers=(3, 30, 48, 8), attn="se", **_D),
    # SE-ResNeXt (:1352-1448)
    "seresnext26d_32x4d": dict(layers=(2, 2, 2, 2), cardinality=32, base_width=4, attn="se",
                               **_D),
    "seresnext26t_32x4d": dict(layers=(2, 2, 2, 2), cardinality=32, base_width=4, attn="se",
                               **_T),
    "seresnext26tn_32x4d": dict(layers=(2, 2, 2, 2), cardinality=32, base_width=4, attn="se",
                                **_T),
    "seresnext50_32x4d": dict(layers=(3, 4, 6, 3), cardinality=32, base_width=4, attn="se"),
    "seresnext101_32x4d": dict(layers=(3, 4, 23, 3), cardinality=32, base_width=4, attn="se"),
    "seresnext101_32x8d": dict(layers=(3, 4, 23, 3), cardinality=32, base_width=8, attn="se"),
    "senet154": dict(layers=(3, 8, 36, 3), cardinality=64, base_width=4, stem_type="deep",
                     down_kernel_size=3, block_reduce_first=2, attn="se"),
    # Gluon layouts (gluon_resnet.py:84-224)
    "gluon_resnet18_v1b": dict(bottleneck=False, layers=(2, 2, 2, 2)),
    "gluon_resnet34_v1b": dict(bottleneck=False, layers=(3, 4, 6, 3)),
    "gluon_resnet50_v1b": dict(layers=(3, 4, 6, 3)),
    "gluon_resnet101_v1b": dict(layers=(3, 4, 23, 3)),
    "gluon_resnet152_v1b": dict(layers=(3, 8, 36, 3)),
    "gluon_resnet50_v1c": dict(layers=(3, 4, 6, 3), stem_width=32, stem_type="deep"),
    "gluon_resnet101_v1c": dict(layers=(3, 4, 23, 3), stem_width=32, stem_type="deep"),
    "gluon_resnet152_v1c": dict(layers=(3, 8, 36, 3), stem_width=32, stem_type="deep"),
    "gluon_resnet101_v1d": dict(layers=(3, 4, 23, 3), **_D),
    "gluon_resnet152_v1d": dict(layers=(3, 8, 36, 3), **_D),
    "gluon_resnet50_v1s": dict(layers=(3, 4, 6, 3), stem_width=64, stem_type="deep"),
    "gluon_resnet101_v1s": dict(layers=(3, 4, 23, 3), stem_width=64, stem_type="deep"),
    "gluon_resnet152_v1s": dict(layers=(3, 8, 36, 3), stem_width=64, stem_type="deep"),
    "gluon_resnext50_32x4d": dict(layers=(3, 4, 6, 3), cardinality=32, base_width=4),
    "gluon_resnext101_32x4d": dict(layers=(3, 4, 23, 3), cardinality=32, base_width=4),
    "gluon_resnext101_64x4d": dict(layers=(3, 4, 23, 3), cardinality=64, base_width=4),
    "gluon_seresnext50_32x4d": dict(layers=(3, 4, 6, 3), cardinality=32, base_width=4,
                                    attn="se"),
    "gluon_seresnext101_32x4d": dict(layers=(3, 4, 23, 3), cardinality=32, base_width=4,
                                     attn="se"),
    "gluon_seresnext101_64x4d": dict(layers=(3, 4, 23, 3), cardinality=64, base_width=4,
                                     attn="se"),
    "gluon_senet154": dict(layers=(3, 8, 36, 3), cardinality=64, base_width=4,
                           stem_type="deep", down_kernel_size=3, block_reduce_first=2,
                           attn="se"),
}


def _register_timm_resnet(name: str, cfg: Dict[str, Any]) -> None:
    def builder(**kwargs):
        for k, v in cfg.items():
            kwargs.setdefault(k, v)
        return TimmResNet(**kwargs)

    builder.__name__ = name
    register_model(builder)


for _n, _cfg in _TIMM_RESNET_CFGS.items():
    _register_timm_resnet(_n, _cfg)


# The pruned ECA-ResNets (timm ``helpers.py:315-360``, the adapt tables of
# ``models/pruned/ecaresnet{50,101}d_pruned.txt``): per-block (conv1, conv2,
# out) widths; strides and stems as the 50d/101d plans.
_ECARESNET50D_PRUNED = (
    (47, 18, 19), (52, 22, 19), (64, 35, 19), (85, 37, 171),
    (107, 80, 171), (120, 85, 171), (125, 87, 171), (198, 126, 818),
    (255, 232, 818), (256, 233, 818), (253, 235, 818), (256, 225, 818),
    (256, 239, 818), (492, 237, 2022), (512, 500, 2022), (512, 490, 2022))
_ECARESNET101D_PRUNED = (
    (45, 25, 26), (53, 20, 26), (60, 27, 26), (81, 24, 142), (93, 49, 142),
    (102, 54, 142), (122, 78, 142), (101, 25, 278), (239, 160, 278),
    (234, 156, 278), (250, 176, 278), (253, 191, 278), (251, 175, 278),
    (230, 128, 278), (244, 154, 278), (244, 159, 278), (238, 97, 278),
    (244, 149, 278), (253, 181, 278), (245, 119, 278), (255, 216, 278),
    (256, 201, 278), (253, 149, 278), (254, 141, 278), (256, 190, 278),
    (256, 217, 278), (255, 156, 278), (256, 155, 278), (256, 232, 278),
    (256, 214, 278), (499, 289, 2042), (512, 512, 2042), (512, 502, 2042))

_register_timm_resnet("ecaresnet50d_pruned", dict(
    layers=(3, 4, 6, 3), attn="eca", stem_width=32, stem_type="deep", avg_down=True,
    block_overrides=_ECARESNET50D_PRUNED))
_register_timm_resnet("ecaresnet101d_pruned", dict(
    layers=(3, 4, 23, 3), attn="eca", stem_width=32, stem_type="deep", avg_down=True,
    block_overrides=_ECARESNET101D_PRUNED))
