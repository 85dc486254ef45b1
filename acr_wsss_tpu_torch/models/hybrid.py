"""ResNetV2 (3, 4, 9) stem of the R50+ViT-B/16 hybrid backbone.

Counterpart of ``acr_wsss_tpu/models/hybrid.py::{Bottleneck,
ResNetV2Stem}`` (``:33-58``, ``:111-147``): non-pre-activation bottlenecks
of weight-standardized 'SAME' convs and GroupNorm(32). For a 384 input:
7x7/2 stem conv and 3x3/2 max pool -> 96, stage 0 -> 96, stage 1 -> 48,
stage 2 -> 24. Module names follow the flax ones so the converter maps
paths one to one. ``s2d_stem`` computes the 7x7/2 stem conv as
space-to-depth and a folded 4x4/1 conv (``WSConvS2D``, ``:61-110``): the
same parameter and the same function.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from acr_wsss_tpu_torch.models.layers import GroupNormAct, WSConv, max_pool_same


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
