"""Shared layers of the port (counterpart of ``acr_wsss_tpu/models/layers.py``).

Convolutions run in NCHW, PyTorch's habit; the public model entry takes the
JAX package's NHWC image and transposes once. Parameters are float32; each
layer casts to the caller's compute dtype as the flax modules do.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF 'SAME' padding: out = ceil(size / stride), the odd pixel goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int,
             value: float = 0.0) -> torch.Tensor:
    top, bottom = _same_pads(x.shape[-2], kernel, stride)
    left, right = _same_pads(x.shape[-1], kernel, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class WSConv(nn.Module):
    """Weight-standardized conv, TF-'SAME' padded (``layers.py:39-80``):
    the kernel is normalized per output channel with the population std,
    ``(w - mean) / (std + eps)``, eps 1e-5."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int,
                 stride: int = 1, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_chs, in_chs, kernel_size, kernel_size))
        self.stride = stride
        self.eps = eps

    def standardized_weight(self) -> torch.Tensor:
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        std = w.std(dim=(1, 2, 3), keepdim=True, unbiased=False)
        return (w - mean) / (std + self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.standardized_weight()
        x = pad_same(x, w.shape[-1], self.stride)
        return F.conv2d(x, w.to(x.dtype), stride=self.stride)


class GroupNormAct(nn.Module):
    """GroupNorm(32, eps 1e-5) + optional ReLU, computed in float32 and
    returned in the input's dtype (``layers.py:83-105``)."""

    def __init__(self, channels: int, num_groups: int = 32,
                 apply_act: bool = True, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.num_groups = num_groups
        self.apply_act = apply_act
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                         self.eps)
        if self.apply_act:
            y = F.relu(y)
        return y.to(x.dtype)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` applied in ``x``'s dtype, as a flax Dense with that dtype."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


class Mlp(nn.Module):
    """Dense -> exact (erf) GELU -> Dense (``layers.py:108-127``)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(F.gelu(linear(x, self.fc1), approximate="none"), self.fc2)


def max_pool_same(x: torch.Tensor, window: int = 3, stride: int = 2) -> torch.Tensor:
    """Max pool with TF 'SAME' padding (``layers.py:145``); pads with -inf."""
    x = pad_same(x, window, stride, value=-math.inf)
    return F.max_pool2d(x, window, stride)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C), no antialiasing (``layers.py:156-190``):
    half-pixel centres, or corner-anchored with ``align_corners``."""
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    y = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=tuple(size), mode="bilinear",
                      align_corners=align_corners, antialias=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, *size, c)
