"""Shared layers of the port (counterpart of ``acr_wsss_tpu/models/layers.py``).

Convolutions run in NCHW, PyTorch's habit; the public model entry takes the
JAX package's NHWC image and transposes once. Parameters are float32; each
layer casts to the caller's compute dtype as the flax modules do.

``BatchNorm`` is flax's ``nn.BatchNorm`` as the CNN families configure it
(``acr_wsss_tpu/models/cnn.py:32-61``, ``resnet_timm.py:37-40``), not
PyTorch's: statistics in float32 and a float32 output; in training the
batch's mean and its *biased* variance (flax's E[x^2] - E[x]^2, clipped at
0) normalize, and the running statistics move as ``r = 0.9 r + 0.1 batch``
(flax's momentum 0.9; PyTorch's ``BatchNorm2d`` keeps the unbiased
variance, n / (n - 1) larger). In eval mode the running statistics
normalize. The buffers are ``mean`` and ``var``, flax's ``batch_stats``
names. flax's ``axis_name`` (the statistics averaged over a mesh axis,
SyncBatchNorm's counterpart) is not ported: ``check_bn_axis_name``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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
    """Weight-standardized conv, TF-'SAME' padded, or by ``padding`` pixels
    on every side (``layers.py:39-80``): the kernel is normalized per output
    channel with the population std, ``(w - mean) / (std + eps)``, eps
    1e-5. Initialized as ``nn.Conv2d``."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int,
                 stride: int = 1, eps: float = 1e-5, padding: Optional[int] = None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_chs, in_chs, kernel_size, kernel_size))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.stride = stride
        self.eps = eps
        self.padding = padding

    def standardized_weight(self) -> torch.Tensor:
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        std = w.std(dim=(1, 2, 3), keepdim=True, unbiased=False)
        return (w - mean) / (std + self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.standardized_weight()
        if self.padding is not None:
            return F.conv2d(x, w.to(x.dtype), stride=self.stride, padding=self.padding)
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


def check_bn_axis_name(bn_axis_name: Optional[str]) -> None:
    """Raise on a named BatchNorm axis: the batch statistics averaged across
    devices (flax ``axis_name``, SyncBatchNorm) are not ported; None is the
    one-device behaviour."""
    if bn_axis_name is not None:
        raise NotImplementedError(
            f"bn_axis_name={bn_axis_name!r}: statistics averaged over a mesh axis "
            "(SyncBatchNorm) are not ported; leave it None for per-device statistics")


# flax's BatchNorm momentum (the running average keeps 0.9 of itself) and
# epsilon, which every ported CNN family uses.
BN_MOMENTUM, BN_EPS = 0.9, 1e-5


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(momentum=BN_MOMENTUM, epsilon=BN_EPS,
    dtype=float32)`` over the channel axis 1 (the module docstring);
    ``training`` picks batch or running statistics, as flax's
    ``use_running_average=not train``."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            axes = [0] + list(range(2, x.dim()))
            mean = x.mean(dim=axes)
            var = (x.square().mean(dim=axes) - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                self.mean.mul_(BN_MOMENTUM).add_(mean.detach(), alpha=1 - BN_MOMENTUM)
                self.var.mul_(BN_MOMENTUM).add_(var.detach(), alpha=1 - BN_MOMENTUM)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


def conv2d(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` (its stride, padding and groups) in ``dtype``, input and
    weight cast to it: a flax Conv with that dtype."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias, layer.stride, layer.padding,
                    layer.dilation, layer.groups)


def classifier_head(x: torch.Tensor, fc: nn.Linear) -> torch.Tensor:
    """Global average pool in float32 and a float32 Dense (``layers.py:220``),
    the head every CNN family shares."""
    return fc(x.float().mean(dim=(2, 3)))


def make_divisible(v: float, divisor: int = 8, min_value: Optional[int] = None) -> int:
    """timm's channel rounding (``acr_wsss_tpu/models/effnet_builder.py:42``)."""
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v
