"""Auxiliary modules: counterpart of ``acr_wsss_tpu/models/extras.py``.

* :class:`ASPP` (``:21``): DeepLab's atrous spatial pyramid pooling
  (reference ``DPT/aspp.py``): four parallel atrous branches and a global
  pool branch, each conv -> GroupNorm(32) -> ReLU, a 1x1 merge, dropout.
* :class:`AttentionConv` (``:60``): stand-alone local self-attention as a
  conv (reference ``DPT/attention.py``): each pixel attends over its
  kernel_size x kernel_size window, the keys offset by learned relative
  position embeddings (``rel_h`` on the first half of the channels,
  ``rel_w`` on the second), a softmax per group of channels.

Both take and return NCHW maps, where the flax modules take NHWC. The
GroupNorms are flax's (float32, epsilon 1e-6); the parameters carry the
flax names (``aspp<i>``, ``norm<i>``, ``global_conv``, ``merge``;
``query``, ``key``, ``value``, ``rel_h``, ``rel_w`` in flax's shapes), so
``models/convert.py`` maps them one to one. ``AttentionConv``'s windows
come from ``F.unfold``, in the channel-major (channel, row, column) order
of ``conv_general_dilated_patches``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from acr_wsss_tpu_torch.models.layers import conv2d

FLAX_GN_EPS = 1e-6


def _gn_relu(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    return F.relu(F.group_norm(x.float(), norm.num_groups, norm.weight, norm.bias, norm.eps))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling; dilations (1, 6, 12, 18) at output
    stride 16 (the reference's ``build_aspp``). ``forward(x,
    deterministic=False)`` applies the dropout, as flax's
    ``deterministic``."""

    def __init__(self, in_chs: int, features: int = 256,
                 dilations: Sequence[int] = (1, 6, 12, 18), dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dilations, self.dropout, self.dtype = tuple(dilations), dropout, dtype
        for i, d in enumerate(self.dilations):
            k = 1 if d == 1 else 3
            self.add_module(f"aspp{i + 1}", nn.Conv2d(in_chs, features, k, padding=d * (k // 2),
                                                      dilation=d, bias=False))
            self.add_module(f"norm{i + 1}", nn.GroupNorm(32, features, eps=FLAX_GN_EPS))
        self.global_conv = nn.Conv2d(in_chs, features, 1, bias=False)
        self.global_norm = nn.GroupNorm(32, features, eps=FLAX_GN_EPS)
        self.merge = nn.Conv2d(features * (len(self.dilations) + 1), features, 1, bias=False)
        self.merge_norm = nn.GroupNorm(32, features, eps=FLAX_GN_EPS)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        branches = [_gn_relu(conv2d(x, getattr(self, f"aspp{i + 1}"), self.dtype),
                             getattr(self, f"norm{i + 1}"))
                    for i in range(len(self.dilations))]
        gap = conv2d(x.mean(dim=(2, 3), keepdim=True), self.global_conv, self.dtype)
        branches.append(_gn_relu(gap, self.global_norm).expand_as(branches[0]))
        h = _gn_relu(conv2d(torch.cat(branches, dim=1), self.merge, self.dtype),
                     self.merge_norm)
        return F.dropout(h, self.dropout, training=not deterministic and self.dropout > 0)


class AttentionConv(nn.Module):
    """Local window self-attention as a conv replacement: ``groups`` heads
    of ``out_channels / groups`` channels, each pixel's query against the
    keys and values of its padded kernel_size x kernel_size window."""

    def __init__(self, in_chs: int, out_channels: int, kernel_size: int = 7, groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k, oc = kernel_size, out_channels
        self.kernel_size, self.groups, self.dtype = k, groups, dtype
        self.query = nn.Conv2d(in_chs, oc, 1, bias=False)
        self.key = nn.Conv2d(in_chs, oc, 1, bias=False)
        self.value = nn.Conv2d(in_chs, oc, 1, bias=False)
        self.rel_h = nn.Parameter(torch.randn(1, 1, 1, k, 1, oc // 2))
        self.rel_w = nn.Parameter(torch.randn(1, 1, 1, 1, k, oc // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, g = self.kernel_size, self.groups
        b, _, h, w = x.shape
        q = conv2d(x, self.query, self.dtype)
        oc = q.shape[1]

        def windows(t):         # (B, oc, k * k, H, W), channel-major as JAX's patches
            return F.unfold(F.pad(t, (k // 2,) * 4), k).reshape(b, oc, k * k, h, w)

        kw = windows(conv2d(x, self.key, self.dtype))
        vw = windows(conv2d(x, self.value, self.dtype))
        half = oc // 2
        rel = torch.cat([self.rel_h[0, 0, 0].expand(k, k, half),
                         self.rel_w[0, 0, 0].expand(k, k, oc - half)], dim=-1)
        kw = kw + rel.reshape(k * k, oc).t().reshape(1, oc, k * k, 1, 1).to(kw.dtype)
        hd = oc // g
        logits = (q.reshape(b, g, hd, 1, h, w) * kw.reshape(b, g, hd, k * k, h, w)).sum(dim=2)
        attn = torch.softmax(logits, dim=2)
        out = (attn.unsqueeze(2) * vw.reshape(b, g, hd, k * k, h, w)).sum(dim=3)
        return out.reshape(b, oc, h, w)
