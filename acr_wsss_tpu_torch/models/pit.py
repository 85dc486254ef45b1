"""PiT, the pooling-based Vision Transformer, with attention export.

Counterpart of ``acr_wsss_tpu/models/pit.py``: ``ConvPool`` (``:26``, a
depthwise 3x3 stride-2 conv with channel multiplier 2 over the spatial
tokens and a Dense for the class tokens) and ``PoolingVisionTransformer``
(``:45``): a conv patch embedding, three stages of the port's
``models/vit.py::Block`` separated by pooling, an optional distillation
token (``distilled``: the head and ``head_dist`` averaged). The forward
returns ``probs_per_block`` (per block, (B, N_stage, N_stage) head means
for export "mean"), ``logits``, ``grid``, and with ``distilled`` also
``head_logits`` and ``dist_logits``.

``attn_impl`` is the blocks': "kernel" (every name's default) runs the
forward with the head-mean export of ``ops/attn_cuda.py`` (K1f) on the
card, at the names' head dims 64 (``pit_b``), 48 (``pit_s``, ``pit_xs``)
and 32 (``pit_ti``); a head dim the kernel does not take raises at
construction. "plain" is PyTorch. The JAX blocks run XLA (``Block``'s
default).

The position embedding is (1, gh, gw, C), as flax stores it, for the grid
of ``img_size``; JAX takes that grid from the input at init.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from acr_wsss_tpu_torch.models.layers import linear
from acr_wsss_tpu_torch.models.registry import register_model
from acr_wsss_tpu_torch.models.vit import Block


class ConvPool(nn.Module):
    """Depthwise stride-2 conv over the spatial tokens + Dense for cls."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.conv = nn.Conv2d(in_dim, out_dim, 3, stride=2, padding=1, groups=in_dim)
        self.fc = nn.Linear(in_dim, out_dim)

    def forward(self, x: torch.Tensor, cls: torch.Tensor, grid: Tuple[int, int]
                ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, int]]:
        H, W = grid
        B, N, C = x.shape
        spatial = x.reshape(B, H, W, C).permute(0, 3, 1, 2)
        y = F.conv2d(spatial, self.conv.weight.to(x.dtype), self.conv.bias.to(x.dtype),
                     stride=2, padding=1, groups=C)
        return y.flatten(2).transpose(1, 2), linear(cls, self.fc), tuple(y.shape[-2:])


class PoolingVisionTransformer(nn.Module):
    """Input: an NHWC image of ``img_size``."""

    def __init__(self, num_classes: int = 20, patch_size: int = 14, stride: int = 7,
                 base_dims: Sequence[int] = (64, 64, 64), depths: Sequence[int] = (3, 6, 4),
                 heads: Sequence[int] = (4, 8, 16), mlp_ratio: float = 4.0,
                 distilled: bool = False, img_size: Union[int, Tuple[int, int]] = 224,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "kernel"):
        super().__init__()
        self.depths = tuple(depths)
        self.distilled = distilled
        self.num_tokens = 2 if distilled else 1
        self.dtype = dtype
        h, w = (img_size, img_size) if isinstance(img_size, int) else img_size
        dims = [bd * nh for bd, nh in zip(base_dims, heads)]
        self.patch_embed = nn.Conv2d(3, dims[0], patch_size, stride=stride)
        self.grid = ((h - patch_size) // stride + 1, (w - patch_size) // stride + 1)
        self.pos_embed = nn.Parameter(torch.zeros(1, *self.grid, dims[0]))
        self.cls_token = nn.Parameter(torch.zeros(1, self.num_tokens, dims[0]))
        for si, (dim, depth, nh) in enumerate(zip(dims, self.depths, heads)):
            if si > 0:
                setattr(self, f"pool{si}", ConvPool(dims[si - 1], dim))
            for bi in range(depth):
                setattr(self, f"stage{si}_block{bi}", Block(dim, nh, mlp_ratio, attn_impl))
        self.norm = nn.LayerNorm(dims[-1], eps=1e-6)
        self.head = nn.Linear(dims[-1], num_classes)
        if distilled:
            self.head_dist = nn.Linear(dims[-1], num_classes)

    def forward(self, x: torch.Tensor, export: str = "mean") -> Dict[str, Any]:
        B = x.shape[0]
        w, b = self.patch_embed.weight.to(self.dtype), self.patch_embed.bias.to(self.dtype)
        x = F.conv2d(x.permute(0, 3, 1, 2).to(self.dtype), w, b,
                     stride=self.patch_embed.stride).permute(0, 2, 3, 1)
        if tuple(x.shape[1:3]) != self.grid:
            raise ValueError(f"patch grid {tuple(x.shape[1:3])}; the position embedding "
                             f"is for {self.grid} (img_size)")
        grid = self.grid
        x = (x + self.pos_embed.to(x.dtype)).reshape(B, grid[0] * grid[1], -1)
        cls = self.cls_token.expand(B, -1, -1).to(x.dtype)
        probs_all: List[torch.Tensor] = []
        for si, depth in enumerate(self.depths):
            if si > 0:
                x, cls, grid = getattr(self, f"pool{si}")(x, cls, grid)
            tokens = torch.cat([cls, x], dim=1)
            for bi in range(depth):
                tokens, probs = getattr(self, f"stage{si}_block{bi}")(tokens, None, export)
                if probs is not None:
                    probs_all.append(probs)
            cls, x = tokens[:, :self.num_tokens], tokens[:, self.num_tokens:]
        cls = self.norm(cls.float())
        logits = self.head(cls[:, 0])
        out: Dict[str, Any] = {"probs_per_block": probs_all, "grid": grid}
        if self.distilled:
            dist_logits = self.head_dist(cls[:, 1])
            out["head_logits"], out["dist_logits"] = logits, dist_logits
            logits = (logits + dist_logits) / 2
        out["logits"] = logits
        return out


@register_model
def pit_b(**kwargs):
    return PoolingVisionTransformer(patch_size=14, stride=7, base_dims=(64, 64, 64),
                                    depths=(3, 6, 4), heads=(4, 8, 16), **kwargs)


@register_model
def pit_s(**kwargs):
    return PoolingVisionTransformer(patch_size=16, stride=8, base_dims=(48, 48, 48),
                                    depths=(2, 6, 4), heads=(3, 6, 12), **kwargs)


# timm registry names (JAX ``pit.py:134-158``): the _224 classifiers (1000
# classes) and the distilled releases.
_PIT_CFGS = {
    "pit_b_224": dict(patch_size=14, stride=7, base_dims=(64, 64, 64), depths=(3, 6, 4),
                      heads=(4, 8, 16)),
    "pit_s_224": dict(patch_size=16, stride=8, base_dims=(48, 48, 48), depths=(2, 6, 4),
                      heads=(3, 6, 12)),
    "pit_xs_224": dict(patch_size=16, stride=8, base_dims=(48, 48, 48), depths=(2, 6, 4),
                       heads=(2, 4, 8)),
    "pit_ti_224": dict(patch_size=16, stride=8, base_dims=(32, 32, 32), depths=(2, 6, 4),
                       heads=(2, 4, 8)),
}


def _register_pit(name: str, distilled: bool = False, **cfg) -> None:
    def builder(**kwargs):
        kwargs.setdefault("num_classes", 1000)
        if distilled:
            kwargs.setdefault("distilled", True)
        for k, v in cfg.items():
            kwargs.setdefault(k, v)
        return PoolingVisionTransformer(**kwargs)

    builder.__name__ = name
    register_model(builder)


for _name, _cfg in _PIT_CFGS.items():
    _register_pit(_name, **_cfg)
    _register_pit(f"{_name[:-4]}_distilled_224", distilled=True, **_cfg)
