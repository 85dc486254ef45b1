"""Swin Transformer that returns its window-attention probabilities.

Counterpart of ``acr_wsss_tpu/models/swin.py``: ``window_partition`` /
``window_reverse`` (``:29-40``), ``relative_position_index`` (``:43``),
``WindowAttention`` (``:52``), ``SwinBlock`` (``:96``, pad, roll and the
shift mask), ``shift_mask`` (``:147``), ``PatchMerging`` (``:164``, odd
grids padded) and ``SwinTransformer`` (``:186``), whose forward returns
``logits``, ``window_probs`` (per block, (B, nW, ws^2, ws^2) head means
for export "mean", (B, nW, heads, ws^2, ws^2) for "full"), the NHWC
``stage_features`` and the last ``grid``; and the builders of the
registry names (``:238-304``). No attention kernel of the port takes the
window logits' bias and mask, and JAX computes them outside any Pallas
kernel, so this module is plain torch.

Dtypes as JAX's: the residual stream in the compute dtype after
``embed_norm``; LayerNorms in float32; the window logits a float32
product of the compute-dtype q and k, the bias and the mask added and the
softmax taken in float32, the probabilities cast to v's dtype for the
output product; the head in float32 on the float32 pooled features.

The JAX module takes the shapes of its window tables from the input at
init; this one from ``img_size`` at construction: each block's window is
``min(window_size, grid)`` at the grid ``img_size`` gives it. A forward at
another grid that changes a block's window raises.

Same bits from run to run on the card: the gather of the bias table
(``:78``) repeats indices, and CUDA's backward of a gather adds with
atomics, in an order that changes between launches. ``_TableGather``
sums each table row's cotangents in a fixed order instead. The patch
embedding (stride = kernel) is a product of the image's patches with the
conv weight, whose backward is a matrix product too; cuDNN's weight
gradient may take an algorithm that adds with atomics.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from acr_wsss_tpu_torch.models.layers import Mlp, linear
from acr_wsss_tpu_torch.models.registry import register_model


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, ws, ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    B = windows.shape[0] // (H * W // ws // ws)
    x = windows.reshape(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws^2, ws^2) row of the bias table for each pair of window tokens."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def shift_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws^2, ws^2) float32: -100 between tokens of a shifted window
    that come from different regions of the rolled map, else 0."""
    img_mask = np.zeros((H, W), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wsl] = cnt
            cnt += 1
    windows = img_mask.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3).reshape(
        -1, ws * ws)
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _table_groups(index: np.ndarray, rows: int) -> np.ndarray:
    """(rows, most) positions in ``index`` of each table row, ascending,
    padded with ``len(index)`` (a zero row of the padded cotangent)."""
    order = np.argsort(index, kind="stable")
    counts = np.bincount(index, minlength=rows)
    starts = np.cumsum(counts) - counts
    groups = np.full((rows, counts.max()), index.size, np.int64)
    groups[index[order], np.arange(index.size) - starts[index[order]]] = order
    return groups


class _TableGather(torch.autograd.Function):
    """``table[index]`` whose backward adds each row's cotangents in a fixed
    order (a gather and a sum over ``groups``), not by atomics."""

    @staticmethod
    def forward(ctx, table, index, groups):
        ctx.save_for_backward(groups)
        return table[index]

    @staticmethod
    def backward(ctx, grad):
        groups, = ctx.saved_tensors
        padded = torch.cat([grad, grad.new_zeros(1, grad.shape[1])])
        return padded[groups].sum(1), None, None


class WindowAttention(nn.Module):
    """Multi-head attention within windows, with the relative-position bias
    and an optional shift mask; returns (out, exported probs)."""

    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        rows = (2 * window_size - 1) ** 2
        self.relative_position_bias_table = nn.Parameter(torch.zeros(rows, num_heads))
        index = relative_position_index(window_size).reshape(-1)
        self.register_buffer("relative_position_index", torch.from_numpy(index),
                             persistent=False)
        self.register_buffer("table_groups", torch.from_numpy(_table_groups(index, rows)),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                export: str = "mean") -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        Bn, N, C = x.shape
        q, k, v = linear(x, self.qkv).reshape(Bn, N, 3, self.num_heads, -1).permute(
            2, 0, 3, 1, 4).unbind(0)
        logits = torch.matmul(q.float(), k.float().transpose(-2, -1)) * self.scale
        bias = _TableGather.apply(self.relative_position_bias_table,
                                  self.relative_position_index, self.table_groups)
        logits = logits + bias.reshape(N, N, -1).permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            logits = (logits.reshape(Bn // nW, nW, self.num_heads, N, N)
                      + mask[None, :, None]).reshape(Bn, self.num_heads, N, N)
        probs = torch.softmax(logits, dim=-1)
        out = torch.matmul(probs.to(v.dtype), v).transpose(1, 2).reshape(Bn, N, C)
        exported = probs.mean(1) if export == "mean" else (probs if export == "full" else None)
        return linear(out, self.proj), exported


class SwinBlock(nn.Module):
    """LayerNorm, (shifted) window attention, LayerNorm, MLP; built for the
    token grid ``grid``, which sets its window (``min(window_size, grid)``)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, grid: Tuple[int, int] = (56, 56)):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, min(window_size, *grid))
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self._masks: Dict[Tuple[Any, ...], torch.Tensor] = {}

    def _mask(self, Hp: int, Wp: int, ws: int, shift: int, device) -> torch.Tensor:
        key = (Hp, Wp, ws, shift, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(shift_mask(Hp, Wp, ws, shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor, grid: Tuple[int, int], export: str = "mean"
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        H, W = grid
        B, N, C = x.shape
        ws = min(self.window_size, H, W)
        if ws != self.attn.window_size:
            raise ValueError(f"grid {H}x{W} gives window {ws}; the block was built for "
                             f"window {self.attn.window_size} (img_size)")
        shift = self.shift_size if ws < min(H, W) else 0

        h = self.norm1(x.float()).reshape(B, H, W, C)
        pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
        if pad_h or pad_w:
            h = F.pad(h, (0, 0, 0, pad_w, 0, pad_h))
        Hp, Wp = H + pad_h, W + pad_w
        mask = None
        if shift > 0:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
            mask = self._mask(Hp, Wp, ws, shift, x.device)
        windows = window_partition(h.to(x.dtype), ws).reshape(-1, ws * ws, C)
        attn_out, probs = self.attn(windows, mask, export)
        h = window_reverse(attn_out.reshape(-1, ws, ws, C), ws, Hp, Wp)
        if shift > 0:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        x = x + h[:, :H, :W].reshape(B, N, C)
        x = x + self.mlp(self.norm2(x.float()).to(x.dtype))
        if probs is not None:
            probs = probs.reshape((B, -1) + probs.shape[1:])
        return x, probs


class PatchMerging(nn.Module):
    """2x2 neighbourhoods concatenated (odd grids padded), LayerNorm, and a
    Dense to twice the width."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, grid: Tuple[int, int]
                ) -> Tuple[torch.Tensor, Tuple[int, int]]:
        H, W = grid
        B, N, C = x.shape
        x = x.reshape(B, H, W, C)
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
            H, W = H + H % 2, W + W % 2
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1).reshape(B, (H // 2) * (W // 2), 4 * C)
        return linear(self.norm(x.float()).to(x.dtype), self.reduction), (H // 2, W // 2)


class SwinTransformer(nn.Module):
    """Swin trunk and classifier with per-block window-attention export.
    Input: an NHWC image of ``img_size``."""

    def __init__(self, num_classes: int = 20, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, patch_size: int = 4, mlp_ratio: float = 4.0,
                 img_size: Union[int, Tuple[int, int]] = 224,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.num_heads = tuple(num_heads)
        self.window_size = window_size
        self.patch_size = patch_size
        self.dtype = dtype
        h, w = (img_size, img_size) if isinstance(img_size, int) else img_size
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.embed_norm = nn.LayerNorm(embed_dim, eps=1e-5)
        grid, dim = (h // patch_size, w // patch_size), embed_dim
        for si, (depth, heads) in enumerate(zip(self.depths, self.num_heads)):
            for bi in range(depth):
                setattr(self, f"stage{si}_block{bi}", SwinBlock(
                    dim, heads, window_size, 0 if bi % 2 == 0 else window_size // 2,
                    mlp_ratio, grid))
            if si < len(self.depths) - 1:
                setattr(self, f"merge{si}", PatchMerging(dim))
                grid, dim = ((grid[0] + 1) // 2, (grid[1] + 1) // 2), dim * 2
        self.num_features = dim
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.head = nn.Linear(dim, num_classes)

    def _patchify(self, x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """The stride-p conv (VALID) as patches (B, gh*gw, p*p*3) times the
        weight, in the compute dtype."""
        B, H, W, C = x.shape
        p = self.patch_size
        gh, gw = H // p, W // p
        patches = x[:, :gh * p, :gw * p].to(self.dtype).reshape(B, gh, p, gw, p, C).permute(
            0, 1, 3, 2, 4, 5).reshape(B, gh * gw, p * p * C)
        weight = self.patch_embed.weight.permute(0, 2, 3, 1).reshape(self.embed_dim, -1)
        return F.linear(patches, weight.to(self.dtype),
                        self.patch_embed.bias.to(self.dtype)), (gh, gw)

    def forward(self, x: torch.Tensor, export: str = "mean") -> Dict[str, Any]:
        B = x.shape[0]
        x, grid = self._patchify(x)
        x = self.embed_norm(x.float()).to(self.dtype)
        dim = self.embed_dim
        probs_all: List[torch.Tensor] = []
        stage_feats: List[torch.Tensor] = []
        for si, depth in enumerate(self.depths):
            for bi in range(depth):
                x, probs = getattr(self, f"stage{si}_block{bi}")(x, grid, export)
                if probs is not None:
                    probs_all.append(probs)
            stage_feats.append(x.reshape(B, grid[0], grid[1], dim))
            if si < len(self.depths) - 1:
                x, grid = getattr(self, f"merge{si}")(x, grid)
                dim *= 2
        pooled = self.norm(x.float()).mean(dim=1)
        return {"logits": self.head(pooled), "window_probs": probs_all,
                "stage_features": stage_feats, "grid": grid}


@register_model
def swin_tiny(**kwargs):
    return SwinTransformer(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                           **kwargs)


@register_model
def swin_small(**kwargs):
    return SwinTransformer(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24),
                           **kwargs)


@register_model
def swin_base_384(**kwargs):
    kwargs.setdefault("img_size", 384)
    return SwinTransformer(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                           window_size=12, **kwargs)


@register_model
def swin_large_384(**kwargs):
    kwargs.setdefault("window_size", 12)
    kwargs.setdefault("img_size", 384)
    return SwinTransformer(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
                           **kwargs)


# timm registry names (JAX ``swin.py:268-304``): the classifiers at 1000
# classes, the _in22k releases at 21841; built for their input size.
_SWIN_CFGS = {
    "swin_tiny_patch4_window7_224": dict(
        embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), window_size=7),
    "swin_small_patch4_window7_224": dict(
        embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24), window_size=7),
    "swin_base_patch4_window7_224": dict(
        embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window_size=7),
    "swin_base_patch4_window12_384": dict(
        embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window_size=12),
    "swin_large_patch4_window7_224": dict(
        embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48), window_size=7),
    "swin_large_patch4_window12_384": dict(
        embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48), window_size=12),
}


def _register_swin(name: str, num_classes: int = 1000, **cfg) -> None:
    def builder(**kwargs):
        kwargs.setdefault("num_classes", num_classes)
        for k, v in cfg.items():
            kwargs.setdefault(k, v)
        return SwinTransformer(**kwargs)

    builder.__name__ = name
    register_model(builder)


for _name, _cfg in _SWIN_CFGS.items():
    _cfg = dict(_cfg, img_size=int(_name[-3:]))
    _register_swin(_name, **_cfg)
    if "tiny" not in _name and "small" not in _name:
        _register_swin(f"{_name}_in22k", num_classes=21841, **_cfg)
