"""Vision Transformer trunk that returns its attention probabilities.

Counterpart of ``acr_wsss_tpu/models/vit.py`` (``:77-517``): the trunk
returns the token taps (block outputs before the final norm) and each
block's exported probabilities, and takes an optional stack of
``probs_offsets``, the post-softmax gradient taps GETAM differentiates.

Truncated taps (``:438-451``): ``probs_offsets`` may cover only the last
layers. Blocks below the first tapped layer take no offset, so no backward
is ever built through them; with ``attn_impl="kernel"`` their attention is
the CUDA forward of ``ops/attn_cuda.py`` (export "mean" or "none"), and
they run under ``torch.no_grad()`` when taps are given. Tapped blocks take
the plain attention with the offset. Without taps the kernel path takes a
gradient through the backward kernel (training).

``probs_dtype`` (``:137``) is the dtype of the kernel path's head-mean
export; the plain path exports float32, as JAX's ``xla`` branch does. The
stack of the layers' exports has JAX's dtype (``jnp.stack`` promotes): a
bf16 stack when every layer is bf16, float32 when the tapped layers'
plain exports join bf16 ones.

Training (``:351-390``, ``:97-112``): ``mirror_second_half`` un-mirrors the
flipped view's patch tokens once, after the pos-embed, so that every
layer's probs come out index-aligned with the first view's; ``True`` for
views stacked on the batch axis (rows [b:2b] mirror rows [0:b]),
``"interleaved"`` for (view, mirror) pairs on adjacent rows. Export
``"pair_l1"`` (kernel impl, no offsets) runs the pair-consistency entry
of ``ops/attn_pair.py`` on interleaved pairs and returns each layer's
per-pair L1 sums as ``consistency_sums``.

The classifiers' fields (``:261-310``, ``models/vit_classifier.py``):
``qkv_bias`` (False for ``vit_small_patch16_224`` and the MIIL names),
``hybrid_patch_size`` (the patchify over a stem's map, any stage plan of
``models/hybrid.ResNetV2Stem`` including the bare stem) and the
``pre_norm_tokens`` output. Under ``attn_impl="kernel"`` a head dim the
forward kernel does not take raises at construction (``attn_cuda.
check_head_dim``); there is no fallback to plain.

Tensor parallelism (``parallel/sharding.apply_tensor_parallel``, the
mesh's ``model`` axis): a block whose ``tp_group`` is set holds the rows
of its H / M heads in ``attn.qkv`` and its share of the MLP's hidden
units, and runs them between ``copy_to_model`` and ``reduce_from_model``;
``proj`` and ``fc2`` add their bias once, after the reduction. Its
head-mean export is the mean over its own heads, times (H / M) / H, summed
over the model ranks: every rank holds the full head mean, and the
export's cotangent reaches each rank's backward (K1b on the kernel path)
as it is. Only exports "mean" and "none" without a probs offset run
under the axis.

``scan_blocks``, remat and the bkg token of the JAX trunk are not part of
this module.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from acr_wsss_tpu_torch.models.layers import Mlp, linear, resize_bilinear
from acr_wsss_tpu_torch.ops.attention import attention_with_probs
from acr_wsss_tpu_torch.ops.attn_cuda import check_head_dim, fused_attention_qkv_cols
from acr_wsss_tpu_torch.ops.attn_pair import fused_attention_pair_consistency
from acr_wsss_tpu_torch.parallel.sharding import copy_to_model, reduce_from_model

ATTN_IMPLS = ("kernel", "plain")


def stack_probs(probs_list) -> Optional[torch.Tensor]:
    """(B, L, ...) stack of the layers' exports in the dtype ``jnp.stack``
    gives: theirs when they agree, else float32 (bf16 kernel exports below
    the float32 plain exports of tapped layers)."""
    if not probs_list:
        return None
    if len({p.dtype for p in probs_list}) > 1:
        probs_list = [p.float() for p in probs_list]
    return torch.stack(probs_list, dim=1)


class Attention(nn.Module):
    """``attn_impl="kernel"`` raises at construction on a head dim the
    forward kernel does not take (``attn_cuda.FWD_HEAD_DIMS``)."""

    def __init__(self, dim: int, num_heads: int, attn_impl: str = "kernel",
                 probs_dtype: torch.dtype = torch.float32, qkv_bias: bool = True):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
        if attn_impl == "kernel":
            check_head_dim(dim // num_heads)
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.attn_impl = attn_impl
        self.probs_dtype = probs_dtype
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.tp_group, self.tp_size = None, 1

    def forward(self, x: torch.Tensor, probs_offset: Optional[torch.Tensor] = None,
                export: str = "mean") -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        B, N, _ = x.shape
        if self.tp_group is not None:
            if probs_offset is not None or export not in ("mean", "none"):
                raise ValueError("under a model axis the attention takes export 'mean' or "
                                 f"'none' and no probs_offset, got export={export!r}")
            x = copy_to_model(x, self.tp_group)
        qkv = linear(x, self.qkv)
        if export == "pair_l1":
            if self.attn_impl != "kernel" or probs_offset is not None:
                raise ValueError("export='pair_l1' needs attn_impl='kernel' and no "
                                 "probs_offset (training-only fused consistency)")
            out, cls_s, aff_s = fused_attention_pair_consistency(qkv, self.scale,
                                                                 self.num_heads)
            return linear(out, self.proj), (cls_s, aff_s)
        if (self.attn_impl == "kernel" and probs_offset is None
                and export in ("mean", "none")):
            out, probs = fused_attention_qkv_cols(qkv, self.scale, self.num_heads,
                                                  export=export, probs_dtype=self.probs_dtype)
        else:
            q, k, v = qkv.reshape(B, N, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
            out, probs = attention_with_probs(q, k, v, self.scale,
                                              probs_offset=probs_offset, export=export)
            out = out.transpose(1, 2).reshape(B, N, -1)
        if self.tp_group is None:
            return linear(out, self.proj), probs
        if probs is not None:
            probs = reduce_from_model(probs * (1.0 / self.tp_size), self.tp_group).to(probs.dtype)
        return row_parallel(out, self.proj, self.tp_group), probs


def row_parallel(x: torch.Tensor, layer: nn.Linear, group) -> torch.Tensor:
    """``layer`` on ``x``'s share of its input columns (a model axis): the
    partial products summed over ``group`` in float32, the bias added
    once, one rounding to ``x``'s dtype."""
    y = reduce_from_model(F.linear(x, layer.weight.to(x.dtype)), group)
    return (y + layer.bias.float()).to(x.dtype)


class Block(nn.Module):
    """Pre-norm block; the LayerNorms run in float32 (``vit.py:138-150``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 attn_impl: str = "kernel", probs_dtype: torch.dtype = torch.float32,
                 qkv_bias: bool = True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, attn_impl, probs_dtype, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.tp_group = None

    def forward(self, x, probs_offset=None, export="mean"):
        h, probs = self.attn(self.norm1(x.float()).to(x.dtype), probs_offset, export)
        x = x + h
        y = self.norm2(x.float()).to(x.dtype)
        if self.tp_group is None:
            return x + self.mlp(y), probs
        y = F.gelu(linear(copy_to_model(y, self.tp_group), self.mlp.fc1), approximate="none")
        return x + row_parallel(y, self.mlp.fc2, self.tp_group), probs


class PatchEmbed(nn.Module):
    """Conv patchifier; a 1x1 conv over the stem's map for the hybrid."""

    def __init__(self, in_chs: int, embed_dim: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chs, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # NCHW -> (B, N, D)
        w, b = self.proj.weight.to(x.dtype), self.proj.bias.to(x.dtype)
        y = F.conv2d(x, w, b, stride=self.proj.stride)
        return y.flatten(2).transpose(1, 2)


def resize_pos_embed(pos_embed: torch.Tensor, start_index: int,
                     gs_new: Tuple[int, int]) -> torch.Tensor:
    """Bilinear (half-pixel) resize of the grid part of the position
    embedding to the current patch grid (``vit.py:235-247``)."""
    tok, grid = pos_embed[:, :start_index], pos_embed[0, start_index:]
    gs_old = int(round(grid.shape[0] ** 0.5))
    if (gs_old, gs_old) == tuple(gs_new):
        return pos_embed
    grid = resize_bilinear(grid.reshape(gs_old, gs_old, -1), gs_new)
    return torch.cat([tok, grid.reshape(1, gs_new[0] * gs_new[1], -1)], dim=1)


class VisionTransformer(nn.Module):
    """ViT trunk; with ``backbone`` (a ResNetV2 stem) it is the hybrid, whose
    patch embedding is a ``hybrid_patch_size`` conv over the stem's map
    (``vit.py:310``); ``patch_size`` is then the total stride, the grid's
    divisor."""

    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, patch_size: int = 16,
                 pretrain_grid: int = 24, num_prefix_tokens: int = 1,
                 taps: Tuple[int, ...] = (2, 5, 8, 11),
                 backbone: Optional[nn.Module] = None,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "kernel",
                 probs_dtype: torch.dtype = torch.float32, qkv_bias: bool = True,
                 hybrid_patch_size: int = 1):
        super().__init__()
        self.depth = depth
        self.num_heads = num_heads
        self.patch_size = patch_size
        self.num_prefix_tokens = num_prefix_tokens
        self.taps = tuple(taps)
        self.dtype = dtype
        self.backbone = backbone
        if backbone is not None:
            self.patch_embed = PatchEmbed(backbone.num_features, embed_dim, hybrid_patch_size)
        else:
            self.patch_embed = PatchEmbed(3, embed_dim, patch_size)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, pretrain_grid * pretrain_grid + num_prefix_tokens, embed_dim))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        if num_prefix_tokens == 2:
            self.dist_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.blocks = nn.ModuleList(
            [Block(embed_dim, num_heads, mlp_ratio, attn_impl, probs_dtype, qkv_bias)
             for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor, probs_offsets: Optional[torch.Tensor] = None,
                export: str = "mean", mirror_second_half=False) -> Dict[str, Any]:
        """x: (B, H, W, 3) NHWC image. ``probs_offsets``: (L', B, heads, N, N)
        taps for the last L' blocks. Returns taps, probs (B, L, N, N) or
        (B, L, heads, N, N) and per layer (``probs_layers``), or the per-layer
        ``consistency_sums`` for export "pair_l1", the final-norm tokens
        (float32) and the tokens before it (``pre_norm_tokens``), ``n_tokens``
        and the hybrid stem's NCHW stage maps (``stem_features``: "stage0"..,
        None without a stem)."""
        B, H, W, _ = x.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        stem_features = None
        if self.backbone is not None:
            x, stem_features = self.backbone(x)
        x = self.patch_embed(x)
        prefix = [self.cls_token.expand(B, -1, -1)]
        if self.num_prefix_tokens == 2:
            prefix.append(self.dist_token.expand(B, -1, -1))
        x = torch.cat([p.to(x.dtype) for p in prefix] + [x], dim=1)
        pe = resize_pos_embed(self.pos_embed, self.num_prefix_tokens, (gh, gw))
        x = x + pe.to(x.dtype)
        if mirror_second_half:
            x = self._unmirror(x, (gh, gw), mirror_second_half)

        off_start = self.depth - (probs_offsets.shape[0] if probs_offsets is not None else 0)
        taps: Dict[int, torch.Tensor] = {}
        probs_list = []
        for i, block in enumerate(self.blocks):
            tapped = probs_offsets is not None and i >= off_start
            # Untapped blocks below a tapped one never need a graph.
            ctx = (torch.no_grad() if probs_offsets is not None and not tapped
                   else contextlib.nullcontext())
            with ctx:
                x, probs_i = block(x, probs_offsets[i - off_start] if tapped else None,
                                   export)
            if probs_i is not None:
                probs_list.append(probs_i)
            if i in self.taps:
                taps[i] = x
        out = {"taps": taps, "tokens": self.norm(x.float()), "pre_norm_tokens": x,
               "grid": (gh, gw),
               "n_tokens": x.shape[1], "stem_features": stem_features}
        if export == "pair_l1":
            out["consistency_sums"] = tuple(probs_list)
        else:
            out["probs"] = stack_probs(probs_list)
            out["probs_layers"] = tuple(probs_list) if probs_list else None
        return out

    def _unmirror(self, x: torch.Tensor, grid: Tuple[int, int], mode) -> torch.Tensor:
        """Reverse the patch-grid columns of the mirror rows' patch tokens:
        rows [b:2b] for ``True``, the odd rows for ``"interleaved"``."""
        if x.shape[0] % 2:
            raise ValueError("mirror_second_half expects views stacked on the batch "
                             f"axis (even batch), got {x.shape[0]}")
        b2, n, dim = x.shape[0] // 2, x.shape[1], x.shape[2]
        start = self.num_prefix_tokens

        def unflip(t):
            return torch.flip(t.reshape(-1, grid[0], grid[1], dim), dims=(2,)).reshape(
                -1, grid[0] * grid[1], dim)

        if mode == "interleaved":
            xp = x.reshape(b2, 2, n, dim)
            mirror = torch.cat([xp[:, 1, :start], unflip(xp[:, 1, start:])], dim=1)
            return torch.stack([xp[:, 0], mirror], dim=1).reshape(-1, n, dim)
        mirror = torch.cat([x[b2:, :start], unflip(x[b2:, start:])], dim=1)
        return torch.cat([x[:b2], mirror], dim=0)
