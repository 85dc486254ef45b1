"""Attention over interleaved (view, mirror) pairs with the ACR consistency
L1 sums computed in the kernel, forward and backward as CUDA kernels.

Counterpart of ``acr_wsss_tpu/ops/attn_pallas.py::
fused_attention_pair_consistency`` (``:1241-1260``): its forward runs the
TPU kernel ``_fwd_kernel_pair`` (``:1028-1072``), here
``csrc/attn_pair_fwd.cu`` (K2f); its custom VJP runs ``_bwd_kernel_pair``
(``:1075-1111``), here ``csrc/attn_bwd.cu`` with the sign tile (K2b).

The batch interleaves the views: rows [2i, 2i+1] are (view, mirror) of
pair i, the mirror's patch tokens already un-flipped (the trunk's
``mirror_second_half="interleaved"``), so the pairing is positional. With
delta = mean_h p(2i) - mean_h p(2i+1) (``_pair_masks``, ``:1019-1025``):

  cls_sums[i] = sum |delta| over row 0, columns [1, N)
  aff_sums[i] = sum |delta| over rows and columns [1, N)

The forward also keeps sign(delta) on those entries (int8, sign(0) = 0,
the subgradient of |.| at 0 that XLA takes) for the backward, which forms
de = +-sign * (g_cls on row 0, g_aff on rows >= 1), + for the view and -
for the mirror, and runs K1's softmax backward with it. A cotangent that
is None counts as zero (``:1178-1226``).

K2f runs K1's out kernel over all rows, keeping each row's softmax
statistics, then a tensor-core kernel per (64 rows, 64 keys, pair) that
recomputes p head by head in order, sums it per view and writes the sign
tile and partial sums, and a kernel that adds each pair's partials in tile
order: no token limit, and the same bits from two launches. Each wrapper
takes its plain version for a CPU tensor; for a CUDA tensor it launches
its kernel or raises, and counts the launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from acr_wsss_tpu_torch.ops import _build
from acr_wsss_tpu_torch.ops.attn_cuda import (BWD_HEAD_DIM, attention_qkv_cols_backward_plain,
                                              attention_qkv_cols_plain, bwd_launch,
                                              check_cotangent, check_qkv)

KERNEL = "attn_pair_fwd"


def _check_pairs(qkv: torch.Tensor, num_heads: int) -> None:
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, N, 3*H*D) with H={num_heads}, "
                         f"got {tuple(qkv.shape)}")
    if qkv.shape[0] % 2:
        raise ValueError("the pair-consistency entry needs an even batch of "
                         "interleaved view pairs")


def pair_masks(n: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cls mask, aff mask), each (N, N) bool: row 0 and rows >= 1, both
    over columns [1, N)."""
    row = torch.arange(n, device=device)[:, None]
    col = torch.arange(n, device=device)[None, :]
    valid_col = col >= 1
    return valid_col & (row == 0), valid_col & (row >= 1)


def pair_consistency_forward_plain(qkv: torch.Tensor, scale: float, num_heads: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor, torch.Tensor]:
    """K2f's function in plain PyTorch: K1's plain forward on both views and
    explicit masked |delta| sums. Returns (out, cls_sums, aff_sums, sign)."""
    _check_pairs(qkv, num_heads)
    out, probs = attention_qkv_cols_plain(qkv, scale, num_heads, "mean")
    delta = probs[0::2] - probs[1::2]
    cls_mask, aff_mask = pair_masks(qkv.shape[1], qkv.device)
    absd = delta.abs()
    cls_sums = torch.where(cls_mask, absd, 0.0).sum(dim=(1, 2))
    aff_sums = torch.where(aff_mask, absd, 0.0).sum(dim=(1, 2))
    sign = torch.where(cls_mask | aff_mask, torch.sign(delta), 0.0).to(torch.int8)
    return out, cls_sums, aff_sums, sign


def pair_de(sign: torch.Tensor, g_cls: Optional[torch.Tensor],
            g_aff: Optional[torch.Tensor]) -> torch.Tensor:
    """The head-mean cotangent of every batch row, (B, N, N) float32:
    +-sign * g_cls on row 0 and +-sign * g_aff on rows >= 1, + for the
    view, - for the mirror; None counts as zero."""
    pairs, n, _ = sign.shape
    zero = torch.zeros(pairs, dtype=torch.float32, device=sign.device)
    g_cls = zero if g_cls is None else g_cls.float()
    g_aff = zero if g_aff is None else g_aff.float()
    row0 = (torch.arange(n, device=sign.device) == 0)[None, :, None]
    de = sign.float() * torch.where(row0, g_cls[:, None, None], g_aff[:, None, None])
    return torch.stack([de, -de], dim=1).reshape(2 * pairs, n, n)


def pair_consistency_backward_plain(qkv: torch.Tensor, g: torch.Tensor,
                                    sign: torch.Tensor, g_cls: Optional[torch.Tensor],
                                    g_aff: Optional[torch.Tensor], scale: float,
                                    num_heads: int) -> torch.Tensor:
    """K2b's function in plain PyTorch: K1's plain backward math with the
    de of :func:`pair_de`."""
    return attention_qkv_cols_backward_plain(qkv, g, pair_de(sign, g_cls, g_aff),
                                             scale, num_heads)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """K2f's library, built at first use, with its C signatures."""
    lib = _build.load(KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.attn_pair_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                  ctypes.c_float, ptr]
    lib.attn_pair_fwd.restype = i32
    lib.attn_pair_fwd_tiles.argtypes = [i32]
    lib.attn_pair_fwd_tiles.restype = i32
    lib.attn_pair_fwd_blocks_per_sm.argtypes = []
    lib.attn_pair_fwd_blocks_per_sm.restype = i32
    lib.attn_pair_fwd_error_string.argtypes = [i32]
    lib.attn_pair_fwd_error_string.restype = ctypes.c_char_p
    return lib


def pair_kernel_blocks_per_sm() -> int:
    """Blocks of K2f's pair kernel that one SM of the current card holds at
    once (CUDA's occupancy calculator), for reports."""
    return _library().attn_pair_fwd_blocks_per_sm()


def pair_consistency_forward(qkv: torch.Tensor, scale: float, num_heads: int
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """K2f: (out (B, N, H*D), cls_sums (pairs,), aff_sums (pairs,), sign
    (pairs, N, N) int8), no autograd."""
    _check_pairs(qkv, num_heads)
    if qkv.device.type == "cpu":
        return pair_consistency_forward_plain(qkv, scale, num_heads)
    check_qkv(qkv, num_heads, (BWD_HEAD_DIM,))
    B, N, HD3 = qkv.shape
    pairs = B // 2
    lib = _library()
    dev = qkv.device
    with torch.cuda.device(dev):
        out = torch.empty((B, N, HD3 // 3), dtype=torch.bfloat16, device=dev)
        sign = torch.empty((pairs, N, N), dtype=torch.int8, device=dev)
        stats = torch.empty((B, num_heads, N, 2), dtype=torch.float32, device=dev)
        partials = torch.empty((pairs, lib.attn_pair_fwd_tiles(N), 2),
                               dtype=torch.float32, device=dev)
        cls_sums = torch.empty(pairs, dtype=torch.float32, device=dev)
        aff_sums = torch.empty(pairs, dtype=torch.float32, device=dev)
        err = lib.attn_pair_fwd(
            qkv.data_ptr(), out.data_ptr(), sign.data_ptr(), stats.data_ptr(),
            partials.data_ptr(), cls_sums.data_ptr(), aff_sums.data_ptr(), B, N,
            num_heads, BWD_HEAD_DIM, float(scale), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"attn_pair_fwd launch failed: "
                           f"{lib.attn_pair_fwd_error_string(err).decode()}")
    pair_consistency_forward.launches += 1
    return out, cls_sums, aff_sums, sign


pair_consistency_forward.launches = 0


def pair_consistency_backward(qkv: torch.Tensor, g: torch.Tensor, sign: torch.Tensor,
                              g_cls: Optional[torch.Tensor], g_aff: Optional[torch.Tensor],
                              scale: float, num_heads: int) -> torch.Tensor:
    """K2b: dqkv (B, N, 3*H*D) from g (B, N, H*D), the sign tile and the
    per-pair cotangents of the sums (None for zero)."""
    _check_pairs(qkv, num_heads)
    if qkv.device.type == "cpu":
        return pair_consistency_backward_plain(qkv, g, sign, g_cls, g_aff, scale,
                                               num_heads)
    check_qkv(qkv, num_heads, (BWD_HEAD_DIM,))
    g = check_cotangent(g, qkv)
    B, N, _ = qkv.shape
    pairs = B // 2
    if tuple(sign.shape) != (pairs, N, N) or sign.dtype != torch.int8 \
            or sign.device != qkv.device:
        raise TypeError(f"sign must be int8 {(pairs, N, N)} on {qkv.device}, got "
                        f"{sign.dtype} {tuple(sign.shape)} on {sign.device}")
    sign = sign.contiguous()
    zero = torch.zeros(pairs, dtype=torch.float32, device=qkv.device)
    g_cls = zero if g_cls is None else g_cls.float().contiguous()
    g_aff = zero if g_aff is None else g_aff.float().contiguous()
    dqkv = bwd_launch(qkv, lambda lib, dqkv, stats, stream: lib.attn_bwd_pair(
        qkv.data_ptr(), g.data_ptr(), sign.data_ptr(), g_cls.data_ptr(),
        g_aff.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), B, N, num_heads,
        BWD_HEAD_DIM, float(scale), stream))
    pair_consistency_backward.launches += 1
    return dqkv


pair_consistency_backward.launches = 0


class _PairConsistency(torch.autograd.Function):
    """K2f and its custom VJP K2b; residuals qkv and the int8 sign tile."""

    @staticmethod
    def forward(ctx, qkv, scale, num_heads):
        out, cls_sums, aff_sums, sign = pair_consistency_forward(qkv, scale, num_heads)
        ctx.save_for_backward(qkv, sign)
        ctx.scale, ctx.num_heads = scale, num_heads
        ctx.set_materialize_grads(False)
        return out, cls_sums, aff_sums

    @staticmethod
    def backward(ctx, g_out, g_cls, g_aff):
        qkv, sign = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros(qkv.shape[:-1] + (qkv.shape[-1] // 3,),
                                dtype=qkv.dtype, device=qkv.device)
        dqkv = pair_consistency_backward(qkv, g_out.to(qkv.dtype), sign, g_cls, g_aff,
                                         ctx.scale, ctx.num_heads)
        return dqkv, None, None


def fused_attention_pair_consistency(qkv: torch.Tensor, scale: float, num_heads: int
                                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out (B, N, H*D), cls_sums (pairs,) fp32, aff_sums (pairs,) fp32)
    over an interleaved-pair joint projection, with a gradient through K2b.
    Divide the sums by pairs*(N-1) and pairs*(N-1)^2 and average over
    layers to get ``losses.acr_consistency_losses_layers(aligned=True)``."""
    return _PairConsistency.apply(qkv, scale, num_heads)
