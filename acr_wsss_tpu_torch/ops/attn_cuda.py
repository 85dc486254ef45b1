"""Attention over the joint qkv projection, forward and backward, as
hand-written CUDA kernels.

Counterpart of ``acr_wsss_tpu/ops/attn_pallas.py::fused_attention_qkv_cols``
(``:980``). Its forward runs the TPU kernels ``_fwd_kernel_nhd`` (export
"mean", ``:380-418``) and ``_fwd_kernel_nhd_noexport`` (export "none",
``:873-892``); both are the one CUDA kernel ``csrc/attn_fwd_headmean.cu``
(K1f, K1n), whose no-export mode takes a null probs pointer. Its custom VJP
runs ``_bwd_kernel_nhd`` (``:421-469``); that is ``csrc/attn_bwd.cu`` (K1b)
with a dense ``de``, or none for export "none" (``:931-935``).

The forward reads q, k and v as column ranges of the joint (B, N, 3*H*D)
bf16 projection and returns out (B, N, H*D) bf16 and the float32 head mean
of the softmax probabilities (B, N, N). It masks the ragged edge itself (no
padding of N to 640) and its softmax is exact: it subtracts the row max
instead of the TPU kernel's clamp at +-60. The backward recomputes p and
returns dqkv (B, N, 3*H*D) in the column layout of qkv; its arithmetic is
float32. Bounds and designs are in the sources' headers.

Each wrapper takes its plain version for a CPU tensor; for a CUDA tensor
it launches its kernel or raises, and counts the launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from acr_wsss_tpu_torch.ops import _build
from acr_wsss_tpu_torch.ops.attention import attention_with_probs

KERNEL = "attn_fwd_headmean"
BWD_KERNEL = "attn_bwd"
HEAD_DIM = 64


def attention_qkv_cols_plain(qkv: torch.Tensor, scale: float, num_heads: int,
                             export: str = "mean"
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kernel's function in plain PyTorch: same inputs, same outputs."""
    B, N, HD3 = qkv.shape
    HD = HD3 // 3
    q, k, v = qkv.reshape(B, N, 3, num_heads, HD // num_heads).permute(2, 0, 3, 1, 4)
    out, probs = attention_with_probs(q, k, v, scale, export=export)
    return out.transpose(1, 2).reshape(B, N, HD), probs


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = _build.load(KERNEL)
    lib.attn_fwd_headmean.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.attn_fwd_headmean.restype = ctypes.c_int
    lib.attn_fwd_headmean_max_tokens.argtypes = [ctypes.c_int]
    lib.attn_fwd_headmean_max_tokens.restype = ctypes.c_int
    lib.attn_fwd_headmean_error_string.argtypes = [ctypes.c_int]
    lib.attn_fwd_headmean_error_string.restype = ctypes.c_char_p
    return lib


def check_qkv(qkv: torch.Tensor, num_heads: int) -> None:
    """Raise on what the kernels do not take: a (B, N, 3*H*D) bf16 CUDA
    tensor, contiguous, 16-byte aligned, head dim 64."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, N, 3*H*D) with H={num_heads}, "
                         f"got {tuple(qkv.shape)}")
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    if qkv.shape[-1] // (3 * num_heads) != HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {HEAD_DIM}, "
                         f"got {qkv.shape[-1] // (3 * num_heads)}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bfloat16 qkv, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")


def attention_qkv_cols_forward(qkv: torch.Tensor, scale: float, num_heads: int,
                               export: str = "mean"
                               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1f / K1n: (out, head-mean probs or None), no autograd."""
    if export not in ("mean", "none"):
        raise ValueError(f"export must be 'mean' or 'none', got {export!r}")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, N, 3*H*D) with H={num_heads}, "
                         f"got {tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return attention_qkv_cols_plain(qkv, scale, num_heads, export)
    check_qkv(qkv, num_heads)
    B, N, HD3 = qkv.shape
    HD = HD3 // 3
    lib = _library()
    with torch.cuda.device(qkv.device):
        max_tokens = lib.attn_fwd_headmean_max_tokens(int(export == "mean"))
        if N > max_tokens:
            raise ValueError(f"N={N} tokens exceed the kernel's shared-memory "
                             f"limit of {max_tokens}")
        out = torch.empty((B, N, HD), dtype=torch.bfloat16, device=qkv.device)
        probs = (torch.empty((B, N, N), dtype=torch.float32, device=qkv.device)
                 if export == "mean" else None)
        err = lib.attn_fwd_headmean(
            qkv.data_ptr(), out.data_ptr(),
            None if probs is None else probs.data_ptr(), B, N, num_heads,
            HEAD_DIM, float(scale), torch.cuda.current_stream(qkv.device).cuda_stream)
    if err:
        raise RuntimeError(f"attn_fwd_headmean launch failed: "
                           f"{lib.attn_fwd_headmean_error_string(err).decode()}")
    fused_attention_qkv_cols.launches += 1
    if export == "none":
        fused_attention_qkv_cols.launches_noexport += 1
    return out, probs


def attention_qkv_cols_backward_plain(qkv: torch.Tensor, g: torch.Tensor,
                                      de: Optional[torch.Tensor], scale: float,
                                      num_heads: int) -> torch.Tensor:
    """The custom-VJP math of ``_bwd_kernel_nhd`` in plain PyTorch, on a
    recomputed float32 p: dp = g v^T + de/H, ds = p * (dp - rowsum(dp * p)),
    dq = ds k * scale, dk = ds^T q * scale, dv = p^T g. ``de`` is the
    cotangent of the head-mean probs (B, N, N), None for zero. Returns
    dqkv (B, N, 3*H*D) in qkv's dtype. Not autograd of the forward: the
    kernel K1b is held to this."""
    B, N, HD3 = qkv.shape
    HD = HD3 // 3
    D = HD // num_heads
    q, k, v = qkv.float().reshape(B, N, 3, num_heads, D).permute(2, 0, 3, 1, 4)
    gh = g.float().reshape(B, N, num_heads, D).transpose(1, 2)
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    dp = torch.matmul(gh, v.transpose(-1, -2))
    if de is not None:
        dp = dp + (de.float() * (1.0 / num_heads))[:, None]
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dv = torch.matmul(p.transpose(-1, -2), gh)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(B, N, HD3)
    return dqkv.to(qkv.dtype)


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    """The backward kernels' library (K1b and K2b), built at first use."""
    lib = _build.load(BWD_KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.attn_bwd_dense.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                   ctypes.c_float, ptr]
    lib.attn_bwd_dense.restype = i32
    lib.attn_bwd_pair.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                  i32, ctypes.c_float, ptr]
    lib.attn_bwd_pair.restype = i32
    lib.attn_bwd_max_tokens.argtypes = []
    lib.attn_bwd_max_tokens.restype = i32
    lib.attn_bwd_error_string.argtypes = [i32]
    lib.attn_bwd_error_string.restype = ctypes.c_char_p
    return lib


def check_cotangent(g: torch.Tensor, qkv: torch.Tensor) -> torch.Tensor:
    """g of out as the backward kernels take it: (B, N, H*D) bf16,
    contiguous, on qkv's device."""
    B, N, HD3 = qkv.shape
    if tuple(g.shape) != (B, N, HD3 // 3):
        raise ValueError(f"g must be {(B, N, HD3 // 3)}, got {tuple(g.shape)}")
    if g.device != qkv.device or g.dtype != torch.bfloat16:
        raise TypeError(f"g must be bfloat16 on {qkv.device}, got {g.dtype} "
                        f"on {g.device}")
    return g.contiguous()


def bwd_launch(qkv: torch.Tensor, launch) -> torch.Tensor:
    """Allocate dqkv and the row statistics, run ``launch(lib, dqkv,
    stats, stream)`` and raise on its error code."""
    B, N, _ = qkv.shape
    lib = _bwd_library()
    with torch.cuda.device(qkv.device):
        max_tokens = lib.attn_bwd_max_tokens()
        if N > max_tokens:
            raise ValueError(f"N={N} tokens exceed the kernel's shared-memory "
                             f"limit of {max_tokens}")
        heads = qkv.shape[-1] // (3 * HEAD_DIM)
        dqkv = torch.empty_like(qkv)
        stats = torch.empty((B, heads, N, 3), dtype=torch.float32, device=qkv.device)
        err = launch(lib, dqkv, stats, torch.cuda.current_stream(qkv.device).cuda_stream)
    if err:
        raise RuntimeError(f"attn_bwd launch failed: "
                           f"{lib.attn_bwd_error_string(err).decode()}")
    return dqkv


def attention_qkv_cols_backward(qkv: torch.Tensor, g: torch.Tensor,
                                de: Optional[torch.Tensor], scale: float,
                                num_heads: int) -> torch.Tensor:
    """K1b: dqkv from g (B, N, H*D) and de (B, N, N) fp32 or None."""
    if qkv.device.type == "cpu":
        return attention_qkv_cols_backward_plain(qkv, g, de, scale, num_heads)
    check_qkv(qkv, num_heads)
    g = check_cotangent(g, qkv)
    B, N, _ = qkv.shape
    if de is not None:
        if tuple(de.shape) != (B, N, N) or de.dtype != torch.float32 \
                or de.device != qkv.device:
            raise TypeError(f"de must be float32 {(B, N, N)} on {qkv.device}, got "
                            f"{de.dtype} {tuple(de.shape)} on {de.device}")
        de = de.contiguous()
    dqkv = bwd_launch(qkv, lambda lib, dqkv, stats, stream: lib.attn_bwd_dense(
        qkv.data_ptr(), g.data_ptr(), None if de is None else de.data_ptr(),
        dqkv.data_ptr(), stats.data_ptr(), B, N, num_heads, HEAD_DIM, float(scale),
        stream))
    attention_qkv_cols_backward.launches += 1
    return dqkv


attention_qkv_cols_backward.launches = 0


class _AttentionQkvCols(torch.autograd.Function):
    """K1 forward and its custom VJP (``attn_pallas.py:926-958``)."""

    @staticmethod
    def forward(ctx, qkv, scale, num_heads, export):
        out, probs = attention_qkv_cols_forward(qkv, scale, num_heads, export)
        ctx.save_for_backward(qkv)
        ctx.scale, ctx.num_heads = scale, num_heads
        ctx.set_materialize_grads(False)
        return out, probs

    @staticmethod
    def backward(ctx, g_out, g_probs):
        (qkv,) = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros(qkv.shape[:-1] + (qkv.shape[-1] // 3,),
                                dtype=qkv.dtype, device=qkv.device)
        dqkv = attention_qkv_cols_backward(qkv, g_out.to(qkv.dtype), g_probs,
                                           ctx.scale, ctx.num_heads)
        return dqkv, None, None, None


def fused_attention_qkv_cols(qkv: torch.Tensor, scale: float, num_heads: int,
                             export: str = "mean"
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out (B, N, H*D), head-mean probs (B, N, N) fp32 or None), with a
    gradient through the backward kernel.

    A CPU tensor takes the plain versions; a CUDA tensor launches the
    kernels or raises."""
    if not (torch.is_grad_enabled() and qkv.requires_grad):
        return attention_qkv_cols_forward(qkv, scale, num_heads, export)
    return _AttentionQkvCols.apply(qkv, scale, num_heads, export)


fused_attention_qkv_cols.launches = 0
fused_attention_qkv_cols.launches_noexport = 0
