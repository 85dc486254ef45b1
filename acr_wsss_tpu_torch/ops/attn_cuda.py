"""Attention forward with head-mean export, as a hand-written CUDA kernel.

Counterpart of ``acr_wsss_tpu/ops/attn_pallas.py::fused_attention_qkv_cols``
(``:980``), whose forward runs the TPU kernels ``_fwd_kernel_nhd``
(export "mean", ``:380-418``) and ``_fwd_kernel_nhd_noexport`` (export
"none", ``:873-892``). Both become one CUDA kernel,
``csrc/attn_fwd_headmean.cu``, whose no-export mode takes a null probs
pointer.

It reads q, k and v as column ranges of the joint (B, N, 3*H*D) bf16
projection and returns out (B, N, H*D) bf16 and the float32 head mean of
the softmax probabilities (B, N, N). It masks the ragged edge itself (no
padding of N to 640) and its softmax is exact: it subtracts the row max
instead of the TPU kernel's clamp at +-60.

Bound at the inference shape (B=2, H=12, N=577, D=64): 2.05 GFLOP, 2.1 us
at 989 TFLOP/s bf16; 9.7 MB moved (qkv 5.3 MB in, out 1.8 MB and probs
2.7 MB out), 2.9 us at 3.35 TB/s: the bytes bound it. The design (one
block per 8 query rows of one image, looping over the heads so the head
mean stays in shared memory) is in the source's header.

There is no backward kernel yet: the inference slice runs it only for
blocks that take no gradient tap, and the wrapper refuses an input that
requires grad.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from acr_wsss_tpu_torch.ops import _build
from acr_wsss_tpu_torch.ops.attention import attention_with_probs

KERNEL = "attn_fwd_headmean"
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


def fused_attention_qkv_cols(qkv: torch.Tensor, scale: float, num_heads: int,
                             export: str = "mean"
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out (B, N, H*D), head-mean probs (B, N, N) fp32 or None).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if export not in ("mean", "none"):
        raise ValueError(f"export must be 'mean' or 'none', got {export!r}")
    if qkv.requires_grad:
        raise RuntimeError("fused_attention_qkv_cols has no backward kernel "
                           "yet; call it on tensors that do not require grad")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, N, 3*H*D) with H={num_heads}, "
                         f"got {tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return attention_qkv_cols_plain(qkv, scale, num_heads, export)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    B, N, HD3 = qkv.shape
    HD = HD3 // 3
    if HD // num_heads != HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {HEAD_DIM}, got {HD // num_heads}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bfloat16 qkv, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
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
    return out, probs


fused_attention_qkv_cols.launches = 0
