"""Attention with a head-mean probability export, forward and backward, as
hand-written CUDA kernels, in the four layouts of the JAX package.

Counterpart of the entries of ``acr_wsss_tpu/ops/attn_pallas.py``:

* ``fused_attention_qkv_cols`` (``:980``, K1): the joint (B, N, 3*H*D)
  projection read as q, k, v column views;
* ``fused_attention_with_probs`` (``:257``, K5a): q, k, v (B, H, N, D),
  the kernel behind ``attention_with_probs(impl="kernel")``;
* ``fused_attention_nhd`` (``:568``, K5b): split q, k, v (B, N, H*D);
* ``fused_attention_qkv`` (``:764``, K5c): the joint (B, N, 3, H*D) view,
  which is the memory of K1's column views.

Every forward runs ``csrc/attn_fwd_headmean.cu`` and every backward the
dense-de path of ``csrc/attn_bwd.cu``, tensor-core kernels that take any
number of tokens: each layout is one set of (batch, token, head) strides
of q, k, v and out, with a unit stride on D. The forward returns out in
the layout of its inputs and the head mean of the softmax probabilities
(B, N, N) in float32, in bfloat16 (``probs_dtype``, K1, K5b and K5c:
summed in float32, rounded once), or None for export "none" (a null
probs pointer: K1n). The backward recomputes
p and returns the gradients in the layouts of the JAX entries: dqkv for K1
and K5c, three (B, N, H*D) for K5b, three (B, H, N, D) for K5a; ``de``, the
cotangent of the export, is float32, bfloat16 (upcast in the kernel) or
None. The softmax is exact (row max subtracted) and the ragged edge masked:
the TPU kernels' clamp at +-60 and analytic pad correction are not copied.
Bounds and designs are in the sources' headers.

Each entry takes its plain version (``*_plain``) for a CPU tensor; for a
CUDA tensor it launches its kernel or raises, and counts the launch:
``launches`` (forward), ``launches_noexport`` (of which export "none") and
``backward_launches`` on the entry, K1's backward on
``attention_qkv_cols_backward.launches``; a backward with no de also on
the same counter's ``_no_de`` twin (``backward_launches_no_de``,
``launches_no_de``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from acr_wsss_tpu_torch.ops import _build
from acr_wsss_tpu_torch.ops.attention import attention_with_probs

KERNEL = "attn_fwd_headmean"
BWD_KERNEL = "attn_bwd"
# Head dims of the forward and backward kernels (K1f, K1n, K1b and the K5
# forwards and backwards): every multiple of 16 up to 128, held as
# zero-filled tiles of 64 columns (``csrc/attn_tiles.cuh``). The pair
# kernels (K2f, K2b: ``ops/attn_pair.py``) take 64 only: every ACR backbone
# is at head dim 64, so no path trains the pair at another.
FWD_HEAD_DIMS = tuple(range(16, 129, 16))
PAIR_HEAD_DIM = 64
# dtype codes of the C interfaces: 0 is "none" (a null pointer).
DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2}


# --- layouts ---------------------------------------------------------------
# A layout says how the entry's tensors hold q, k and v; the kernels see
# every operand as a (B, N, H, D) view with its own strides.

def _split(layout: str, inputs: Sequence[torch.Tensor], num_heads: Optional[int]):
    """q, k, v of the layout's inputs as (B, N, H, D) views (``num_heads``
    is read from the tensors for "bhnd")."""
    if layout == "cols":
        return inputs[0].unflatten(-1, (3, num_heads, -1)).unbind(2)
    if layout == "nhd":
        return tuple(t.unflatten(-1, (num_heads, -1)) for t in inputs)
    return tuple(t.transpose(1, 2) for t in inputs)


def _out_view(layout: str, t: torch.Tensor, num_heads: Optional[int]) -> torch.Tensor:
    """out (or its cotangent) in the layout, as a (B, N, H, D) view."""
    return t.transpose(1, 2) if layout == "bhnd" else t.unflatten(-1, (num_heads, -1))


def _from_bnhd(layout: str, x: torch.Tensor) -> torch.Tensor:
    """A (B, N, H, D) tensor in the layout of out: (B, H, N, D) or (B, N, H*D)."""
    return x.transpose(1, 2) if layout == "bhnd" else x.flatten(2)


def _empty_bnhd(layout: str, shape, like: torch.Tensor) -> torch.Tensor:
    """An empty (B, N, H, D) view whose memory is in the layout's order."""
    B, N, H, D = shape
    if layout == "bhnd":
        return like.new_empty((B, H, N, D)).transpose(1, 2)
    return like.new_empty((B, N, H, D))


def check_layout(layout: str, inputs: Sequence[torch.Tensor], num_heads: Optional[int]) -> None:
    """Raise ValueError on tensors that are not the layout's, or whose last
    axis (D) has no unit stride. Device-independent."""
    if layout == "cols":
        (qkv,) = inputs
        if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
            raise ValueError(f"qkv must be (B, N, 3*H*D) with H={num_heads}, "
                             f"got {tuple(qkv.shape)}")
    elif layout == "nhd":
        if any(t.dim() != 3 or t.shape != inputs[0].shape for t in inputs) \
                or inputs[0].shape[-1] % num_heads:
            raise ValueError(f"q, k, v must be three (B, N, H*D) tensors with H={num_heads}, "
                             f"got {[tuple(t.shape) for t in inputs]}")
    elif any(t.dim() != 4 or t.shape != inputs[0].shape for t in inputs):
        raise ValueError(f"q, k, v must be three (B, H, N, D) tensors, "
                         f"got {[tuple(t.shape) for t in inputs]}")
    if any(t.stride(-1) != 1 for t in inputs):
        raise ValueError("the last axis (D) of q, k and v must have unit stride, got "
                         f"strides {[t.stride() for t in inputs]}")


def check_head_dim(head_dim: int, head_dims=FWD_HEAD_DIMS) -> None:
    """Raise ValueError naming ``head_dim`` if the kernels do not take it."""
    if head_dim not in head_dims:
        allowed = (f"{head_dims[0]}, {head_dims[1]}, ..., {head_dims[-1]}"
                   if len(head_dims) > 2 else ", ".join(map(str, head_dims)))
        raise ValueError(f"the kernels take head dim {allowed}, got {head_dim}; "
                         "use attn_impl='plain' for it")


def check_operands(operands: Sequence[torch.Tensor], head_dims=FWD_HEAD_DIMS) -> None:
    """Raise on (B, N, H, D) views the kernels do not take: not CUDA, not
    bfloat16, head dim not in ``head_dims``, a row of D values not 16-byte
    aligned."""
    device = operands[0].device
    if device.type != "cuda" or any(t.device != device for t in operands):
        raise ValueError(f"no kernel for device {device}")
    if any(t.dtype != torch.bfloat16 for t in operands):
        raise TypeError(f"the kernels take bfloat16 q, k and v, got "
                        f"{[t.dtype for t in operands]}")
    check_head_dim(operands[0].shape[-1], head_dims)
    if any(t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]) for t in operands):
        raise ValueError("every row of D values of q, k and v must start 16-byte aligned "
                         "(base pointer and batch, token and head strides)")


def _strides(*operands: torch.Tensor):
    values = [s for t in operands for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(values))(*values)


def _check_probs_dtype(probs_dtype: torch.dtype) -> None:
    if probs_dtype not in DTYPE_CODES:
        raise ValueError(f"probs_dtype must be torch.float32 or torch.bfloat16, "
                         f"got {probs_dtype}")


# --- forward ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The forward kernel's library, built at first use, with its C signatures."""
    lib = _build.load(KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.attn_fwd_headmean.argtypes = [ptr, ptr, ptr, ptr, ctypes.POINTER(ctypes.c_longlong),
                                      ptr, i32, ptr, i32, i32, i32, i32, ctypes.c_float, ptr]
    lib.attn_fwd_headmean.restype = i32
    lib.attn_fwd_headmean_error_string.argtypes = [i32]
    lib.attn_fwd_headmean_error_string.restype = ctypes.c_char_p
    return lib


def forward_plain(layout: str, inputs: Sequence[torch.Tensor], scale: float,
                  num_heads: Optional[int], export: str = "mean",
                  probs_dtype: torch.dtype = torch.float32
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The forward kernel's function in plain PyTorch: the float32 head
    mean of ``ops/attention.py``, rounded once to ``probs_dtype``."""
    q, k, v = (t.transpose(1, 2) for t in _split(layout, inputs, num_heads))
    out, probs = attention_with_probs(q, k, v, scale, export=export)
    out = out if layout == "bhnd" else out.transpose(1, 2).flatten(2)
    return out, None if probs is None else probs.to(probs_dtype)


def forward(layout: str, inputs: Sequence[torch.Tensor], scale: float, num_heads: Optional[int],
            export: str, probs_dtype: torch.dtype, entry) -> Tuple[torch.Tensor,
                                                                   Optional[torch.Tensor]]:
    """The forward of any layout, no autograd: the plain version for CPU
    tensors, else one kernel launch, counted on ``entry``."""
    if export not in ("mean", "none"):
        raise ValueError(f"export must be 'mean' or 'none', got {export!r}")
    _check_probs_dtype(probs_dtype)
    check_layout(layout, inputs, num_heads)
    if all(t.device.type == "cpu" for t in inputs):
        return forward_plain(layout, inputs, scale, num_heads, export, probs_dtype)
    q, k, v = _split(layout, inputs, num_heads)
    check_operands((q, k, v))
    B, N, H, D = q.shape
    lib = _library()
    with torch.cuda.device(q.device):
        out = _empty_bnhd(layout, q.shape, q)
        probs = stats = None
        if export == "mean":
            probs = torch.empty((B, N, N), dtype=probs_dtype, device=q.device)
            stats = torch.empty((B, H, N, 2), dtype=torch.float32, device=q.device)
        err = lib.attn_fwd_headmean(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _strides(q, k, v, out),
            None if probs is None else probs.data_ptr(),
            0 if probs is None else DTYPE_CODES[probs_dtype],
            None if stats is None else stats.data_ptr(), B, N, H, D, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"attn_fwd_headmean launch failed: "
                           f"{lib.attn_fwd_headmean_error_string(err).decode()}")
    entry.launches += 1
    if export == "none":
        entry.launches_noexport += 1
    return _from_bnhd(layout, out), probs


# --- backward --------------------------------------------------------------

def backward_plain(layout: str, inputs: Sequence[torch.Tensor], g: torch.Tensor,
                   de: Optional[torch.Tensor], scale: float, num_heads: Optional[int]
                   ) -> Tuple[torch.Tensor, ...]:
    """The custom-VJP math of ``_bwd_kernel_nhd`` / ``_bwd_kernel`` in plain
    PyTorch, on a recomputed float32 p: dp = g v^T + de/H, ds = p * (dp -
    rowsum(dp * p)), dq = ds k * scale, dk = ds^T q * scale, dv = p^T g.
    ``de`` is the cotangent of the head-mean probs (B, N, N), float32 or
    bfloat16 (upcast), None for zero. Returns the gradients in the layout
    and dtype of the inputs. Not autograd of the forward: the backward
    kernel is held to this."""
    q, k, v = (t.float().transpose(1, 2) for t in _split(layout, inputs, num_heads))
    gh = _out_view(layout, g, num_heads).float().transpose(1, 2)
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    dp = torch.matmul(gh, v.transpose(-1, -2))
    if de is not None:
        dp = dp + (de.float() * (1.0 / q.shape[1]))[:, None]
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    grads = (torch.matmul(ds, k) * scale, torch.matmul(ds.transpose(-1, -2), q) * scale,
             torch.matmul(p.transpose(-1, -2), gh))
    if layout == "cols":
        dqkv = torch.stack(grads, dim=2).transpose(1, 3).flatten(2)   # (B, N, 3*H*D)
        return (dqkv.to(inputs[0].dtype),)
    if layout == "nhd":
        return tuple(d.transpose(1, 2).flatten(2).to(t.dtype) for d, t in zip(grads, inputs))
    return tuple(d.to(t.dtype) for d, t in zip(grads, inputs))


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    """The backward kernels' library (dense de and K2b), built at first use."""
    lib = _build.load(BWD_KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.attn_bwd_dense.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                   ctypes.POINTER(ctypes.c_longlong), ptr, i32, ptr, i32, i32,
                                   i32, i32, ctypes.c_float, ptr]
    lib.attn_bwd_dense.restype = i32
    lib.attn_bwd_pair.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                  i32, ctypes.c_float, ptr]
    lib.attn_bwd_pair.restype = i32
    lib.attn_bwd_error_string.argtypes = [i32]
    lib.attn_bwd_error_string.restype = ctypes.c_char_p
    return lib


def bwd_call(device: torch.device, B: int, N: int, heads: int, launch) -> None:
    """Allocate the row statistics, run ``launch(lib, stats, stream)`` on
    ``device`` and raise on its error code."""
    lib = _bwd_library()
    with torch.cuda.device(device):
        stats = torch.empty((B, heads, N, 3), dtype=torch.float32, device=device)
        err = launch(lib, stats, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"attn_bwd launch failed: "
                           f"{lib.attn_bwd_error_string(err).decode()}")


def bwd_launch(qkv: torch.Tensor, launch) -> torch.Tensor:
    """dqkv like qkv from ``launch(lib, dqkv, stats, stream)`` (the pair
    entry's backward)."""
    B, N, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    bwd_call(qkv.device, B, N, qkv.shape[-1] // (3 * PAIR_HEAD_DIM),
             lambda lib, stats, stream: launch(lib, dqkv, stats, stream))
    return dqkv


def check_de(de: Optional[torch.Tensor], B: int, N: int, device) -> Optional[torch.Tensor]:
    """de as the dense backward takes it: (B, N, N) float32 or bfloat16 on
    ``device``, contiguous; or None."""
    if de is None:
        return None
    if tuple(de.shape) != (B, N, N) or de.dtype not in DTYPE_CODES or de.device != device:
        raise TypeError(f"de must be float32 or bfloat16 {(B, N, N)} on {device}, got "
                        f"{de.dtype} {tuple(de.shape)} on {de.device}")
    return de.contiguous()


def backward(layout: str, inputs: Sequence[torch.Tensor], g: torch.Tensor,
             de: Optional[torch.Tensor], scale: float, num_heads: Optional[int], entry,
             counter: str = "backward_launches") -> Tuple[torch.Tensor, ...]:
    """The backward of any layout: the plain version for CPU tensors, else
    one launch of the dense-de backward kernel, counted on ``entry``'s
    ``counter``. ``g``: the cotangent of out, bfloat16, in out's layout."""
    check_layout(layout, inputs, num_heads)
    if all(t.device.type == "cpu" for t in inputs):
        return backward_plain(layout, inputs, g, de, scale, num_heads)
    q, k, v = _split(layout, inputs, num_heads)
    check_operands((q, k, v))
    B, N, H, D = q.shape
    out_shape = _from_bnhd(layout, q).shape
    if tuple(g.shape) != tuple(out_shape) or g.device != q.device \
            or g.dtype != torch.bfloat16:
        raise TypeError(f"g must be bfloat16 {tuple(out_shape)} on {q.device}, got "
                        f"{g.dtype} {tuple(g.shape)} on {g.device}")
    gv = _out_view(layout, g.contiguous(), num_heads)
    de = check_de(de, B, N, q.device)
    if layout == "cols":
        dqkv = q.new_empty((B, N, 3, H, D))
        dq, dk, dv = dqkv.unbind(2)
        grads = (dqkv.flatten(2),)
    else:
        dq, dk, dv = (_empty_bnhd(layout, q.shape, q) for _ in range(3))
        grads = tuple(_from_bnhd(layout, t) for t in (dq, dk, dv))
    bwd_call(q.device, B, N, H, lambda lib, stats, stream: lib.attn_bwd_dense(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), gv.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _strides(q, k, v, gv, dq, dk, dv),
        None if de is None else de.data_ptr(), 0 if de is None else DTYPE_CODES[de.dtype],
        stats.data_ptr(), B, N, H, D, float(scale), stream))
    setattr(entry, counter, getattr(entry, counter) + 1)
    if de is None:
        setattr(entry, counter + "_no_de", getattr(entry, counter + "_no_de") + 1)
    return grads


class _Attention(torch.autograd.Function):
    """A forward kernel and its custom VJP, the backward kernel, for any
    layout (``attn_pallas.py:232-245``, ``:582-594``, ``:749-761``,
    ``:926-958``)."""

    @staticmethod
    def forward(ctx, name, scale, num_heads, export, probs_dtype, *inputs):
        layout, entry, bwd_entry, bwd_counter = ENTRIES[name]
        out, probs = forward(layout, inputs, scale, num_heads, export, probs_dtype, entry)
        ctx.save_for_backward(*inputs)
        ctx.layout, ctx.scale, ctx.num_heads = layout, scale, num_heads
        ctx.bwd = (bwd_entry, bwd_counter)
        ctx.set_materialize_grads(False)
        return out, probs

    @staticmethod
    def backward(ctx, g_out, g_probs):
        inputs = ctx.saved_tensors
        if g_out is None:
            shape = _from_bnhd(ctx.layout, _split(ctx.layout, inputs, ctx.num_heads)[0]).shape
            g_out = inputs[0].new_zeros(shape)
        grads = backward(ctx.layout, inputs, g_out.to(inputs[0].dtype), g_probs, ctx.scale,
                         ctx.num_heads, *ctx.bwd)
        return (None,) * 5 + tuple(grads)


def _apply(name: str, inputs: Sequence[torch.Tensor], scale: float, num_heads: Optional[int],
           export: str, probs_dtype: torch.dtype):
    """The forward alone where no gradient is asked for; else the forward
    and its backward."""
    layout, entry = ENTRIES[name][:2]
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in inputs)):
        return forward(layout, inputs, scale, num_heads, export, probs_dtype, entry)
    return _Attention.apply(name, scale, num_heads, export, probs_dtype, *inputs)


# --- K1: the joint projection as column views ------------------------------

def check_qkv(qkv: torch.Tensor, num_heads: int, head_dims=FWD_HEAD_DIMS) -> None:
    """Raise on what the column-view kernels (K1, K2) do not take: a (B, N,
    3*H*D) bf16 CUDA tensor, contiguous, 16-byte aligned, head dim in
    ``head_dims`` (K1: ``FWD_HEAD_DIMS``; K2: 64)."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, N, 3*H*D) with H={num_heads}, "
                         f"got {tuple(qkv.shape)}")
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    check_head_dim(qkv.shape[-1] // (3 * num_heads), head_dims)
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bfloat16 qkv, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")


def check_cotangent(g: torch.Tensor, qkv: torch.Tensor) -> torch.Tensor:
    """g of out as the pair backward kernel takes it: (B, N, H*D) bf16,
    contiguous, on qkv's device."""
    B, N, HD3 = qkv.shape
    if tuple(g.shape) != (B, N, HD3 // 3):
        raise ValueError(f"g must be {(B, N, HD3 // 3)}, got {tuple(g.shape)}")
    if g.device != qkv.device or g.dtype != torch.bfloat16:
        raise TypeError(f"g must be bfloat16 on {qkv.device}, got {g.dtype} "
                        f"on {g.device}")
    return g.contiguous()


def attention_qkv_cols_plain(qkv: torch.Tensor, scale: float, num_heads: int,
                             export: str = "mean", probs_dtype: torch.dtype = torch.float32
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1's (and K5c's) function in plain PyTorch: same inputs, same outputs."""
    return forward_plain("cols", (qkv,), scale, num_heads, export, probs_dtype)


def attention_qkv_cols_forward(qkv: torch.Tensor, scale: float, num_heads: int,
                               export: str = "mean", probs_dtype: torch.dtype = torch.float32
                               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1f / K1n: (out, head-mean probs or None), no autograd."""
    if qkv.device.type != "cpu":
        check_qkv(qkv, num_heads)
    return forward("cols", (qkv,), scale, num_heads, export, probs_dtype,
                   fused_attention_qkv_cols)


def attention_qkv_cols_backward_plain(qkv: torch.Tensor, g: torch.Tensor,
                                      de: Optional[torch.Tensor], scale: float,
                                      num_heads: int) -> torch.Tensor:
    """K1b's (and K5c's) backward math in plain PyTorch (``backward_plain``):
    dqkv (B, N, 3*H*D) in qkv's dtype."""
    return backward_plain("cols", (qkv,), g, de, scale, num_heads)[0]


def attention_qkv_cols_backward(qkv: torch.Tensor, g: torch.Tensor,
                                de: Optional[torch.Tensor], scale: float,
                                num_heads: int) -> torch.Tensor:
    """K1b: dqkv from g (B, N, H*D) and de (B, N, N) fp32, bf16 or None."""
    if qkv.device.type != "cpu":
        check_qkv(qkv, num_heads)
    return backward("cols", (qkv,), g, de, scale, num_heads,
                    attention_qkv_cols_backward, "launches")[0]


attention_qkv_cols_backward.launches = attention_qkv_cols_backward.launches_no_de = 0


def fused_attention_qkv_cols(qkv: torch.Tensor, scale: float, num_heads: int,
                             export: str = "mean", probs_dtype: torch.dtype = torch.float32
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1: (out (B, N, H*D), head-mean probs (B, N, N) of ``probs_dtype``
    or None), with a gradient through the backward kernel."""
    if qkv.device.type != "cpu":
        check_qkv(qkv, num_heads)
    return _apply("K1", (qkv,), scale, num_heads, export, probs_dtype)


# --- K5: the other layouts -------------------------------------------------

def fused_attention_with_probs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float, probs_offset: Optional[torch.Tensor] = None,
                               export: str = "mean"
                               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K5a: q, k, v (B, H, N, D) -> (out (B, H, N, D), float32 head-mean
    probs (B, N, N) or None). As the JAX entry (``attn_pallas.py:257-282``):
    a ``probs_offset`` or export "full" takes the plain path of
    ``ops/attention.py``; "mean" and "none" run the kernels ("none" with a
    null probs pointer). Its plain version is ``attention_with_probs``."""
    if probs_offset is not None or export == "full":
        return attention_with_probs(q, k, v, scale, probs_offset, export)
    return _apply("K5a", (q, k, v), scale, None, export, torch.float32)


def fused_attention_nhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                        num_heads: int, export: str = "mean",
                        probs_dtype: torch.dtype = torch.float32
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K5b: split q, k, v (B, N, H*D) -> (out (B, N, H*D), head-mean probs
    (B, N, N) of ``probs_dtype`` or None); gradients (B, N, H*D) each. Its
    plain version is ``forward_plain("nhd", ...)``."""
    return _apply("K5b", (q, k, v), scale, num_heads, export, probs_dtype)


def fused_attention_qkv(qkv: torch.Tensor, scale: float, num_heads: int,
                        export: str = "mean", probs_dtype: torch.dtype = torch.float32
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K5c: the joint (B, N, 3*H*D) projection, read through its (B, N, 3,
    H*D) view, which is the memory of K1's column views -> (out (B, N,
    H*D), head-mean probs or None); one joined gradient (B, N, 3*H*D).
    Takes any strides with a unit stride on D. Its plain version is
    ``attention_qkv_cols_plain``."""
    return _apply("K5c", (qkv,), scale, num_heads, export, probs_dtype)


for _entry in (fused_attention_qkv_cols, fused_attention_with_probs, fused_attention_nhd,
               fused_attention_qkv):
    _entry.launches = _entry.launches_noexport = _entry.backward_launches = 0
    _entry.backward_launches_no_de = 0
del _entry

# name: (layout, forward's counter, backward's counter and its attribute)
ENTRIES = {
    "K1": ("cols", fused_attention_qkv_cols, attention_qkv_cols_backward, "launches"),
    "K5a": ("bhnd", fused_attention_with_probs, fused_attention_with_probs,
            "backward_launches"),
    "K5b": ("nhd", fused_attention_nhd, fused_attention_nhd, "backward_launches"),
    "K5c": ("cols", fused_attention_qkv, fused_attention_qkv, "backward_launches"),
}
