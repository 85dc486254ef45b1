"""PAMR, pixel-adaptive mask refinement, with its two stencils as CUDA kernels.

Counterpart of ``acr_wsss_tpu/ops/pamr.py`` (``pamr`` ``:76-111``,
``pamr_jit`` ``:114-131``). On a TPU that package runs the two Pallas
kernels of ``ops/pamr_pallas.py``: ``_affinity_kernel`` (``:85-122``),
here ``csrc/pamr.cu::pamr_affinity`` (K3), and ``_update_kernel``
(``:125-146``), here ``csrc/pamr.cu::pamr_update`` (K4).

For a guidance image x (B, K, H, W) and dilations d_1..d_n, with P = 8n
neighbours p = (dy, dx) * d in dilation-major order of :data:`OFFSETS`:

* std: per channel, the Bessel-corrected standard deviation over the
  union of every dilation's 3x3 window (9n taps, the centre once per
  dilation), mean and variance in two passes;
* affinity (B, P, H, W): softmax over p of the channel mean of
  -|shift_p(x) - x| / (1e-8 + 0.1 std);
* ``num_iter`` Jacobi steps m <- sum_p shift_p(m) * aff_p.

``shift(x, dy, dx)[..., i, j] = x[..., clamp(i - dy), clamp(j - dx)]``:
edges replicate and the read runs against the offset, for any offset,
also one beyond the image. The mask is first resized bilinearly to (H, W)
with ``align_corners=True``, outside the kernels as in JAX.

The plain versions sum the taps and the neighbours in the kernels' order.
Each wrapper takes its plain version for a CPU tensor; for a CUDA tensor
it launches its kernel or raises, and counts the launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from acr_wsss_tpu_torch.ops import _build

KERNEL = "pamr"
# The 8-neighbourhood, row-major over the 3x3 window minus the centre
# (reference ``pamr.py:25-34``).
OFFSETS: Tuple[Tuple[int, int], ...] = (
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1), (0, 1),
    (1, -1), (1, 0), (1, 1),
)
# The kernels keep one value per neighbour in registers; 8 dilations
# (P = 64) is their compile-time limit.
MAX_DILATIONS = 8


def shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``out[..., i, j] = x[..., clamp(i - dy), clamp(j - dx)]``."""
    h, w = x.shape[-2:]
    rows = (torch.arange(h, device=x.device) - dy).clamp_(0, h - 1)
    cols = (torch.arange(w, device=x.device) - dx).clamp_(0, w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def neighbor_offsets(dilations: Sequence[int]) -> List[Tuple[int, int]]:
    """The P = 8 * len(dilations) neighbour offsets, dilation-major."""
    return [(dy * d, dx * d) for d in dilations for (dy, dx) in OFFSETS]


def window_offsets(dilations: Sequence[int]) -> List[Tuple[int, int]]:
    """The 9 * len(dilations) taps of the local std, row-major per dilation."""
    return [(dy * d, dx * d) for d in dilations
            for (dy, dx) in OFFSETS[:4] + ((0, 0),) + OFFSETS[4:]]


def _check_dilations(dilations: Sequence[int]) -> Tuple[int, ...]:
    dils = tuple(int(d) for d in dilations)
    if not 1 <= len(dils) <= MAX_DILATIONS:
        raise ValueError(f"PAMR takes 1 to {MAX_DILATIONS} dilations, got {len(dils)}")
    return dils


def local_std(x: torch.Tensor, dilations: Sequence[int]) -> torch.Tensor:
    """(B, K, H, W) -> (B, K, H, W): the std over the union window."""
    taps = window_offsets(dilations)
    s1 = torch.zeros_like(x)
    for dy, dx in taps:
        s1 = s1 + shift(x, dy, dx)
    mean = s1 / len(taps)
    s2 = torch.zeros_like(x)
    for dy, dx in taps:
        v = shift(x, dy, dx) - mean
        s2 = s2 + v * v
    return torch.sqrt(s2 / (len(taps) - 1))


def pamr_affinity_plain(x: torch.Tensor, dilations: Sequence[int]) -> torch.Tensor:
    """K3's function: (B, K, H, W) float32 -> aff (B, P, H, W) float32."""
    dilations = _check_dilations(dilations)
    denom = 1e-8 + 0.1 * local_std(x, dilations)
    logits = torch.stack([(-(shift(x, dy, dx) - x).abs() / denom).mean(dim=1)
                          for dy, dx in neighbor_offsets(dilations)], dim=1)
    return torch.softmax(logits, dim=1)


def pamr_update_plain(m: torch.Tensor, aff: torch.Tensor,
                      dilations: Sequence[int]) -> torch.Tensor:
    """K4's function, one Jacobi step: m (B, C, H, W), aff (B, P, H, W) ->
    sum_p shift_p(m) * aff_p, summed in p order."""
    out = torch.zeros_like(m)
    for p, (dy, dx) in enumerate(neighbor_offsets(_check_dilations(dilations))):
        out = out + shift(m, dy, dx) * aff[:, p:p + 1]
    return out


def _resize_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.float()
    if mask.shape[-2:] != x.shape[-2:]:
        mask = F.interpolate(mask, size=x.shape[-2:], mode="bilinear", align_corners=True)
    return mask.contiguous()


def pamr_plain(x: torch.Tensor, mask: torch.Tensor, num_iter: int = 1,
               dilations: Sequence[int] = (1,)) -> torch.Tensor:
    """:func:`pamr` through the plain versions on any device."""
    x = x.float().contiguous()
    mask = _resize_mask(x, mask)
    aff = pamr_affinity_plain(x, dilations)
    for _ in range(num_iter):
        mask = pamr_update_plain(mask, aff, dilations)
    return mask


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """K3's and K4's library, built at first use, with its C signatures."""
    lib = _build.load(KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pamr_affinity.argtypes = [ptr, ptr, i32, i32, i32, i32, ptr, i32, ptr]
    lib.pamr_affinity.restype = i32
    lib.pamr_update.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr, i32, ptr]
    lib.pamr_update.restype = i32
    lib.pamr_error_string.argtypes = [i32]
    lib.pamr_error_string.restype = ctypes.c_char_p
    return lib


def _check_tensor(name: str, t: torch.Tensor) -> None:
    if t.dim() != 4:
        raise ValueError(f"{name} must be (B, C, H, W), got {tuple(t.shape)}")
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 {name}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: {lib.pamr_error_string(err).decode()}")


def pamr_affinity(x: torch.Tensor, dilations: Sequence[int]) -> torch.Tensor:
    """K3: the affinity (B, P, H, W) float32 of the guidance x (B, K, H, W)."""
    dils = _check_dilations(dilations)
    if x.device.type == "cpu":
        return pamr_affinity_plain(x, dils)
    _check_tensor("x", x)
    B, K, H, W = x.shape
    aff = torch.empty((B, 8 * len(dils), H, W), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.pamr_affinity(x.data_ptr(), aff.data_ptr(), B, K, H, W,
                                (ctypes.c_int * len(dils))(*dils), len(dils),
                                torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "pamr_affinity")
    pamr_affinity.launches += 1
    return aff


pamr_affinity.launches = 0


def pamr_update(m: torch.Tensor, aff: torch.Tensor, dilations: Sequence[int],
                num_iter: int = 1) -> torch.Tensor:
    """K4, ``num_iter`` Jacobi steps of m (B, C, H, W) under aff (B, P, H, W).
    One launch per step between two buffers, since a step reads
    neighbours that an in-place step would already have overwritten; m
    itself is not written."""
    dils = _check_dilations(dilations)
    if m.device.type == "cpu":
        for _ in range(num_iter):
            m = pamr_update_plain(m, aff, dils)
        return m
    _check_tensor("m", m)
    _check_tensor("aff", aff)
    B, C, H, W = m.shape
    if tuple(aff.shape) != (B, 8 * len(dils), H, W) or aff.device != m.device:
        raise ValueError(f"aff must be {(B, 8 * len(dils), H, W)} on {m.device}, got "
                         f"{tuple(aff.shape)} on {aff.device}")
    if num_iter < 1:
        return m
    lib = _library()
    bufs = [torch.empty_like(m) for _ in range(min(num_iter, 2))]
    c_dils = (ctypes.c_int * len(dils))(*dils)
    src = m
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        for it in range(num_iter):
            dst = bufs[it % 2]
            err = lib.pamr_update(src.data_ptr(), aff.data_ptr(), dst.data_ptr(), B, C,
                                  H, W, c_dils, len(dils), stream)
            _raise_on(lib, err, "pamr_update")
            pamr_update.launches += 1
            src = dst
    return src


pamr_update.launches = 0


def pamr(x: torch.Tensor, mask: torch.Tensor, num_iter: int = 1,
         dilations: Sequence[int] = (1,)) -> torch.Tensor:
    """Refine ``mask`` (B, C, h, w) by the affinities of x (B, K, H, W):
    resize to (H, W), one K3 launch, ``num_iter`` K4 launches. Returns
    (B, C, H, W) float32."""
    x = x.float().contiguous()
    mask = _resize_mask(x, mask)
    return pamr_update(mask, pamr_affinity(x, dilations), dilations, num_iter)


def make_pamr_fn(num_iter: int = 1, dilations: Sequence[int] = (1,)):
    """``fn(x, mask)``: :func:`pamr` with these settings (``pamr_jit``)."""
    return functools.partial(pamr, num_iter=num_iter, dilations=_check_dilations(dilations))
