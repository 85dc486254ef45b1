"""Dense-CRF mean-field: the reference's host recipes and the on-device route.

Own copy of ``acr_wsss_tpu/ops/crf.py``:

* ``crf_inference``, ``crf_inference_inf`` and ``crf_inference_label``: the
  reference's three pydensecrf hyperparameter sets (``tool/imutils.py:
  345-400``) on the native permutohedral engine (``ops/bilateral.py``), on
  the host;
* :func:`crf_inference_torch`: the counterpart of ``crf_inference_jax``
  (``:92-273``), the mean-field approximation that runs on the device
  (``infer_cam --crf_device``). Plain PyTorch, as the JAX function is XLA
  with no Pallas kernel. Its splat is JAX's ``scatter`` route, the one JAX
  takes on every backend but a TPU; JAX's one-hot-matmul splat, written for
  the TPU's matrix unit, is not ported: on an H100 it took 3.7x as long
  (``PERF.md``).
"""

from __future__ import annotations

import contextlib
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

from acr_wsss_tpu_torch.ops import bilateral as _native


def _densecrf(img: np.ndarray, probs: np.ndarray, t: int,
              sxy_g: float, compat_g: float,
              sxy_b: float, srgb: float, compat_b: float) -> np.ndarray:
    lib = _native.load_library()
    img = np.ascontiguousarray(img, np.float32)
    probs = np.ascontiguousarray(probs, np.float32)
    _native.check_guide(img, probs)
    L, H, W = probs.shape
    out = np.empty_like(probs)
    lib.densecrf_inference(img, probs, out, H, W, L, int(t),
                           float(sxy_g), float(compat_g),
                           float(sxy_b), float(srgb), float(compat_b))
    return out


def crf_inference(img: np.ndarray, probs: np.ndarray, t: int = 10,
                  scale_factor: float = 1, labels: int = 21) -> np.ndarray:
    """Reference ``crf_inference`` recipe (``tool/imutils.py:345-362``):
    Gaussian sxy=3 compat=3; bilateral sxy=80 srgb=13 compat=10."""
    del labels
    return _densecrf(img, probs, t, 3 / scale_factor, 3, 80 / scale_factor, 13, 10)


def crf_inference_inf(img: np.ndarray, probs: np.ndarray, t: int = 10,
                      scale_factor: float = 1, labels: int = 21) -> np.ndarray:
    """Reference ``crf_inference_inf`` recipe (``tool/imutils.py:365-384``):
    Gaussian sxy=3 compat=3; bilateral sxy=83 srgb=5 compat=4."""
    del labels
    return _densecrf(img, probs, t, 3 / scale_factor, 3, 83 / scale_factor, 5, 4)


def crf_inference_label(img: np.ndarray, labels_map: np.ndarray, t: int = 10,
                        n_labels: int = 21, gt_prob: float = 0.7) -> np.ndarray:
    """Reference ``crf_inference_label`` (``tool/imutils.py:387-400``):
    unary from hard labels with confidence gt_prob; Gaussian sxy=3 compat=3,
    bilateral sxy=50 srgb=5 compat=10; returns argmax."""
    H, W = labels_map.shape
    probs = np.full((n_labels, H, W), (1.0 - gt_prob) / (n_labels - 1), np.float32)
    rows, cols = np.indices((H, W))
    probs[labels_map.reshape(-1), rows.reshape(-1), cols.reshape(-1)] = gt_prob
    out = _densecrf(img, probs, t, 3, 3, 50, 5, 10)
    return np.argmax(out, axis=0)


# ---------------------------------------------------------------------------
# On-device mean-field approximation
# ---------------------------------------------------------------------------

# Colour bins per channel of the bilateral grid at most (JAX's default
# ``max_color_bins``): 16 at srgb=13.
MAX_COLOR_BINS = 16

def _band_power(n: int, passes: int) -> np.ndarray:
    """The edge-clamped [1 2 1]/4 blur along an axis of length n as a
    matrix (boundary rows truncated: mass leaving the grid is dropped),
    raised to ``passes`` in float64 and cast to float32."""
    T = np.zeros((n, n), np.float64)
    for i in range(n):
        T[i, i] = 0.5
        if i > 0:
            T[i, i - 1] = 0.25
        if i + 1 < n:
            T[i, i + 1] = 0.25
    return np.linalg.matrix_power(T, passes).astype(np.float32)


@contextlib.contextmanager
def _fp32_products():
    """float32 matrix products whatever the process-wide TF32 switches say
    (``torch.backends.cuda.matmul.allow_tf32`` is the same setting)."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def _gaussian_taps(sxy_g: float) -> np.ndarray:
    """The Gaussian message's 1-D kernel: radius max(1, int(2 sxy_g)), so
    13 taps at sxy_g = 3, computed in float32 as the JAX function does."""
    radius = max(1, int(2 * sxy_g))
    ax = np.arange(-radius, radius + 1, dtype=np.float32)
    return np.exp(np.float32(-0.5) * (ax / np.float32(sxy_g)) ** 2)


def _filter_axis(x: torch.Tensor, taps: np.ndarray, dim: int) -> torch.Tensor:
    """``jnp.convolve(mode="same")`` of every line of ``x`` along ``dim``
    with the symmetric ``taps``: zero padding, one shifted add per tap (no
    convolution, so no TF32). Like the JAX function, which then returns
    len(taps) samples, it cannot take a line shorter than the kernel."""
    n, m = x.shape[dim], len(taps)
    if n < m:
        raise ValueError(f"the Gaussian message's {m} taps need lines of at least {m} "
                         f"pixels; this image has {n} along dim {dim}")
    r = m // 2
    xp = F.pad(x, (r, r) if dim == -1 else (0, 0, r, r))
    out = xp.narrow(dim, 0, n) * float(taps[0])
    for j in range(1, m):
        out.add_(xp.narrow(dim, j, n), alpha=float(taps[j]))
    return out


def crf_inference_torch(img, probs, t: int = 10, sxy_g: float = 3.0,
                        compat_g: float = 3.0, sxy_b: float = 80.0,
                        srgb: float = 13.0, compat_b: float = 10.0,
                        device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """Dense-CRF mean-field approximation on ``device``: (H, W, 3) RGB and
    (L, H, W) unary probabilities -> (L, H, W) marginals, a tensor there.

    Messages, as ``crf_inference_jax``: the Gaussian kernel is a separable
    zero-padded filter; the bilateral kernel a splat, blur and slice on a
    regular 5-D grid over (y, x, R, G, B) with one cell per sigma, colour
    capped at ``MAX_COLOR_BINS`` bins, nearest-cell assignment, and each
    axis's blur one mode product with a banded matrix power
    (:func:`_band_power`). Cell indices truncate toward zero; colour 0 is
    the lowest bin, and the grid's two spare colour cells lie above the
    top one. The splat is JAX's ``scatter`` route (``index_add_`` and a
    gather; atomic on CUDA, so two runs on the card may differ in the last
    bits). All products run in float32 whatever the TF32 switches say.
    """
    img, probs = (x.to(device, torch.float32) if torch.is_tensor(x)
                  else torch.from_numpy(np.array(x, np.float32)).to(device)
                  for x in (img, probs))
    device = probs.device
    L, H, W = probs.shape
    if img.shape != (H, W, 3):
        raise ValueError(f"image {tuple(img.shape)} does not match probs {tuple(probs.shape)}")

    taps = _gaussian_taps(sxy_g)

    def gauss_filter(x):  # (C, H, W): the W axis, then the H axis
        return _filter_axis(_filter_axis(x, taps, -1), taps, -2)

    stride = max(2, int(round(sxy_b)))
    bins = min(MAX_COLOR_BINS, max(2, int(round(256.0 / max(srgb, 1.0)))))
    csize = 256.0 / bins
    gh, gw = H // stride + 2, W // stride + 2
    gcd = bins + 2
    n_sp = max(1, int(round(2.0 * (sxy_b / stride) ** 2)))
    n_co = max(1, int(round(2.0 * (srgb / csize) ** 2)))

    gy = torch.arange(H, device=device) // stride
    gx = torch.arange(W, device=device) // stride
    # A true division (a python-float divisor becomes a reciprocal product
    # on CUDA), truncated toward zero.
    rgb = (img / torch.tensor(csize, dtype=torch.float32, device=device)).long()
    rgb = rgb.clamp(0, gcd - 1)
    flat_idx = ((((gy[:, None] * gw + gx[None, :]) * gcd + rgb[..., 0]) * gcd
                 + rgb[..., 1]) * gcd + rgb[..., 2]).reshape(-1)
    grid_shape = (gh, gw, gcd, gcd, gcd)
    n_cells = gh * gw * gcd ** 3

    def band(n, passes):
        return torch.from_numpy(_band_power(n, passes)).to(device)

    B_h, B_w, B_c = band(gh, n_sp), band(gw, n_sp), band(gcd, n_co)

    def grid_filter(x):  # (C, H, W); the B matrices are symmetric
        C = x.shape[0]
        grid = torch.zeros((C, n_cells), device=device)
        grid.index_add_(1, flat_idx, x.reshape(C, -1))
        g5 = grid.reshape((C,) + grid_shape)
        g5 = torch.einsum("lhwabc,hH->lHwabc", g5, B_h)
        g5 = torch.einsum("lhwabc,wW->lhWabc", g5, B_w)
        g5 = torch.einsum("lhwabc,aA->lhwAbc", g5, B_c)
        g5 = torch.einsum("lhwabc,bB->lhwaBc", g5, B_c)
        g5 = torch.einsum("lhwabc,cC->lhwabC", g5, B_c)
        return g5.reshape(C, -1)[:, flat_idx].reshape(C, H, W)

    with _fp32_products():
        ones = torch.ones((1, H, W), device=device)
        norm_g = torch.rsqrt(torch.clamp(gauss_filter(ones), min=1e-20))
        norm_b = torch.rsqrt(torch.clamp(grid_filter(ones), min=1e-20))
        unary = -torch.log(torch.clamp(probs, min=1e-20))
        q = torch.softmax(-unary, dim=0)
        for _ in range(t):
            msg = compat_g * gauss_filter(q * norm_g) * norm_g
            msg = msg + compat_b * grid_filter(q * norm_b) * norm_b
            q = torch.softmax(-unary + msg, dim=0)
    return q
