"""Host-side numpy image ops with ``F.interpolate`` semantics.

Own copy of ``acr_wsss_tpu/ops/imops.py::{resize_bilinear_np,
minmax_normalize, apply_colormap_jet, voc_colormap}``: the per-image
native-size resize and normalization of the CAM pipeline, which run on the
host, OpenCV's JET colormap of the heatmap dumps (``infer_cam.py:232-247``
of the reference) and the VOC palette (``tool/visualization.py:100-108``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def resize_bilinear_np(
    x: np.ndarray, size: Tuple[int, int], align_corners: bool = False
) -> np.ndarray:
    """Bilinear resize over the LAST TWO axes of ``x`` (..., H, W)."""
    h_out, w_out = size
    h_in, w_in = x.shape[-2], x.shape[-1]
    if (h_in, w_in) == (h_out, w_out):
        return x.copy()

    def src_grid(out_len: int, in_len: int) -> np.ndarray:
        if align_corners:
            if out_len == 1:
                return np.zeros(out_len, np.float64)
            return np.arange(out_len) * (in_len - 1) / (out_len - 1)
        coords = (np.arange(out_len) + 0.5) * in_len / out_len - 0.5
        return np.clip(coords, 0, in_len - 1)

    ys = src_grid(h_out, h_in)
    xs = src_grid(w_out, w_in)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h_in - 1)
    x1 = np.minimum(x0 + 1, w_in - 1)
    wy = (ys - y0).astype(x.dtype if x.dtype.kind == "f" else np.float64)
    wx = (xs - x0).astype(wy.dtype)

    top = x[..., y0, :][..., :, x0] * (1 - wy)[:, None] * (1 - wx) \
        + x[..., y0, :][..., :, x1] * (1 - wy)[:, None] * wx
    bot = x[..., y1, :][..., :, x0] * wy[:, None] * (1 - wx) \
        + x[..., y1, :][..., :, x1] * wy[:, None] * wx
    return (top + bot).astype(x.dtype if x.dtype.kind == "f" else np.float32)


_JET_ANCHORS = np.array([
    # value, (b, g, r): OpenCV COLORMAP_JET control points
    (0.000, (128, 0, 0)),
    (0.125, (255, 0, 0)),
    (0.375, (255, 255, 0)),
    (0.625, (0, 255, 255)),
    (0.875, (0, 0, 255)),
    (1.000, (0, 0, 128)),
], dtype=object)


def apply_colormap_jet(gray: np.ndarray) -> np.ndarray:
    """uint8 HxW -> BGR uint8 JET heatmap (cv2.applyColorMap equivalent)."""
    t = gray.astype(np.float32) / 255.0
    xs = np.array([a[0] for a in _JET_ANCHORS], np.float32)
    cols = np.array([a[1] for a in _JET_ANCHORS], np.float32)  # (K, 3) BGR
    out = np.stack([np.interp(t, xs, cols[:, c]) for c in range(3)], axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8)


def voc_colormap(n: int = 256) -> np.ndarray:
    """VOC palette: bit-twiddled (r, g, b) per label id."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        cid = i
        for j in range(8):
            r |= ((cid >> 0) & 1) << (7 - j)
            g |= ((cid >> 1) & 1) << (7 - j)
            b |= ((cid >> 2) & 1) << (7 - j)
            cid >>= 3
        cmap[i] = (r, g, b)
    return cmap


def minmax_normalize(cam: np.ndarray, axis=(1, 2), eps: float = 1e-6) -> np.ndarray:
    """Per-class [0, 1] normalization (reference ``infer_cam.py:209-215``)."""
    lo = cam.min(axis=axis, keepdims=True)
    hi = cam.max(axis=axis, keepdims=True)
    return (cam - lo) / (hi - lo + eps)
