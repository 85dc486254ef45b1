"""Visualization helpers: palettes, segmentation colorization, heatmaps.

Own copy of ``acr_wsss_tpu/utils/visualization.py``, the counterparts of
the reference's ``tool/visualization.py`` and the ``decode_segmap`` /
palette tables of ``myTool.py:1713-1813``. Host numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from acr_wsss_tpu_torch.ops.imops import apply_colormap_jet, voc_colormap


def get_pascal_labels() -> np.ndarray:
    """21 VOC class colors (RGB), the canonical table."""
    return voc_colormap(256)[:21].astype(np.uint8)


def decode_segmap(label_mask: np.ndarray, dataset: str = "pascal",
                  n_classes: Optional[int] = None) -> np.ndarray:
    """Label map -> float RGB in [0, 1]; 255 (ignore) renders black."""
    if dataset in ("pascal", "voc"):
        n_classes = n_classes or 21
        colors = get_pascal_labels()
    elif dataset == "coco":
        n_classes = n_classes or 81
        colors = voc_colormap(256)[:n_classes]
    else:
        raise ValueError(f"unknown dataset {dataset!r}")

    mask = label_mask.astype(np.int64)
    safe = np.where((mask >= 0) & (mask < n_classes), mask, 0)
    rgb = colors[safe].astype(np.float32) / 255.0
    rgb[(mask < 0) | (mask >= n_classes)] = 0.0
    return rgb


def voc_label_to_colormap_png(label: np.ndarray):
    """Palettized PIL image for VOC-style pseudo-mask PNGs."""
    from PIL import Image

    img = Image.fromarray(label.astype(np.uint8), mode="P")
    img.putpalette(voc_colormap(256).reshape(-1).tolist())
    return img


def color_pro(pro: np.ndarray, img: Optional[np.ndarray] = None,
              mode: str = "hwc") -> np.ndarray:
    """JET-colorize a [0,1] probability map, optionally blended 50/50 with
    the image (reference ``tool/visualization.py:8-27``). Returns RGB uint8."""
    heat = apply_colormap_jet(np.uint8(255 * np.clip(pro, 0, 1)))[..., ::-1]
    if img is None:
        return heat
    if mode == "chw":
        img = img.transpose(1, 2, 0)
    return (0.5 * heat + 0.5 * img).astype(np.uint8)


def max_norm(cam: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    """Per-channel max normalization after ReLU (reference
    ``tool/visualization.py:54-83`` semantics, numpy variant)."""
    cam = np.maximum(cam, 0)
    mx = cam.max(axis=(-2, -1), keepdims=True)
    return cam / (mx + eps)


def generate_vis(prob: np.ndarray, img: np.ndarray) -> np.ndarray:
    """Panel of per-class JET overlays (reference ``generate_vis``)."""
    return np.stack([color_pro(prob[c], img) for c in range(prob.shape[0])])
