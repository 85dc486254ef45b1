"""Host-side image loading and the validation transform, in numpy and PIL.

Own copy of ``acr_wsss_tpu/data/transforms.py::{load_image_rgb,
val_transform}``. The resize has OpenCV's ``INTER_LINEAR`` semantics
(half-pixel centres, two taps, no antialiasing), which the JAX package gets
from ``cv2.resize``; here it is written out in numpy so that no OpenCV is
needed.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageOps

from acr_wsss_tpu_torch.configs import IMAGENET_MEAN, IMAGENET_STD
from acr_wsss_tpu_torch.ops.imops import resize_bilinear_np


def load_image_rgb(path: str) -> np.ndarray:
    """uint8 HWC RGB, EXIF orientation applied."""
    with Image.open(path) as im:
        return np.asarray(ImageOps.exif_transpose(im).convert("RGB"))


def normalize(img: np.ndarray) -> np.ndarray:
    """[0, 255] HWC -> ImageNet-normalized float32."""
    img = img.astype(np.float32) / 255.0
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    return (img - mean) / std


def val_transform(img: np.ndarray, crop_size: int) -> np.ndarray:
    """Plain bilinear resize to crop^2, then normalize; (crop, crop, 3) f32."""
    chw = np.moveaxis(img.astype(np.float32), -1, 0)
    chw = resize_bilinear_np(chw, (crop_size, crop_size))
    return normalize(np.moveaxis(chw, 0, -1))
