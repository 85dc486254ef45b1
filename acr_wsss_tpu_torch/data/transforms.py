"""Host-side image loading and the train and validation transforms, in
numpy and PIL.

Own copy of ``acr_wsss_tpu/data/transforms.py`` (``load_image_rgb``,
``val_transform`` and the training chain ``:75-199``: random resize of the
long side, horizontal flip, normalize, random crop; all randomness from an
explicit ``numpy.random.Generator``, drawn in the same order). The resize
has OpenCV's ``INTER_LINEAR`` semantics (half-pixel centres, two taps, no
antialiasing), which the JAX package gets from ``cv2.resize``; here it is
written out in numpy so that no OpenCV is needed.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

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


def resize_hwc(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an HWC image to (h, w) in float32."""
    chw = np.moveaxis(img.astype(np.float32), -1, 0)
    return np.moveaxis(resize_bilinear_np(chw, tuple(size_hw)), 0, -1)


def val_transform(img: np.ndarray, crop_size: int) -> np.ndarray:
    """Plain bilinear resize to crop^2, then normalize; (crop, crop, 3) f32."""
    return normalize(resize_hwc(img, (crop_size, crop_size)))


def random_resize_long(img: np.ndarray, min_long: int, max_long: int,
                       rng: np.random.Generator) -> np.ndarray:
    """Resize so the long side is uniform in [min_long, max_long]
    (reference ``RandomResizeLong``, ``myTool.py:995-1008``)."""
    target_long = int(rng.integers(min_long, max_long + 1))
    h, w = img.shape[:2]
    if w < h:
        shape = (target_long, int(round(w * target_long / h)))
    else:
        shape = (int(round(h * target_long / w)), target_long)
    return resize_hwc(img, shape)


def random_crop(img: np.ndarray, cropsize: int,
                rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Random square crop, zero-padded where the image is smaller
    (reference ``RandomCrop``, ``myTool.py:923-955``): (crop, valid mask)."""
    h, w = img.shape[:2]
    w_space, h_space = w - cropsize, h - cropsize
    if w_space > 0:
        cont_left, img_left = 0, int(rng.integers(0, w_space + 1))
    else:
        cont_left, img_left = int(rng.integers(0, -w_space + 1)), 0
    if h_space > 0:
        cont_top, img_top = 0, int(rng.integers(0, h_space + 1))
    else:
        cont_top, img_top = int(rng.integers(0, -h_space + 1)), 0
    p = AugParams(h, w, h, w, False, cont_top, cont_left, img_top, img_left)
    return apply_crop(img, p, cropsize)


class AugParams(NamedTuple):
    """Every random decision of one training augmentation, drawn up front
    (resize ``myTool.py:995-1008``, flip ``:1158-1199``, crop ``:923-955``)."""

    src_h: int        # original image height
    src_w: int        # original image width
    resized_h: int    # after the long-side resize
    resized_w: int
    flip: bool        # horizontal flip of the resized image
    cont_top: int     # paste offsets into the crop_size^2 container ...
    cont_left: int
    img_top: int      # ... and the matching read offsets into the image
    img_left: int


def train_aug_params(shape_hw: Tuple[int, int], crop_size: int,
                     rng: np.random.Generator) -> AugParams:
    """Draw one augmentation's parameters: the long side, the flip coin,
    then the crop offsets, width first (the reference's order)."""
    h, w = shape_hw
    min_long, max_long = int(crop_size * 0.9), int(crop_size / 0.875)
    target_long = int(rng.integers(min_long, max_long + 1))
    if w < h:
        rh, rw = target_long, int(round(w * target_long / h))
    else:
        rh, rw = int(round(h * target_long / w)), target_long
    flip = bool(rng.uniform() > 0.5)
    w_space, h_space = rw - crop_size, rh - crop_size
    if w_space > 0:
        cont_left, img_left = 0, int(rng.integers(0, w_space + 1))
    else:
        cont_left, img_left = int(rng.integers(0, -w_space + 1)), 0
    if h_space > 0:
        cont_top, img_top = 0, int(rng.integers(0, h_space + 1))
    else:
        cont_top, img_top = int(rng.integers(0, -h_space + 1)), 0
    return AugParams(h, w, rh, rw, flip, cont_top, cont_left, img_top, img_left)


def apply_crop(img: np.ndarray, p: AugParams,
               cropsize: int) -> Tuple[np.ndarray, np.ndarray]:
    """The deterministic crop for pre-drawn params: (crop, valid mask)."""
    h, w = img.shape[:2]
    ch, cw = min(cropsize, h), min(cropsize, w)
    container = np.zeros((cropsize, cropsize, img.shape[-1]), np.float32)
    cropping = np.zeros((cropsize, cropsize), bool)
    container[p.cont_top:p.cont_top + ch, p.cont_left:p.cont_left + cw] = \
        img[p.img_top:p.img_top + ch, p.img_left:p.img_left + cw]
    cropping[p.cont_top:p.cont_top + ch, p.cont_left:p.cont_left + cw] = True
    return container, cropping


def train_transform(img: np.ndarray, crop_size: int,
                    rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """The training chain: (normalized crop HWC float32, valid mask)."""
    p = train_aug_params(img.shape[:2], crop_size, rng)
    img = resize_hwc(img, (p.resized_h, p.resized_w))
    if p.flip:
        img = img[:, ::-1]
    img = normalize(img)
    return apply_crop(img, p, crop_size)
