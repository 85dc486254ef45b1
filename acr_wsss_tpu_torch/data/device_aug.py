"""Training augmentation on the batch's device: counterpart of
``acr_wsss_tpu/data/device_aug.py``.

The host decodes the JPEG and ships the original uint8 raster, zero-padded
to a static ``aug_pad`` square, with a 9-integer descriptor of the
augmentation that ``transforms.train_aug_params`` drew from the same rng
stream as the host chain (``pack_example``). On the device,

  resize (bilinear, half-pixel centres, border replicate: cv2.resize
  INTER_LINEAR) -> horizontal flip -> ImageNet normalize -> pad-crop

composes into one separable bilinear gather per example: the crop reads
integer pixels of the resized grid, so output pixel (i, j) is a bilinear
sample of the original at an affine position, and no resized image
exists. The index arithmetic is JAX's (``:59-100``): floor, fraction,
clip to the source, flip on the clipped column, then gather; pixels of
the crop outside the resized image are 0, as the host crop's padding is.
The JAX version is XLA, not a Pallas kernel, so this one is plain torch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from acr_wsss_tpu_torch.configs import IMAGENET_MEAN, IMAGENET_STD
from acr_wsss_tpu_torch.data.transforms import AugParams

# Order of the packed integer descriptor (one row per example).
AUG_FIELDS = ("src_h", "src_w", "resized_h", "resized_w", "flip",
              "cont_top", "cont_left", "img_top", "img_left")


def pack_example(img_u8: np.ndarray, p: AugParams, pad_to: int) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad the original uint8 raster to (pad_to, pad_to, 3) and pack
    the augmentation descriptor. ``pad_to`` must cover the corpus's
    largest image (VOC: 500, COCO: 640)."""
    h, w = img_u8.shape[:2]
    if h > pad_to or w > pad_to:
        raise ValueError(f"image {h}x{w} exceeds aug_pad={pad_to}; raise TrainConfig.aug_pad")
    padded = np.zeros((pad_to, pad_to, 3), np.uint8)
    padded[:h, :w] = img_u8
    vec = np.asarray([getattr(p, f) for f in AUG_FIELDS], np.int32)
    return padded, vec


def device_augment(images_u8: torch.Tensor, aug: torch.Tensor, crop: int) -> torch.Tensor:
    """(B, pad, pad, 3) uint8 + (B, 9) int -> (B, crop, crop, 3) float32,
    normalized, the pad region 0, on ``images_u8``'s device."""
    dev = images_u8.device
    b, pad = images_u8.shape[0], images_u8.shape[2]
    h, w, rh, rw, flip, cont_top, cont_left, img_top, img_left = (
        aug.to(dev, torch.int64).unbind(1))

    def col(t):                                                 # (B,) -> (B, 1)
        return t[:, None]

    i = torch.arange(crop, device=dev)[None]                    # (1, crop)
    valid_r = (i >= col(cont_top)) & (i < col(cont_top + rh.clamp(max=crop)))
    valid_c = (i >= col(cont_left)) & (i < col(cont_left + rw.clamp(max=crop)))

    # crop pixel (i, j) reads resized-then-flipped pixel (r, c)
    r = torch.minimum((i - col(cont_top) + col(img_top)).clamp(min=0), col(rh) - 1)
    c = torch.minimum((i - col(cont_left) + col(img_left)).clamp(min=0), col(rw) - 1)
    c = torch.where(col(flip) > 0, col(rw) - 1 - c, c)

    # resized pixel (r, c) = bilinear sample of the original at (y, x)
    y = (r.float() + 0.5) * col(h.float() / rh.float()) - 0.5   # (B, crop)
    x = (c.float() + 0.5) * col(w.float() / rw.float()) - 0.5
    y0f, x0f = torch.floor(y), torch.floor(x)
    wy = (y - y0f)[:, :, None, None]                            # (B, crop, 1, 1)
    wx = (x - x0f)[:, None, :, None]                            # (B, 1, crop, 1)
    y0 = torch.minimum(y0f.long().clamp(min=0), col(h) - 1)
    y1 = torch.minimum((y0f.long() + 1).clamp(min=0), col(h) - 1)
    x0 = torch.minimum(x0f.long().clamp(min=0), col(w) - 1)
    x1 = torch.minimum((x0f.long() + 1).clamp(min=0), col(w) - 1)

    def rows_at(idx):   # (B, crop) row indices -> (B, crop, pad, 3) float32
        return torch.gather(images_u8, 1, idx[:, :, None, None].expand(b, crop, pad, 3)).float()

    def cols_at(rows, idx):   # (B, crop) column indices -> (B, crop, crop, 3)
        return torch.gather(rows, 2, idx[:, None, :, None].expand(b, crop, crop, 3))

    rows = rows_at(y0) * (1.0 - wy) + rows_at(y1) * wy
    out = cols_at(rows, x0) * (1.0 - wx) + cols_at(rows, x1) * wx

    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev)
    out = (out / 255.0 - mean) / std
    valid = (valid_r[:, :, None] & valid_c[:, None, :])[..., None]
    return torch.where(valid, out, 0.0)


def materialize_batch(batch: dict, crop: int, device: torch.device) -> dict:
    """A packed ``{image_u8, aug, ...}`` batch of host arrays -> the same
    batch with ``image`` (B, crop, crop, 3) on ``device``; the uint8
    rasters go up from pinned memory. A host-augmented batch is returned
    as it is."""
    if "image_u8" not in batch:
        return batch
    batch = dict(batch)
    images = torch.from_numpy(np.ascontiguousarray(batch.pop("image_u8")))
    if device.type == "cuda":
        images = images.pin_memory()
    images = images.to(device, non_blocking=True)
    batch["image"] = device_augment(images, torch.from_numpy(batch.pop("aug")).to(device), crop)
    return batch
