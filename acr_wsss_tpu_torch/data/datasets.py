"""Dataset access layer: enumeration-style readers and affinity-label
extraction, on the host (numpy and PIL).

Own copy of ``acr_wsss_tpu/data/datasets.py`` (``:32-172``), the numpy
counterparts of the reference torch ``Dataset`` classes
(``voc12/data.py``) and its pair-index helper (``tool/pyutils.py:125-159``),
plain iterables of numpy arrays that the port's own ``data/transforms.py``
feeds (the resize is ``transforms.resize_hwc``, OpenCV's ``INTER_LINEAR``
written out in numpy):

* :class:`VOC12ImageDataset` / :class:`VOC12ClsDataset`: name -> image
  (and multi-hot label).
* :class:`VOC12ClsDatasetMSF`: multi-scale and flip enumeration per image
  (``voc12/data.py:137-166``): for each scale, the image and its mirror.
* :func:`radius_search_dist`, :func:`get_indices_of_pairs`: within-radius
  pair index sets for affinity training (PSA-style).
* :class:`ExtractAffinityLabelInRadius`: bg-pos / fg-pos / neg affinity
  targets from a pseudo label map (``voc12/data.py:169-219``).
* :class:`VOC12AffDataset`: la/ha CRF fusion into affinity targets
  (``voc12/data.py:222-278``): low-alpha argmax as base, fg of la -> 255
  unless confirmed, bg of ha -> 0, no-score -> 255.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from acr_wsss_tpu_torch.data import transforms


class VOC12ImageDataset:
    def __init__(self, names: Sequence[str], image_dir: str):
        self.names = list(names)
        self.image_dir = image_dir

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx: int):
        name = self.names[idx]
        img = transforms.load_image_rgb(
            os.path.join(self.image_dir, f"{name}.jpg"))
        return name, img


class VOC12ClsDataset(VOC12ImageDataset):
    def __init__(self, names, image_dir, labels: Dict[str, np.ndarray]):
        super().__init__(names, image_dir)
        self.labels = labels

    def __getitem__(self, idx: int):
        name, img = super().__getitem__(idx)
        return name, img, self.labels[name]


class VOC12ClsDatasetMSF(VOC12ClsDataset):
    """Yields (name, [scaled images + mirrors], label) per item."""

    def __init__(self, names, image_dir, labels,
                 scales: Sequence[float] = (1.0,), inter_transform=None):
        super().__init__(names, image_dir, labels)
        self.scales = tuple(scales)
        self.inter_transform = inter_transform

    def __getitem__(self, idx: int):
        name, img, label = super().__getitem__(idx)
        h, w = img.shape[:2]
        out: List[np.ndarray] = []
        for s in self.scales:
            target = (int(round(h * s)), int(round(w * s)))
            scaled = transforms.resize_hwc(img, target)
            if self.inter_transform is not None:
                scaled = self.inter_transform(scaled)
            out.append(scaled)
            out.append(scaled[:, ::-1].copy())
        return name, out, label


def radius_search_dist(radius: int) -> List[Tuple[int, int]]:
    """Forward half-disc of offsets within ``radius`` (excludes (0,0));
    matches the reference enumeration order."""
    dist = [(0, x) for x in range(1, radius)]
    for y in range(1, radius):
        for x in range(-radius + 1, radius):
            if x * x + y * y < radius * radius:
                dist.append((y, x))
    return dist


def get_indices_of_pairs(radius: int, size: Tuple[int, int]):
    """(indices_from, indices_to): flat pixel index pairs within radius."""
    search_dist = radius_search_dist(radius)
    rf = radius - 1
    full = np.arange(size[0] * size[1], dtype=np.int64).reshape(size)
    ch, cw = size[0] - rf, size[1] - 2 * rf
    indices_from = full[:-rf, rf:-rf].reshape(-1)
    indices_to = np.concatenate([
        full[dy:dy + ch, rf + dx:rf + dx + cw].reshape(-1)
        for dy, dx in search_dist
    ])
    return indices_from, indices_to


class ExtractAffinityLabelInRadius:
    """Pseudo-label map -> (bg_pos, fg_pos, neg) affinity targets."""

    def __init__(self, cropsize: int, radius: int = 5):
        self.search_dist = radius_search_dist(radius)
        self.rf = radius - 1
        self.crop_height = cropsize - self.rf
        self.crop_width = cropsize - 2 * self.rf

    def __call__(self, label: np.ndarray):
        rf = self.rf
        labels_from = label[:-rf, rf:-rf].reshape(-1)
        labels_to, valid = [], []
        for dy, dx in self.search_dist:
            lt = label[dy:dy + self.crop_height,
                       rf + dx:rf + dx + self.crop_width].reshape(-1)
            labels_to.append(lt)
            valid.append((lt < 255) & (labels_from < 255))
        labels_to = np.stack(labels_to)
        valid = np.stack(valid)

        pos = labels_from[None] == labels_to
        bg_pos = (pos & (labels_from[None] == 0)).astype(np.float32)
        fg_pos = (pos & (labels_from[None] != 0) & valid).astype(np.float32)
        neg = (~pos & valid).astype(np.float32)
        return bg_pos, fg_pos, neg


class VOC12AffDataset(VOC12ImageDataset):
    """Affinity-training dataset over low/high-alpha CRF CAM dicts."""

    def __init__(self, names, image_dir, label_la_dir: str, label_ha_dir: str,
                 cropsize: int, radius: int = 5):
        super().__init__(names, image_dir)
        self.label_la_dir = label_la_dir
        self.label_ha_dir = label_ha_dir
        self.cropsize = cropsize
        # affinity is learned on the stride-8 grid
        self.extract = ExtractAffinityLabelInRadius(cropsize // 8, radius)

    def fuse_la_ha(self, label_la: Dict, label_ha: Dict) -> np.ndarray:
        """la/ha fusion (reference ``voc12/data.py:258-270``)."""
        label = np.array(list(label_la.values()) + list(label_ha.values()))
        label = np.transpose(label, (1, 2, 0))
        no_score = np.max(label, -1) < 1e-5
        la, ha = np.array_split(label, 2, axis=-1)
        la = np.argmax(la, axis=-1).astype(np.uint8)
        ha = np.argmax(ha, axis=-1).astype(np.uint8)
        fused = la.copy()
        fused[la == 0] = 255
        fused[ha == 0] = 0
        fused[no_score] = 255
        return fused

    def __getitem__(self, idx: int):
        name, img = super().__getitem__(idx)
        label_la = np.load(os.path.join(self.label_la_dir, f"{name}.npy"),
                           allow_pickle=True).item()
        label_ha = np.load(os.path.join(self.label_ha_dir, f"{name}.npy"),
                           allow_pickle=True).item()
        fused = self.fuse_la_ha(label_la, label_ha)
        # center-crop/resize to the crop grid then downsample to stride 8
        from PIL import Image

        s8 = self.cropsize // 8
        fused = np.asarray(
            Image.fromarray(fused).resize((s8, s8), Image.NEAREST))
        return img, self.extract(fused)
