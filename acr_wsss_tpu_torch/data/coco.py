"""MS-COCO 2014 labels and names (80-class multi-label WSSS): own copy of
``acr_wsss_tpu/data/coco.py`` (``:37-79``).

Image names come from listing the image directory; multi-hot labels are
parsed per image from bbox txt files whose third space-separated field is
the COCO category id (reference ``myTool.py:1497-1514``), mapped to a
dense 0..79 index through the 90-id category table. The VOC transforms
and iterators (``data/voc.py``) apply unchanged; only the labels differ.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Sequence

import numpy as np

# The 80 COCO category ids in ascending order (the 90-id space has gaps);
# dense index = position in this tuple.
COCO_CATEGORY_IDS = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90,
)
CATEGORY_TO_INDEX: Dict[int, int] = {cid: i for i, cid in enumerate(COCO_CATEGORY_IDS)}
NUM_CLASSES = 80


def list_image_names(image_dir: str) -> List[str]:
    """Sorted names of the ``.jpg`` files of ``image_dir`` (reference
    ``train_acr_coco.py:106``)."""
    return sorted(os.path.splitext(f)[0] for f in os.listdir(image_dir) if f.endswith(".jpg"))


def get_coco_cls_label(name: str, bbox_dir: str) -> np.ndarray:
    """Multi-hot (80,) label from ``<bbox_dir>/<name>.txt``; each line's
    third space-separated field is the category id."""
    label = np.zeros(NUM_CLASSES, np.float32)
    with open(os.path.join(bbox_dir, f"{name}.txt")) as f:
        for line in f:
            parts = line.split(" ")
            if len(parts) < 3:
                continue
            label[CATEGORY_TO_INDEX[int(parts[2])]] = 1.0
    return label


class CocoLabelStore(Mapping):
    """Lazy dict-like label lookup, so that the VOC iterators work
    unchanged."""

    def __init__(self, bbox_dir: str, names: Sequence[str]):
        self.bbox_dir = bbox_dir
        self._names = list(names)
        self._cache: Dict[str, np.ndarray] = {}

    def __getitem__(self, name: str) -> np.ndarray:
        if name not in self._cache:
            self._cache[name] = get_coco_cls_label(name, self.bbox_dir)
        return self._cache[name]

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)
