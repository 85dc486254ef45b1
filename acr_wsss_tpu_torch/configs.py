"""The configuration the inference slice reads.

Own copy of the fields of ``acr_wsss_tpu/configs.py`` that CAM inference
uses, with the same defaults (``ModelConfig``, ``InferConfig``). The
attention choice is named for the port: ``"kernel"`` (the hand-written
CUDA forward for untapped blocks) or ``"plain"`` (PyTorch everywhere).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

VOC_CLASSES: Tuple[str, ...] = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)

VOC_CATEGORIES: Tuple[str, ...] = ("background",) + VOC_CLASSES

IMAGENET_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)


def parse_bool(s: str) -> bool:
    """Strict argparse bool for the ``--aff True/False`` style flags."""
    v = s.strip().lower()
    if v in ("true", "1", "yes", "on"):
        return True
    if v in ("false", "0", "no", "off"):
        return False
    raise ValueError(f"expected a boolean, got {s!r}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    backbone: str = "vitb_hybrid"
    num_classes: int = 20
    compute_dtype: str = "bfloat16"
    attn_impl: str = "kernel"          # kernel | plain


@dataclasses.dataclass(frozen=True)
class InferConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    weights: str = "weight/acr_tpu_last"
    crop_size: int = 384
    start_layer: int = 10
    getam_func: str = "grad"           # grad | grad_s | cam_grad | cam_grad_s
    use_aff: bool = True
    scales: Sequence[float] = (1.0,)
    flip_tta: bool = True
    out_cam: str = ""
    image_dir: str = "voc/image/path"
    infer_list: str = "voc12/train_id.txt"
    cls_labels_path: str = "voc12/cls_labels.npy"
    class_slots: int = 4
    batch_images: int = 1
    device: str = "cuda"
