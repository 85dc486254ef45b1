"""The configuration that training, CAM inference and evaluation read.

Own copy of the fields of ``acr_wsss_tpu/configs.py`` that the port uses,
with the same defaults (``ModelConfig``, ``TrainConfig``, ``InferConfig``,
``EvalConfig``).
The attention choice is named for the port: ``"kernel"`` (the hand-written
CUDA kernels) or ``"plain"`` (PyTorch everywhere); the JAX package's
``"pallas"`` and ``"xla"``. Entry points run on ``device="cuda"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

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
    # Compute the consistency L1 terms inside the attention kernel
    # (training only; needs attn_impl="kernel" and aligned_mirror): the
    # head-mean probs never reach device memory. False: the per-layer
    # export path.
    fuse_consistency: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """VOC training (reference ``train_acr.py:49-117``, ``train_acr.sh``)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    crop_size: int = 384
    batch_size: int = 4            # global batch (reference: 1/GPU x 4 GPUs)
    max_epochs: int = 10
    lr: float = 0.05
    weight_decay: float = 5e-4
    momentum: float = 0.9
    poly_power: float = 0.9        # lr * (1 - step/max_step) ** power
    alpha: float = 125.0           # consistency-loss weight (train_acr.sh:16)
    seed: int = 0
    log_every: int = 50
    val_every: int = 5000
    checkpoint_dir: str = "weight"
    session_name: str = "acr_tpu"
    image_dir: str = "voc/image/path"
    train_list: str = "voc12/train_aug_id.txt"
    val_list: str = "voc12/val_id.txt"
    cls_labels_path: str = "voc12/cls_labels.npy"
    num_workers: int = 8
    # Reference quirk: PolyOptimizer passes weight_decay into torch SGD's
    # momentum slot (tool/torchutils.py:12). True reproduces it.
    reference_optimizer_quirk: bool = False
    clip_grad_norm: float = 0.0    # global-norm clipping, 0 = off
    accum_steps: int = 1           # gradient accumulation micro-steps per update
    cache_decoded: bool = False
    # Un-mirror the flipped view's token order once after the pos-embed
    # instead of un-flipping every layer's (B, N, N) export in the loss.
    aligned_mirror: bool = True
    device: str = "cuda"


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
    # PAMR refinement iterations (0 = off, the reference behavior). When on,
    # each TTA view's CAM is refined at crop resolution by the crop's
    # pixel-adaptive affinities (``ops/pamr.py``) before TTA summation.
    pamr_iters: int = 0
    pamr_dilations: Sequence[int] = (1, 2, 4, 8, 12, 24)
    device: str = "cuda"


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Pseudo-mask mIoU evaluation (reference ``evaluation.py:106-133``)."""

    predict_dir: str = "output/cam_npy"
    gt_dir: str = "VOC2012/SegmentationClass"
    name_list: str = "voc12/train_id.txt"
    logfile: str = "evallog.txt"
    comment: str = ""
    input_type: str = "npy"        # npy | png
    threshold: Optional[float] = None
    curve: bool = False
    num_classes: int = 21
    num_workers: int = 8
