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
    # dtype of the exported head-mean probabilities on the kernel path
    # (K1f's export, K1b's de): "bfloat16" halves that traffic; "float32"
    # matches the reference. The plain path and the fused branch export in
    # float32 whatever it says; CAM inference builds its model without it.
    probs_dtype: str = "float32"
    # Hybrid stem only: the 7x7/2 stem conv as space-to-depth and a folded
    # 4x4/1 conv (same parameters and outputs; models/hybrid.py).
    s2d_stem: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """VOC training (reference ``train_acr.py:49-117``, ``train_acr.sh``)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    dataset: str = "voc12"         # voc12 | coco
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
    # Step-numbered checkpoints of model, optimizer and step under
    # <checkpoint_dir>/<session_name>/ (utils/checkpoint.py); a run resumes
    # from the latest one.
    checkpoint_every: int = 5000
    checkpoint_dir: str = "weight"
    session_name: str = "acr_tpu"
    image_dir: str = "voc/image/path"
    train_list: str = "voc12/train_aug_id.txt"
    val_list: str = "voc12/val_id.txt"
    # COCO: the separate validation image directory (reference --valpath);
    # None validates from image_dir (VOC's one JPEGImages directory).
    val_image_dir: Optional[str] = None
    # VOC: the cls_labels npy; COCO: the directory of per-image bbox txts.
    cls_labels_path: str = "voc12/cls_labels.npy"
    num_workers: int = 8
    # Reference quirk: PolyOptimizer passes weight_decay into torch SGD's
    # momentum slot (tool/torchutils.py:12). True reproduces it.
    reference_optimizer_quirk: bool = False
    clip_grad_norm: float = 0.0    # global-norm clipping, 0 = off
    accum_steps: int = 1           # gradient accumulation micro-steps per update
    # Graft the trunk from the zoo npz <ACR_WSSS_ZOO>/<backbone>_in21k.npz
    # (models/zoo.py); the head keeps its seeded init.
    pretrained: bool = False
    # Ship uint8 rasters padded to aug_pad^2 and a 9-int descriptor per
    # example; resize, flip, normalize and crop run on the batch's device
    # (data/device_aug.py). aug_pad must cover the largest image.
    device_aug: bool = False
    aug_pad: int = 512
    cache_decoded: bool = False
    # Un-mirror the flipped view's token order once after the pos-embed
    # instead of un-flipping every layer's (B, N, N) export in the loss.
    aligned_mirror: bool = True
    # A torch.profiler trace of steps 10-20 is written here (None = off).
    profile_dir: Optional[str] = None
    # Hung-step watchdog (utils/watchdog.py): exit 75 when no step completes
    # within this many seconds after the first one; 0 = off.
    step_timeout_s: float = 0.0
    # Data parallelism (parallel/): one process per GPU over a "data" mesh.
    # (-1,): every rank, cut to the largest divisor of the global batch;
    # the JAX package's model, seq and pipe axes are refused.
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axes: Tuple[str, ...] = ("data",)
    # The launcher's environment (RANK, WORLD_SIZE, ...) is required: the
    # nodes of a multi-node run join one process group.
    multihost: bool = False
    # FSDP2 (ZeRO-3) over the data axis instead of DDP: parameters,
    # gradients and momentum sharded; the same step.
    fsdp: bool = False
    device: str = "cuda"


@dataclasses.dataclass(frozen=True)
class InferConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    # "voc12": labels from the cls_labels npy; "coco": names from
    # infer_list (or the image directory), labels from the bbox txts in
    # cls_labels_path.
    dataset: str = "voc12"
    weights: str = "weight/acr_tpu_last"
    crop_size: int = 384
    start_layer: int = 10
    getam_func: str = "grad"           # grad | grad_s | cam_grad | cam_grad_s
    use_aff: bool = True
    scales: Sequence[float] = (1.0,)
    flip_tta: bool = True
    out_cam: str = ""
    # Background-power CRF fusion of each CAM dict at both alphas, written
    # under <out_crf>_<alpha>/ (reference ``infer_cam.py:218-225``); JET
    # heatmap JPEGs under ``heatmap``. None: not written.
    out_crf: Optional[str] = None
    heatmap: Optional[str] = None
    low_alpha: int = 1
    high_alpha: int = 12
    # The --out_crf stage on the device (``ops/crf.py::crf_inference_torch``
    # at one (crf_pad, crf_pad) bucket) instead of the host engine; images
    # larger than the bucket still take the host engine, counted by ``run``.
    crf_device: bool = False
    crf_pad: int = 512
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
    # Data-parallel inference (0/1 = one process): one worker process per
    # GPU, each on its share of the list (``data/voc.py::shard_names``).
    dp: int = 0
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
