"""ACR training on one device: siamese forward, ACR loss, backward, poly SGD.

Counterpart of ``acr_wsss_tpu/train.py`` (``:41-168``, ``:229-473``) in its
one-device form. A step runs the image and its horizontal flip through the
trunk as one doubled batch, with one of three loss branches
(``make_train_step``, ``:85-148``):

* fused (``fuse_consistency``, aligned mirror, kernel attention, the
  default): (view, mirror) pairs interleaved on the batch axis, the
  consistency L1 sums computed inside the pair attention kernel
  (``ops/attn_pair.py``) and normalized by ``losses.acr_total_loss_fused``;
* per-layer aligned: views stacked, the mirror's tokens un-flipped once in
  the trunk, each layer's head-mean export into
  ``losses.acr_total_loss_layers``;
* legacy unaligned: the same, with the un-flip of every layer's export in
  the loss.

    python -m acr_wsss_tpu_torch.train --IMpath JPEGs --cls_labels labels.npy \\
        --train_list train.txt --val_list val.txt --session_name acr

At the end the loop writes ``<checkpoint_dir>/<session>_last.npz`` in the
JAX package's flat flax format, which both packages' ``infer_cam`` read.

Not part of this module yet: resume from a checkpoint of model, optimizer
and step, the preemption guard, the hung-step watchdog, the profiler
window, multi-host and multi-GPU data parallelism, FSDP, the pipeline
mesh, device-side augmentation, ImageNet-pretrained initialization and
COCO.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from acr_wsss_tpu_torch import losses
from acr_wsss_tpu_torch.configs import ModelConfig, TrainConfig
from acr_wsss_tpu_torch.data import voc as voc_data
from acr_wsss_tpu_torch.models.acr import ACR, init_random_
from acr_wsss_tpu_torch.models.convert import state_dict_to_flax
from acr_wsss_tpu_torch.utils.checkpoint import save_params_npz
from acr_wsss_tpu_torch.utils.meters import AverageMeter, Timer
from acr_wsss_tpu_torch.utils.schedule import PolySGD, make_optimizer


@dataclasses.dataclass
class TrainState:
    """What ``train`` returns: the model, its optimizer, the number of
    train steps run and every step's loss parts."""

    model: ACR
    optimizer: PolySGD
    steps: int = 0
    history: List[Dict[str, float]] = dataclasses.field(default_factory=list)


def build_model(cfg: ModelConfig) -> ACR:
    return ACR(num_classes=cfg.num_classes, backbone_name=cfg.backbone,
               dtype=getattr(torch, cfg.compute_dtype), attn_impl=cfg.attn_impl)


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible; pass --device cpu to train on the CPU")
    return device


def create_train_state(cfg: TrainConfig, max_step: int) -> Tuple[ACR, PolySGD]:
    """The model with seeded random weights (``cfg.seed``) on ``cfg.device``
    and its optimizer; ``max_step`` counts optimizer updates."""
    model = init_random_(build_model(cfg.model), seed=cfg.seed).to(_device(cfg.device))
    optimizer = make_optimizer(
        model.parameters(), cfg.lr, max_step, cfg.weight_decay, cfg.momentum,
        cfg.poly_power, reference_quirk=cfg.reference_optimizer_quirk,
        clip_grad_norm=cfg.clip_grad_norm, accum_steps=cfg.accum_steps)
    return model, optimizer


def uses_fused_consistency(cfg: TrainConfig) -> bool:
    return (cfg.model.fuse_consistency and cfg.aligned_mirror
            and cfg.model.attn_impl == "kernel")


def make_train_step(model: ACR, optimizer: PolySGD, cfg: TrainConfig,
                    grid: Tuple[int, int]):
    """batch {"image" (B, H, W, 3), "label" (B, C)} -> loss parts (detached
    tensors on the device); one forward, backward and optimizer call."""
    alpha = cfg.alpha
    aligned = cfg.aligned_mirror
    fused = uses_fused_consistency(cfg)
    device = next(model.parameters()).device

    def loss_fn(x1, labels):
        x2 = torch.flip(x1, dims=(2,))          # horizontal flip (train_acr.py:135)
        b = x1.shape[0]
        if fused:
            xi = torch.stack([x1, x2], dim=1).reshape((2 * b,) + x1.shape[1:])
            out = model.forward_cls(xi, export="pair_l1",
                                    mirror_second_half="interleaved")
            return losses.acr_total_loss_fused(
                out["logits"][0::2], out["logits"][1::2], out["consistency_sums"],
                labels, out["n_tokens"], alpha)
        out = model.forward_cls(torch.cat([x1, x2], dim=0), mirror_second_half=aligned)
        return losses.acr_total_loss_layers(
            out["logits"][:b], out["logits"][b:], out["probs_layers"], labels, grid,
            alpha, aligned=aligned)

    def train_step(batch) -> Dict[str, torch.Tensor]:
        x1 = torch.as_tensor(np.asarray(batch["image"], np.float32)).to(device)
        labels = torch.as_tensor(np.asarray(batch["label"], np.float32)).to(device)
        total, parts = loss_fn(x1, labels)
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in parts.items()}

    return train_step


def make_eval_step(model: ACR):
    """batch {"image", "label", "weight"} -> (sum of weighted per-example
    MLSM losses, sum of weights). The weights let validation pad its last
    batch to the train batch size."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def eval_step(batch) -> Tuple[torch.Tensor, torch.Tensor]:
        image = torch.as_tensor(np.asarray(batch["image"], np.float32)).to(device)
        labels = torch.as_tensor(np.asarray(batch["label"], np.float32)).to(device)
        weight = torch.as_tensor(np.asarray(batch["weight"], np.float32)).to(device)
        logits = model.forward_cls(image, export="none")["logits"].float()
        per_class = -(labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))
        return (per_class.mean(dim=-1) * weight).sum(), weight.sum()

    return eval_step


def _dataset_setup(cfg: TrainConfig):
    """(train names, val names, label store) of a VOC12 layout."""
    return (voc_data.read_file(cfg.train_list), voc_data.read_file(cfg.val_list),
            voc_data.load_cls_labels(cfg.cls_labels_path))


def validate(cfg: TrainConfig, model: ACR, eval_step, val_names=None, labels=None) -> float:
    """Mean validation MLSM loss; the last batch is padded with zero-weight
    rows to the train batch size."""
    if labels is None:
        _, val_names, labels = _dataset_setup(cfg)
    source = voc_data.VOCClassificationSource(cfg.image_dir, labels, cfg.crop_size)
    bs = max(cfg.batch_size, 1)
    total, count = 0.0, 0.0
    for batch in voc_data.EvalIterator(source, val_names, batch_size=bs):
        n = batch["image"].shape[0]
        image, label = batch["image"], batch["label"]
        if n < bs:
            pad = bs - n
            image = np.concatenate([image, np.zeros((pad,) + image.shape[1:], image.dtype)])
            label = np.concatenate([label, np.zeros((pad,) + label.shape[1:], label.dtype)])
        weight = (np.arange(bs) < n).astype(np.float32)
        s, c = eval_step({"image": image, "label": label, "weight": weight})
        total += float(s)
        count += float(c)
    return total / max(count, 1.0)


def train(cfg: TrainConfig) -> TrainState:
    names, val_names, labels = _dataset_setup(cfg)
    steps_per_epoch = len(names) // cfg.batch_size
    # max_step counts optimizer updates (the poly horizon); with gradient
    # accumulation each update takes accum_steps micro-steps.
    max_step = steps_per_epoch * cfg.max_epochs
    accum = max(cfg.accum_steps, 1)
    total_micro_steps = max_step * accum

    model, optimizer = create_train_state(cfg, max_step)
    state = TrainState(model, optimizer)
    grid = (cfg.crop_size // 16, cfg.crop_size // 16)
    train_step = make_train_step(model, optimizer, cfg, grid)
    eval_step = make_eval_step(model)

    source = voc_data.VOCClassificationSource(cfg.image_dir, labels, cfg.crop_size,
                                              cache_decoded=cfg.cache_decoded)
    train_iter = voc_data.TrainIterator(source, names, cfg.batch_size, seed=cfg.seed,
                                        num_workers=cfg.num_workers)
    meter = AverageMeter("loss")
    timer = Timer("Session started: ")
    try:
        # The next batch is loaded while the device runs this step; the
        # step's loss read below is the sync point.
        batch = next(train_iter)
        for step in range(0, total_micro_steps + 1):
            parts = train_step(batch)
            if step < total_micro_steps:
                batch = next(train_iter)
            values = dict(zip(parts, torch.stack(list(parts.values())).tolist()))
            state.history.append(values)
            state.steps += 1
            meter.add({"loss": values["loss"]})

            if step % cfg.log_every == 0:
                timer.update_progress(max(step, 1) / total_micro_steps)
                imps = (step + 1) * cfg.batch_size / max(timer.get_stage_elapsed(), 1e-9)
                print(f"Iter:{step:5d}/{total_micro_steps:5d}",
                      "Loss:%.4f" % meter.pop("loss"), "imps:%.1f" % imps,
                      "Fin:%s" % timer.str_est_finish(), flush=True)

            if step and step % cfg.val_every == 0 and val_names:
                val_loss = validate(cfg, model, eval_step, val_names, labels)
                print("val loss: %.4f" % val_loss, flush=True)
    finally:
        train_iter.close()
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    save_params_npz(os.path.join(cfg.checkpoint_dir, f"{cfg.session_name}_last.npz"),
                    state_dict_to_flax(model))
    print("model saved!", flush=True)
    return state


def parse_args(argv: Optional[List[str]] = None) -> TrainConfig:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", default=4, type=int)
    parser.add_argument("--max_epoches", default=10, type=int)
    parser.add_argument("--lr", default=0.05, type=float)
    parser.add_argument("--wt_dec", default=5e-4, type=float)
    parser.add_argument("--train_list", default="voc12/train_aug_id.txt")
    parser.add_argument("--LISTpath", default=None,
                        help="reference-compatible alias of --train_list "
                             "(train_acr.py:60,107); overrides it")
    parser.add_argument("--val_list", default="voc12/val_id.txt")
    parser.add_argument("--num_workers", default=4, type=int,
                        help="host-side decode/augment threads")
    parser.add_argument("--backbone", default="vitb_hybrid")
    parser.add_argument("--alpha", default=125, type=float)
    parser.add_argument("--session_name", default="acr_tpu")
    parser.add_argument("--crop_size", default=384, type=int)
    parser.add_argument("--IMpath", default="voc/image/path")
    parser.add_argument("--cls_labels", default="voc12/cls_labels.npy")
    parser.add_argument("--attn_impl", default="kernel", choices=["kernel", "plain"])
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--accum_steps", default=1, type=int,
                        help="gradient accumulation micro-steps per update")
    parser.add_argument("--cache_decoded", action="store_true",
                        help="cache decoded uint8 images in memory")
    parser.add_argument("--clip_grad_norm", default=0.0, type=float,
                        help="global-norm gradient clipping (0 = off, the "
                             "reference behavior)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    return TrainConfig(
        model=ModelConfig(backbone=args.backbone, attn_impl=args.attn_impl),
        batch_size=args.batch_size, max_epochs=args.max_epoches, lr=args.lr,
        weight_decay=args.wt_dec, alpha=args.alpha, session_name=args.session_name,
        crop_size=args.crop_size, image_dir=args.IMpath,
        train_list=args.LISTpath or args.train_list, val_list=args.val_list,
        num_workers=args.num_workers, cls_labels_path=args.cls_labels, seed=args.seed,
        accum_steps=args.accum_steps, cache_decoded=args.cache_decoded,
        clip_grad_norm=args.clip_grad_norm, device=args.device)


def main(argv: Optional[List[str]] = None) -> None:
    train(parse_args(argv))


if __name__ == "__main__":
    main()
