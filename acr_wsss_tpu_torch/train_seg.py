"""Second training stage: the DPT segmentation model on pseudo masks.

Counterpart of ``acr_wsss_tpu/train_seg.py``: the DPT segmentation model
(``models/dpt.py``) from a seeded init, trained with SGD and poly decay on
the pseudo-mask PNGs that ``pseudo_label`` writes, by the bg/fg split
cross-entropy (``losses.compute_joint_ce``) and optionally the prototype
contrast term; then ``evaluate.seg_validation``'s mIoU on ground truth.

    python -m acr_wsss_tpu_torch.train_seg --IMpath JPEGs --pseudo_dir P \\
        --train_list train.txt [--val_list val.txt --gt_dir GT] [--device cpu]

It takes JAX's flags and its loop: ``max_step = len(names) // batch_size
* max_epoches``, ``range(max_step + 1)`` steps over the names in order,
crops from ``numpy.random.default_rng(0)``, an ``Iter:`` line every 50
steps. Weights go to ``<weight_dir>/<session>_snapshot.npz`` every
``--save_every`` steps and on SIGTERM or SIGINT (then the run stops), and
to ``<session>_last.npz`` at the end, in the JAX package's flat flax
format. The model runs with export "none": no step reads the attention
export, as JAX's ``jit`` drops it. The model is JAX's default, float32
with plain attention; ``DPTSegmentationModel(dtype=torch.bfloat16,
attn_impl="kernel")`` runs the CUDA kernels (K1n forward and K1b backward
with no de in each block), which no flag selects, as in JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from acr_wsss_tpu_torch import evaluate, losses
from acr_wsss_tpu_torch.data import transforms
from acr_wsss_tpu_torch.data import voc as voc_data
from acr_wsss_tpu_torch.models.acr import init_random_
from acr_wsss_tpu_torch.models.convert import state_dict_to_flax
from acr_wsss_tpu_torch.models.dpt import DPTSegmentationModel
from acr_wsss_tpu_torch.parallel.distributed import local_device
from acr_wsss_tpu_torch.utils.checkpoint import save_params_npz
from acr_wsss_tpu_torch.utils.meters import AverageMeter, Timer
from acr_wsss_tpu_torch.utils.preemption import PreemptionGuard
from acr_wsss_tpu_torch.utils.schedule import PolySGD, make_optimizer


@dataclasses.dataclass
class SegRun:
    """What ``train`` returns: the model, every step's loss parts, and the
    validation mIoU (None without ``--val_list`` and ``--gt_dir``, or when
    a signal stopped the run)."""

    model: DPTSegmentationModel
    history: List[Dict[str, float]]
    miou: Optional[float] = None


def make_seg_train_step(model: DPTSegmentationModel, optimizer: PolySGD,
                        contrast_weight: float = 0.0):
    """batch {"image" (B, H, W, 3) float32, "seg_label" (B, H, W) int} ->
    loss parts (detached tensors on the device); one forward, backward and
    optimizer call."""
    device = next(model.parameters()).device

    def step(batch) -> Dict[str, torch.Tensor]:
        x = torch.as_tensor(batch["image"], dtype=torch.float32).to(device)
        label = torch.as_tensor(batch["seg_label"]).to(device)
        seg_logits = model(x, export="none")["seg_logits"]            # (B, C, H, W)
        ce = losses.compute_joint_ce(seg_logits, label)
        total = ce
        parts = {"ce_loss": ce}
        if contrast_weight > 0:
            flat = seg_logits.flatten(2)
            # the class scores double as the feature field at this head
            contrast = losses.prototype_contrast_loss(flat, flat, flat.shape[1])
            total = total + contrast_weight * contrast
            parts["contrast"] = contrast
        parts["loss"] = total
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in parts.items()}

    return step


def load_seg_batch(image_dir: str, pseudo_dir: str, names: Sequence[str], crop_size: int,
                   rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Each name's JPEG, normalized, and its pseudo-mask PNG, through one
    ``random_scale_crop`` (scale 0.75-1.25)."""
    imgs, labels = [], []
    for name in names:
        img = transforms.normalize(
            transforms.load_image_rgb(os.path.join(image_dir, f"{name}.jpg")))
        mask = np.asarray(Image.open(os.path.join(pseudo_dir, f"{name}.png")))
        crop_img, crop_mask = transforms.random_scale_crop(img, mask, crop_size, rng,
                                                           scale_range=(0.75, 1.25))
        imgs.append(crop_img)
        labels.append(crop_mask)
    return {"image": np.stack(imgs).astype(np.float32),
            "seg_label": np.stack(labels).astype(np.int32)}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--IMpath", required=True)
    parser.add_argument("--pseudo_dir", required=True, help="directory of pseudo-mask PNGs")
    parser.add_argument("--train_list", default="voc12/train_aug_id.txt")
    parser.add_argument("--backbone", default="vitb_hybrid")
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--max_epoches", default=20, type=int)
    parser.add_argument("--lr", default=0.01, type=float)
    parser.add_argument("--crop_size", default=384, type=int)
    parser.add_argument("--session_name", default="acr_seg")
    parser.add_argument("--weight_dir", default="weight")
    parser.add_argument("--save_every", default=5000, type=int,
                        help="periodic npz snapshot cadence in steps (reference saves "
                             "every 5000)")
    parser.add_argument("--val_list", default=None,
                        help="run evaluate.seg_validation on these names after training "
                             "(myTool.py:1826-1895)")
    parser.add_argument("--gt_dir", default=None, help="ground-truth PNGs for --val_list")
    parser.add_argument("--contrast_weight", default=0.0, type=float)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def train(args: argparse.Namespace) -> SegRun:
    device = local_device(args.device)
    names = voc_data.read_file(args.train_list)
    max_step = len(names) // args.batch_size * args.max_epoches
    model = init_random_(DPTSegmentationModel(num_classes=21, backbone_name=args.backbone),
                         seed=0).to(device)
    optimizer = make_optimizer(model.parameters(), args.lr, max_step)
    step_fn = make_seg_train_step(model, optimizer, args.contrast_weight)
    run = SegRun(model, [])

    rng = np.random.default_rng(0)
    meter, timer = AverageMeter("loss"), Timer("Session started: ")

    def next_batch(step):
        batch_names = [names[(step * args.batch_size + i) % len(names)]
                       for i in range(args.batch_size)]
        return load_seg_batch(args.IMpath, args.pseudo_dir, batch_names, args.crop_size, rng)

    os.makedirs(args.weight_dir, exist_ok=True)
    # _last.npz means "training finished"; mid-run snapshots (periodic and
    # on a signal) go to _snapshot.npz, so a partial model never carries
    # the final name.
    last_path = os.path.join(args.weight_dir, f"{args.session_name}_last.npz")
    snap_path = os.path.join(args.weight_dir, f"{args.session_name}_snapshot.npz")

    # The next batch is loaded while the device runs this step; the loss
    # read is the step's sync point.
    batch = next_batch(0)
    with PreemptionGuard() as guard:
        for step in range(max_step + 1):
            parts = step_fn(batch)
            if step < max_step:
                batch = next_batch(step + 1)
            values = dict(zip(parts, torch.stack(list(parts.values())).tolist()))
            run.history.append(values)
            meter.add({"loss": values["loss"]})
            if step % 50 == 0:
                timer.update_progress(max(step, 1) / max_step)
                print(f"Iter:{step:5d}/{max_step}", "Loss:%.4f" % meter.pop("loss"),
                      flush=True)
            if step and args.save_every and step % args.save_every == 0:
                save_params_npz(snap_path, state_dict_to_flax(model))
                print(f"model saved (step {step}): {snap_path}", flush=True)
            if guard.fired:
                save_params_npz(snap_path, state_dict_to_flax(model))
                print(f"model saved (preempted at step {step}): {snap_path}", flush=True)
                return run

    save_params_npz(last_path, state_dict_to_flax(model))
    print("model saved!", flush=True)

    if args.val_list and args.gt_dir:
        @torch.no_grad()
        def predict_fn(x: np.ndarray) -> np.ndarray:
            x = torch.from_numpy(x).to(device)
            return model(x, export="none")["seg_logits"][0].cpu().numpy()

        run.miou = evaluate.seg_validation(predict_fn, voc_data.read_file(args.val_list),
                                           args.IMpath, args.gt_dir,
                                           crop_size=args.crop_size)
        print("seg val mIoU: %.4f" % run.miou, flush=True)
    return run


def main(argv: Optional[List[str]] = None) -> Optional[float]:
    """The CLI; returns the validation mIoU, as JAX's ``main`` does."""
    return train(parse_args(argv)).miou


if __name__ == "__main__":
    main()
