"""Swin-backbone ACR training: multilabel soft margin on both views plus
alpha times the window-attention consistency, on one device.

Counterpart of ``acr_wsss_tpu/train_swin.py`` (``BASELINE.json`` config
5): the image and its horizontal flip go through a Swin of the registry
(``models/registry.py``) as one doubled batch; each block's head-mean
window probabilities of the flip are un-mirrored by
``losses.swin_window_consistency_loss`` and held to the view's by L1,
averaged over the blocks. Shifted blocks are un-mirrored by the roll-aware
permutation wherever ``2*shift % ws == 0`` (every even window, e.g.
swin_base_384's 12); shifted blocks of an odd window are skipped.

    python -m acr_wsss_tpu_torch.train_swin --IMpath JPEGs \\
        --train_list train.txt --cls_labels labels.npy [--model swin_base_384]

The loop runs ``len(names) // batch_size * max_epoches`` updates (plus the
step at the end of the range, as JAX's does), writes
``<weight_dir>/<session>_snapshot.npz`` every ``--save_every`` steps and on
SIGTERM or SIGINT (then stops), and ``<session>_last.npz`` only when it
finishes: flat flax npz files that the JAX ``SwinTransformer`` loads.
``--pretrained`` grafts ``<ACR_WSSS_ZOO>/<model>_in21k.npz`` onto the
seeded init (``zoo.graft_standalone``). One device; data parallelism for
Swin is not ported.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from acr_wsss_tpu_torch import losses
from acr_wsss_tpu_torch.configs import ModelConfig, TrainConfig
from acr_wsss_tpu_torch.data import device_aug
from acr_wsss_tpu_torch.data import voc as voc_data
from acr_wsss_tpu_torch.models import zoo
from acr_wsss_tpu_torch.models.acr import init_random_
from acr_wsss_tpu_torch.models.convert import state_dict_to_flax
from acr_wsss_tpu_torch.models.registry import create_model
from acr_wsss_tpu_torch.train import TrainState
from acr_wsss_tpu_torch.utils.checkpoint import save_params_npz
from acr_wsss_tpu_torch.utils.meters import AverageMeter, Timer
from acr_wsss_tpu_torch.utils.preemption import PreemptionGuard
from acr_wsss_tpu_torch.utils.schedule import PolySGD, make_optimizer


def swin_block_layout(model, crop_size: int):
    """Static (n_rows, n_cols, ws, shift) per block for a square input."""
    layout = []
    grid = crop_size // model.patch_size
    for depth in model.depths:
        for bi in range(depth):
            ws = min(model.window_size, grid)
            g = grid + (ws - grid % ws) % ws
            shift = model.window_size // 2 if bi % 2 == 1 and ws < grid else 0
            layout.append((g // ws, g // ws, ws, shift))
        grid = (grid + 1) // 2
    return layout


def consistency_blocks(layout) -> List[int]:
    """Indices of the blocks the consistency covers: all but the shifted
    blocks of an odd window, which no permutation un-mirrors."""
    return [i for i, (_, _, ws, shift) in enumerate(layout)
            if not (shift and (2 * shift) % ws != 0)]


def make_swin_train_step(model, optimizer: PolySGD, cfg: TrainConfig, crop_size: int,
                         device: torch.device):
    """batch {"image" (B, H, W, 3), "label" (B, C)}, or a packed
    ``--device_aug`` batch -> loss parts (detached tensors on ``device``):
    one forward of both views, backward and optimizer call. The step's
    ``blocks`` attribute lists the blocks the consistency averages."""
    layout = swin_block_layout(model, crop_size)
    blocks = consistency_blocks(layout)
    alpha = cfg.alpha

    def loss_fn(x1: torch.Tensor, labels: torch.Tensor):
        b = x1.shape[0]
        out = model(torch.cat([x1, torch.flip(x1, dims=(2,))], dim=0))
        logits1, logits2 = out["logits"][:b], out["logits"][b:]
        cls1 = losses.multilabel_soft_margin_loss(logits1, labels)
        cls2 = losses.multilabel_soft_margin_loss(logits2, labels)
        cons = 0.0
        for i in blocks:
            probs = out["window_probs"][i]
            cons = cons + losses.swin_window_consistency_loss(probs[:b], probs[b:],
                                                              *layout[i])
        cons = cons / max(len(blocks), 1)
        total = cls1 + cls2 + alpha * cons
        return total, {"loss": total, "cls_loss_1": cls1, "cls_loss_2": cls2,
                       "window_consistency": torch.as_tensor(cons, device=device)}

    def train_step(batch) -> Dict[str, torch.Tensor]:
        batch = device_aug.materialize_batch(batch, crop_size, device)
        x1 = torch.as_tensor(batch["image"], dtype=torch.float32).to(device)
        labels = torch.as_tensor(np.asarray(batch["label"], np.float32)).to(device)
        total, parts = loss_fn(x1, labels)
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in parts.items()}

    train_step.blocks = blocks
    return train_step


def create_swin_train_state(cfg: TrainConfig, max_step: int, model_name: str = "swin_base_384",
                            pretrained: bool = False):
    """(model, optimizer): the registry's ``model_name`` for
    ``cfg.crop_size`` with seeded random weights (``cfg.seed``), grafted
    from the zoo npz with ``pretrained`` (the head keeps its init), on
    ``cfg.device``."""
    model = create_model(model_name, num_classes=cfg.model.num_classes,
                         dtype=getattr(torch, cfg.model.compute_dtype), img_size=cfg.crop_size)
    init_random_(model, seed=cfg.seed)
    if pretrained:
        zoo.graft_standalone(model, zoo.load_backbone_params(model_name))
    model.to(cfg.device)
    optimizer = make_optimizer(model.parameters(), cfg.lr, max_step, cfg.weight_decay,
                               cfg.momentum, cfg.poly_power)
    return model, optimizer


def main(argv: Optional[List[str]] = None) -> TrainState:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="swin_base_384")
    parser.add_argument("--batch_size", default=4, type=int)
    parser.add_argument("--max_epoches", default=10, type=int)
    parser.add_argument("--lr", default=0.05, type=float)
    parser.add_argument("--alpha", default=125, type=float)
    parser.add_argument("--crop_size", default=384, type=int)
    parser.add_argument("--IMpath", required=True)
    parser.add_argument("--train_list", default="voc12/train_aug_id.txt")
    parser.add_argument("--cls_labels", default="voc12/cls_labels.npy")
    parser.add_argument("--session_name", default="acr_swin")
    parser.add_argument("--pretrained", action="store_true",
                        help="graft ImageNet weights from the zoo npz "
                             "(<ACR_WSSS_ZOO>/<model>_in21k.npz)")
    parser.add_argument("--device_aug", action="store_true",
                        help="resize, flip, normalize and crop on the device from uint8 "
                             "rasters (data/device_aug.py)")
    parser.add_argument("--aug_pad", default=512, type=int,
                        help="static pad square for --device_aug rasters")
    parser.add_argument("--cache_decoded", action="store_true",
                        help="cache decoded uint8 rasters in RAM")
    parser.add_argument("--weight_dir", default="weight")
    parser.add_argument("--save_every", default=5000, type=int,
                        help="periodic npz snapshot cadence in steps (reference "
                             "train_acr.py:189-196 saves every 5000)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = TrainConfig(model=ModelConfig(backbone=args.model), batch_size=args.batch_size,
                      max_epochs=args.max_epoches, lr=args.lr, alpha=args.alpha,
                      crop_size=args.crop_size, image_dir=args.IMpath,
                      train_list=args.train_list, cls_labels_path=args.cls_labels,
                      session_name=args.session_name, device=args.device)
    device = torch.device(cfg.device)
    names = voc_data.read_file(cfg.train_list)
    max_step = len(names) // cfg.batch_size * cfg.max_epochs
    model, optimizer = create_swin_train_state(cfg, max_step, args.model, args.pretrained)
    step_fn = make_swin_train_step(model, optimizer, cfg, cfg.crop_size, device)
    source = voc_data.VOCClassificationSource(
        cfg.image_dir, voc_data.load_cls_labels(cfg.cls_labels_path), cfg.crop_size,
        cache_decoded=args.cache_decoded)
    it = voc_data.TrainIterator(source, names, cfg.batch_size, device_aug=args.device_aug,
                                aug_pad=args.aug_pad)
    meter, timer = AverageMeter("loss"), Timer("Session started: ")
    state = TrainState(model, optimizer)

    os.makedirs(args.weight_dir, exist_ok=True)
    # _last.npz means "training finished" to later stages; mid-run snapshots
    # (periodic and on preemption) go to _snapshot.npz.
    final_path = os.path.join(args.weight_dir, f"{cfg.session_name}_last.npz")
    snap_path = os.path.join(args.weight_dir, f"{cfg.session_name}_snapshot.npz")

    def save(path: str, tag: str = "") -> None:
        save_params_npz(path, state_dict_to_flax(model))
        print(f"model saved{tag}: {path}", flush=True)

    try:
        # The next batch is loaded while the device runs this step; the
        # loss parts' read is the step's one sync.
        batch = next(it)
        with PreemptionGuard() as guard:
            for step in range(max_step + 1):
                parts = step_fn(batch)
                if step < max_step:
                    batch = next(it)
                values = dict(zip(parts, torch.stack(list(parts.values())).tolist()))
                state.history.append(values)
                state.steps += 1
                state.step += 1
                meter.add({"loss": values["loss"]})
                if step % 50 == 0:
                    timer.update_progress(max(step, 1) / max_step)
                    print(f"Iter:{step:5d}/{max_step}", "Loss:%.4f" % meter.pop("loss"),
                          "Fin:%s" % timer.str_est_finish(), flush=True)
                if step and args.save_every and step % args.save_every == 0:
                    save(snap_path, f" (step {step})")
                if guard.fired:
                    save(snap_path, f" (preempted at step {step})")
                    return state
    finally:
        it.close()
    save(final_path)
    return state


if __name__ == "__main__":
    main()
