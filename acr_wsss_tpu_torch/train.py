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

The loop (``:229-442``) saves a step-numbered checkpoint of model,
optimizer and step every ``checkpoint_every`` steps under
``<checkpoint_dir>/<session>/`` (``utils/checkpoint.py``), and a launch
resumes from the latest one at the step after it; the data iterator
starts again at epoch 0, as the JAX package's does. SIGTERM or SIGINT
(``utils/preemption.py``) saves a checkpoint at the next step boundary and
stops without the final npz. With ``step_timeout_s``, a step that does not
come back exits the process with 75 (``utils/watchdog.py``), which
``utils/supervisor.py`` relaunches. Metrics go to
``<checkpoint_dir>/<session>_metrics.jsonl`` every ``log_every`` steps;
``profile_dir`` gets a ``torch.profiler`` trace of steps 10-20. At the
end the loop writes ``<checkpoint_dir>/<session>_last.npz`` in the JAX
package's flat flax format, which both packages' ``infer_cam`` read.

Data parallelism (``:229-441`` under a data mesh; ``parallel/``): one
process per GPU, started by a launcher::

    torchrun --standalone --nproc_per_node 8 -m acr_wsss_tpu_torch.train \\
        --mesh data=8 [--fsdp] ...

joins a process group (NCCL; gloo on the CPU), and the ranks of the
data mesh (``--mesh data=-1``: the largest divisor of the global batch;
the rest idle) each take ``batch_size / ranks`` examples of every step
from their share of the data order (``TrainIterator``'s host sharding)
and train one model, wrapped in DDP or, with ``--fsdp``, sharded by FSDP2.
The loss parts and the validation loss are averaged over the ranks; rank
0 alone prints, writes metrics, traces and saves. A checkpoint holds the
one-device layout (FSDP's shards gathered), and any world size, with or
without FSDP, resumes from it. A preemption signal is agreed over the
ranks every ``log_every`` steps, so that all of them stop at one step.
``--multihost`` requires the launcher's environment (multi-node runs).

Tensor parallelism (``--mesh data=D,model=M``, JAX's ``:519-549`` and
``:273``): D x M ranks, rank ``d * M + m`` at data coordinate d and model
coordinate m. Every rank draws the one-device init and keeps its part
(``sharding.apply_tensor_parallel``: each block's heads and MLP hidden
units cut over the M model ranks), and DDP runs over the data sub-group.
The data order, the validation names and the loss averages follow the
data coordinate: the M ranks of one data coordinate read the same
examples and hold equal loss parts. The step takes the per-layer aligned
branch (K1f and K1b on each rank's H / M heads), not the fused one:
K2f's sums |mean_h p1 - mean_h p2| need the head mean of every head
(``uses_fused_consistency``). Checkpoints, the preemption flag and the
final npz are gathered and agreed over every rank, in the one-device
layout, so a checkpoint moves between any two meshes. With ``--fsdp``
the model axis is ignored, as in JAX (``:267-271``): FSDP over each data
sub-mesh, the model ranks replicas. The seq and pipe axes of the JAX mesh
are refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from acr_wsss_tpu_torch import losses
from acr_wsss_tpu_torch.configs import ModelConfig, TrainConfig
from acr_wsss_tpu_torch.data import device_aug
from acr_wsss_tpu_torch.data import voc as voc_data
from acr_wsss_tpu_torch.models import zoo
from acr_wsss_tpu_torch.models.acr import ACR, init_random_, resolve_backbone
from acr_wsss_tpu_torch.models.convert import state_dict_to_flax
from acr_wsss_tpu_torch.parallel import distributed
from acr_wsss_tpu_torch.parallel.mesh import (check_axes, data_mesh, in_mesh,
                                              make_data_mesh_for_batch, make_mesh, mesh_group,
                                              model_mesh)
from acr_wsss_tpu_torch.parallel.sharding import (apply_fsdp, apply_tensor_parallel,
                                                  check_model_extent, full_state_dict,
                                                  shard_like, unwrap, wrap_ddp)
from acr_wsss_tpu_torch.utils.checkpoint import CheckpointManager, save_params_npz
from acr_wsss_tpu_torch.utils.logging import MetricWriter
from acr_wsss_tpu_torch.utils.meters import AverageMeter, Timer
from acr_wsss_tpu_torch.utils.preemption import PreemptionGuard
from acr_wsss_tpu_torch.utils.schedule import PolySGD, make_optimizer
from acr_wsss_tpu_torch.utils.watchdog import StepWatchdog

# Loop steps whose trace ``profile_dir`` gets: [start, stop).
PROFILE_WINDOW = (10, 20)


@dataclasses.dataclass
class TrainState:
    """What ``train`` returns: the model (unwrapped from DDP; FSDP's is
    sharded), its optimizer, the number of train steps run in this call
    (``steps``), the JAX ``TrainState.step`` (``step``: the restored
    checkpoint's step, plus one per step run) and every step's loss parts
    (averaged over the ranks)."""

    model: ACR
    optimizer: PolySGD
    steps: int = 0
    step: int = 0
    history: List[Dict[str, float]] = dataclasses.field(default_factory=list)


def build_model(cfg: ModelConfig) -> ACR:
    return ACR(num_classes=cfg.num_classes, backbone_name=cfg.backbone,
               dtype=getattr(torch, cfg.compute_dtype), attn_impl=cfg.attn_impl,
               probs_dtype=getattr(torch, cfg.probs_dtype), s2d_stem=cfg.s2d_stem)


def create_train_state(cfg: TrainConfig, max_step: int, init: bool = True,
                       mesh=None) -> Tuple[torch.nn.Module, PolySGD]:
    """The model with seeded random weights (``cfg.seed``), its trunk from
    the zoo npz with ``cfg.pretrained``, on ``cfg.device`` (this rank's
    GPU), and its optimizer; ``max_step`` counts optimizer updates.
    ``init=False`` skips the seeded init and the graft, for a caller that
    restores a checkpoint over every parameter. On a ``mesh`` the model
    comes back wrapped in DDP over the data axis, or sharded by FSDP2 over
    it with ``cfg.fsdp``; every rank draws the same init. A ``model``
    axis (without ``cfg.fsdp``) cuts it first (``apply_tensor_parallel``),
    so the sharded model equals the one-device one."""
    device = distributed.local_device(cfg.device)
    model = build_model(cfg.model)
    if init and cfg.pretrained:
        zoo.init_with_pretrained(model, cfg.seed)
    elif init:
        init_random_(model, seed=cfg.seed)
    model.to(device)
    if mesh is not None and cfg.fsdp:
        apply_fsdp(model, data_mesh(mesh))
    elif model_mesh(mesh) is not None:
        apply_tensor_parallel(model, model_mesh(mesh))
    optimizer = make_optimizer(
        model.parameters(), cfg.lr, max_step, cfg.weight_decay, cfg.momentum,
        cfg.poly_power, reference_quirk=cfg.reference_optimizer_quirk,
        clip_grad_norm=cfg.clip_grad_norm, accum_steps=cfg.accum_steps)
    if mesh is not None and not cfg.fsdp:
        model = wrap_ddp(model, device, data_mesh(mesh))
    return model, optimizer


def tensor_parallel(cfg: TrainConfig) -> bool:
    """Whether ``cfg``'s mesh cuts the model over a ``model`` axis (not
    under ``--fsdp``, which ignores that axis)."""
    return "model" in cfg.mesh_axes and not cfg.fsdp


def uses_fused_consistency(cfg: TrainConfig) -> bool:
    """The fused branch, unless a model axis cuts the heads: K2f's sums
    |mean_h p1 - mean_h p2| do not split over heads (each needs the mean
    over all of them before the L1), so that mesh takes the per-layer
    aligned branch, whose head mean is reduced over the model ranks."""
    return (cfg.model.fuse_consistency and cfg.aligned_mirror
            and cfg.model.attn_impl == "kernel" and not tensor_parallel(cfg))


def make_train_step(model: torch.nn.Module, optimizer: PolySGD, cfg: TrainConfig,
                    grid: Tuple[int, int], mesh=None):
    """batch {"image" (B, H, W, 3), "label" (B, C)}, or a packed
    ``--device_aug`` batch {"image_u8", "aug", "label"} -> loss parts
    (detached tensors on the device); one forward, backward and optimizer
    call. ``model`` is an ``ACR``, FSDP's or DDP's; on a ``mesh`` (this
    rank's share of the global batch) the loss parts come back averaged
    over its data axis (the model ranks hold equal ones); with
    ``accum_steps`` > 1 every micro-step's gradient is averaged over the
    ranks, so the optimizer's mean of them is the global one."""
    alpha = cfg.alpha
    aligned = cfg.aligned_mirror
    fused = uses_fused_consistency(cfg)
    device = next(unwrap(model).parameters()).device
    group = None if mesh is None else data_mesh(mesh).get_group()

    def loss_fn(x1, labels):
        x2 = torch.flip(x1, dims=(2,))          # horizontal flip (train_acr.py:135)
        b = x1.shape[0]
        if fused:
            xi = torch.stack([x1, x2], dim=1).reshape((2 * b,) + x1.shape[1:])
            out = model(xi, export="pair_l1", mirror_second_half="interleaved")
            return losses.acr_total_loss_fused(
                out["logits"][0::2], out["logits"][1::2], out["consistency_sums"],
                labels, out["n_tokens"], alpha)
        out = model(torch.cat([x1, x2], dim=0), mirror_second_half=aligned)
        return losses.acr_total_loss_layers(
            out["logits"][:b], out["logits"][b:], out["probs_layers"], labels, grid,
            alpha, aligned=aligned)

    def train_step(batch) -> Dict[str, torch.Tensor]:
        batch = device_aug.materialize_batch(batch, cfg.crop_size, device)
        x1 = torch.as_tensor(batch["image"], dtype=torch.float32).to(device)
        labels = torch.as_tensor(np.asarray(batch["label"], np.float32)).to(device)
        total, parts = loss_fn(x1, labels)
        total.backward()
        optimizer.step()
        parts = {k: v.detach() for k, v in parts.items()}
        if group is not None:
            values = torch.stack([v.float() for v in parts.values()])
            dist.all_reduce(values, group=group)
            parts = dict(zip(parts, values / dist.get_world_size(group)))
        return parts

    return train_step


def make_eval_step(model: torch.nn.Module):
    """batch {"image", "label", "weight"} -> (sum of weighted per-example
    MLSM losses, sum of weights). The weights let validation pad its last
    batch to the train batch size. DDP's model runs unwrapped (no
    collective); FSDP's gathers its shards, and a model axis's blocks
    reduce over the model ranks, so every rank of the mesh calls it the
    same number of times."""
    model = unwrap(model)
    device = next(model.parameters()).device

    @torch.no_grad()
    def eval_step(batch) -> Tuple[torch.Tensor, torch.Tensor]:
        image = torch.as_tensor(np.asarray(batch["image"], np.float32)).to(device)
        labels = torch.as_tensor(np.asarray(batch["label"], np.float32)).to(device)
        weight = torch.as_tensor(np.asarray(batch["weight"], np.float32)).to(device)
        logits = model(image, export="none")["logits"].float()
        per_class = -(labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))
        return (per_class.mean(dim=-1) * weight).sum(), weight.sum()

    return eval_step


def _dataset_setup(cfg: TrainConfig):
    """(train names, val names, label store) for voc12 or coco. COCO
    (reference ``train_acr_coco.py:106``): names from the image directory
    listing, validation names from ``val_image_dir`` (none without it),
    labels parsed lazily from the bbox txts in ``cls_labels_path``."""
    if cfg.dataset == "coco":
        from acr_wsss_tpu_torch.data import coco as coco_data

        names = coco_data.list_image_names(cfg.image_dir)
        val_names = (coco_data.list_image_names(cfg.val_image_dir) if cfg.val_image_dir
                     else [])
        return names, val_names, coco_data.CocoLabelStore(cfg.cls_labels_path, names)
    return (voc_data.read_file(cfg.train_list), voc_data.read_file(cfg.val_list),
            voc_data.load_cls_labels(cfg.cls_labels_path))


def validate(cfg: TrainConfig, model: ACR, eval_step, val_names=None, labels=None,
             mesh=None) -> float:
    """Mean validation MLSM loss; each batch is padded with zero-weight
    rows to the train batch size. On a ``mesh`` each data coordinate takes
    its share of the names (``shard_names``) in batches of its share of
    the batch size, all ranks the same number of batches, and the sums
    are added over the data axis: the one-process value."""
    if labels is None:
        _, val_names, labels = _dataset_setup(cfg)
    source = voc_data.VOCClassificationSource(cfg.val_image_dir or cfg.image_dir, labels,
                                              cfg.crop_size)
    world, host = data_share(mesh)
    bs = max(cfg.batch_size // world, 1)
    batches = iter(voc_data.EvalIterator(source, voc_data.shard_names(val_names, host, world),
                                         batch_size=bs))
    empty = {"image": np.zeros((0, cfg.crop_size, cfg.crop_size, 3), np.float32),
             "label": np.zeros((0, cfg.model.num_classes), np.float32)}
    total, count = 0.0, 0.0
    for _ in range(math.ceil(math.ceil(len(val_names) / world) / bs)):
        batch = next(batches, empty)
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
    if mesh is not None:
        sums = torch.tensor([total, count], dtype=torch.float64, device=mesh.device_type)
        dist.all_reduce(sums, group=data_mesh(mesh).get_group())
        total, count = sums.tolist()
    return total / max(count, 1.0)


def data_share(mesh) -> Tuple[int, int]:
    """(data extent, this rank's data coordinate): the hosts of the data
    order; (1, 0) for one process."""
    if mesh is None:
        return 1, 0
    data = data_mesh(mesh)
    return data.size(), data.get_local_rank()


def checkpoint_state(step: int, model: torch.nn.Module, optimizer: PolySGD) -> dict:
    """What a checkpoint holds: the JAX loop's params, optimizer state and
    step, in the one-device layout (FSDP's and the model axis's shards
    gathered: a collective, called on every rank). The train step draws
    no random numbers (no dropout; the data order and augmentations come
    from ``cfg.seed``), so there is no generator state to keep."""
    return {"model": full_state_dict(model), "optimizer": optimizer.state_dict(), "step": step}


def restore_checkpoint(ckpt: CheckpointManager, model: torch.nn.Module, optimizer: PolySGD
                       ) -> Optional[int]:
    """Load the latest entry of ``ckpt`` into ``model`` and ``optimizer``
    (built over the same parameters, on one device, DDP, FSDP or a model
    axis with any number of ranks); its step, or None when there is
    none."""
    restored = ckpt.restore()
    if restored is None:
        return None
    model = unwrap(model)
    current = model.state_dict(keep_vars=True)
    model.load_state_dict({k: shard_like(v, current[k]) for k, v in restored["model"].items()})
    optimizer.load_state_dict(restored["optimizer"])
    return int(restored["step"])


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, cfg: TrainConfig) -> None:
    prof.stop()
    os.makedirs(cfg.profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(cfg.profile_dir, f"{cfg.session_name}_trace.json"))


def _fit_data_mesh(cfg: TrainConfig, device: torch.device):
    """None for one process; else the data mesh, whose extent divides the
    global batch (``make_data_mesh_for_batch``), or the explicit
    ``cfg.mesh_shape``."""
    if not dist.is_initialized():
        return None
    if tuple(cfg.mesh_shape) != (-1,) or tuple(cfg.mesh_axes) != ("data",):
        mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axes, device.type)
    else:
        mesh = make_data_mesh_for_batch(cfg.batch_size, device.type)
    data = data_mesh(mesh).size()
    if cfg.batch_size % data:
        raise ValueError(f"batch {cfg.batch_size} does not split over a data axis of "
                         f"{data} ranks")
    return mesh


def check_mesh(cfg: TrainConfig) -> None:
    """Refuse the seq and pipe axes, and a model axis whose extent does not
    divide the backbone's heads and MLP hidden width, before any process
    group is joined."""
    check_axes(cfg.mesh_axes)
    if "data" not in cfg.mesh_axes:
        raise ValueError(f"mesh axes {list(cfg.mesh_axes)}: the mesh needs a data axis "
                         "(--mesh data=D,model=M)")
    if tensor_parallel(cfg):
        size = cfg.mesh_shape[list(cfg.mesh_axes).index("model")]
        spec = resolve_backbone(cfg.model.backbone)
        if size != -1:
            check_model_extent(size, spec.num_heads, 4 * spec.embed_dim)


def _resume_step(ckpt: CheckpointManager, mesh, device: torch.device) -> Optional[int]:
    """The step of the latest checkpoint, None when there is none. On a
    data mesh every rank reads ``checkpoint_dir`` itself, and rank 0 alone
    writes there: the ranks' steps are compared (one all-reduce MAX of
    (step, -step)), and a rank that sees another step than the rest, as
    on nodes that do not share the directory, fails the run on every rank."""
    step = ckpt.latest_step()
    if mesh is None:
        return step
    mine = -1 if step is None else step
    seen = torch.tensor([mine, -mine], device=device)
    dist.all_reduce(seen, op=dist.ReduceOp.MAX, group=mesh_group(mesh))
    highest, lowest = int(seen[0]), -int(seen[1])
    if highest != lowest:
        raise RuntimeError(
            f"the ranks see other checkpoints under {ckpt.directory}: latest step "
            f"{'none' if lowest < 0 else lowest} on one rank, {highest} on another (rank "
            f"{distributed.rank()}: {'none' if step is None else step}); every rank resumes "
            "from rank 0's checkpoints, so checkpoint_dir must be one directory shared by "
            "every node")
    return step


def _agree(flag: bool, mesh, device: torch.device) -> bool:
    """Whether ``flag`` is set on any rank of ``mesh`` (an all-reduce MAX)."""
    value = torch.tensor([int(flag)], device=device)
    dist.all_reduce(value, op=dist.ReduceOp.MAX, group=mesh_group(mesh))
    return bool(value.item())


def train(cfg: TrainConfig) -> Optional[TrainState]:
    """The training run of ``cfg``; under a launcher, this rank's part of
    it. None on a rank outside the data mesh, which idles."""
    check_mesh(cfg)
    if cfg.multihost:
        distributed.require_launcher()
    distributed.initialize(cfg.device)
    device = distributed.local_device(cfg.device)
    mesh = _fit_data_mesh(cfg, device)
    if not in_mesh(mesh):
        print(f"rank {distributed.rank()}: outside the data mesh of {mesh.size()} ranks "
              f"(global batch {cfg.batch_size}); idle", flush=True)
        return None
    world, host = data_share(mesh)
    lead = distributed.rank() == 0
    names, val_names, labels = _dataset_setup(cfg)
    steps_per_epoch = len(names) // cfg.batch_size
    # max_step counts optimizer updates (the poly horizon); with gradient
    # accumulation each update takes accum_steps micro-steps.
    max_step = steps_per_epoch * cfg.max_epochs
    accum = max(cfg.accum_steps, 1)
    total_micro_steps = max_step * accum

    ckpt = CheckpointManager(os.path.join(cfg.checkpoint_dir, cfg.session_name))
    resume = _resume_step(ckpt, mesh, device)
    # A relaunch restores every parameter: the seeded init of ~10^8 of them
    # on the host would only delay it.
    model, optimizer = create_train_state(cfg, max_step, init=resume is None, mesh=mesh)
    state = TrainState(unwrap(model), optimizer)
    grid = (cfg.crop_size // 16, cfg.crop_size // 16)
    train_step = make_train_step(model, optimizer, cfg, grid, mesh)
    eval_step = make_eval_step(model)

    start_step = 0
    restored = restore_checkpoint(ckpt, model, optimizer)
    if restored is not None:
        state.step = restored
        start_step = restored + 1
        if lead:
            print(f"resumed from checkpoint step {restored}", flush=True)

    source = voc_data.VOCClassificationSource(cfg.image_dir, labels, cfg.crop_size,
                                              cache_decoded=cfg.cache_decoded)
    train_iter = voc_data.TrainIterator(source, names, cfg.batch_size // world, seed=cfg.seed,
                                        host_id=host, num_hosts=world,
                                        num_workers=cfg.num_workers,
                                        device_aug=cfg.device_aug, aug_pad=cfg.aug_pad)
    metrics_writer = MetricWriter(
        os.path.join(cfg.checkpoint_dir, f"{cfg.session_name}_metrics.jsonl") if lead else None)
    meter = AverageMeter("loss")
    timer = Timer("Session started: ")
    preempted = False
    profiler = None
    try:
        with PreemptionGuard() as guard, StepWatchdog(cfg.step_timeout_s) as watchdog:
            # The next batch is loaded while the device runs this step; the
            # step's loss read below is the sync point.
            batch = next(train_iter)
            for step in range(start_step, total_micro_steps + 1):
                if lead and cfg.profile_dir and step == PROFILE_WINDOW[0]:
                    profiler = _start_profiler(device)
                if profiler is not None and step == PROFILE_WINDOW[1]:
                    _stop_profiler(profiler, cfg)
                    profiler = None

                parts = train_step(batch)
                if step < total_micro_steps:
                    batch = next(train_iter)
                values = dict(zip(parts, torch.stack(list(parts.values())).tolist()))
                state.history.append(values)
                state.steps += 1
                state.step += 1
                meter.add({"loss": values["loss"]})

                if step % cfg.log_every == 0 and lead:
                    timer.update_progress(max(step, 1) / total_micro_steps)
                    imps = (step + 1) * cfg.batch_size / max(timer.get_stage_elapsed(), 1e-9)
                    loss_avg = meter.pop("loss")
                    print(f"Iter:{step:5d}/{total_micro_steps:5d}", "Loss:%.4f" % loss_avg,
                          "imps:%.1f" % imps, "Fin:%s" % timer.str_est_finish(), flush=True)
                    metrics_writer.write(step, {"loss": loss_avg, "imps": imps, **values})

                if step and step % cfg.val_every == 0 and val_names:
                    val_loss = validate(cfg, model, eval_step, val_names, labels, mesh)
                    if lead:
                        print("val loss: %.4f" % val_loss, flush=True)

                # A signal may reach some ranks only: the flag is agreed
                # over the ranks every log_every steps (JAX's allgather,
                # :395-425), so that every rank stops at the same step.
                fired = guard.fired
                if mesh is not None:
                    fired = step % cfg.log_every == 0 and _agree(guard.fired, mesh, device)
                if fired or (step and step % cfg.checkpoint_every == 0):
                    full = checkpoint_state(step, model, optimizer)
                    if lead:
                        ckpt.save(step, full)
                if fired:
                    preempted = True
                    if lead:
                        print(f"preempted: checkpoint saved at step {step}; relaunch to "
                              "resume", flush=True)
                    break
                # After the step's one host sync (the .tolist() above), its
                # validation and its checkpoint: a hung kernel shows as a
                # missing beat, and neither of those counts against the next.
                watchdog.beat()
    finally:
        train_iter.close()
        metrics_writer.close()
        if profiler is not None:
            _stop_profiler(profiler, cfg)
    if not preempted:
        full = full_state_dict(state.model)
        if lead:
            os.makedirs(cfg.checkpoint_dir, exist_ok=True)
            save_params_npz(os.path.join(cfg.checkpoint_dir, f"{cfg.session_name}_last.npz"),
                            state_dict_to_flax(state.model, full))
            print("model saved!", flush=True)
    ckpt.close()
    if mesh is not None:
        # Every rank leaves with rank 0's files written.
        dist.barrier(group=mesh_group(mesh))
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
    parser.add_argument("--s2d_stem", action="store_true",
                        help="hybrid stem: space-to-depth fold of the 7x7/2 stem conv "
                             "(the same function)")
    parser.add_argument("--step_timeout_s", default=0.0, type=float,
                        help="hung-step watchdog: exit 75 if no step completes within "
                             "this budget after the first; a relaunch resumes from the "
                             "last checkpoint. 0 = off")
    parser.add_argument("--pretrained", action="store_true",
                        help="init the trunk from the zoo npz "
                             "(<ACR_WSSS_ZOO>/<backbone>_in21k.npz)")
    parser.add_argument("--device_aug", action="store_true",
                        help="resize, flip, normalize and crop on the device from uint8 "
                             "rasters (data/device_aug.py)")
    parser.add_argument("--aug_pad", default=512, type=int,
                        help="static pad square for --device_aug rasters")
    parser.add_argument("--mesh", default="data=-1",
                        help="device mesh as 'axis=size,...': 'data=-1' (every rank, cut "
                             "to the largest divisor of the batch), 'data=N', or "
                             "'data=D,model=M' (tensor parallelism over M ranks)")
    parser.add_argument("--fsdp", action="store_true",
                        help="shard parameters, gradients and momentum over the data "
                             "axis (FSDP2) instead of replicating them (DDP); a model "
                             "axis is then ignored")
    parser.add_argument("--multihost", action="store_true",
                        help="require the launcher's environment (RANK, WORLD_SIZE, "
                             "LOCAL_RANK, MASTER_ADDR, MASTER_PORT): multi-node runs")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    mesh_axes, mesh_shape = zip(*((a.strip(), int(n)) for a, n in
                                  (kv.split("=") for kv in args.mesh.split(","))))
    return TrainConfig(
        model=ModelConfig(backbone=args.backbone, attn_impl=args.attn_impl,
                          s2d_stem=args.s2d_stem),
        batch_size=args.batch_size, max_epochs=args.max_epoches, lr=args.lr,
        weight_decay=args.wt_dec, alpha=args.alpha, session_name=args.session_name,
        crop_size=args.crop_size, image_dir=args.IMpath,
        train_list=args.LISTpath or args.train_list, val_list=args.val_list,
        num_workers=args.num_workers, cls_labels_path=args.cls_labels, seed=args.seed,
        accum_steps=args.accum_steps, cache_decoded=args.cache_decoded,
        clip_grad_norm=args.clip_grad_norm, step_timeout_s=args.step_timeout_s,
        pretrained=args.pretrained, device_aug=args.device_aug, aug_pad=args.aug_pad,
        mesh_shape=tuple(mesh_shape), mesh_axes=tuple(mesh_axes), fsdp=args.fsdp,
        multihost=args.multihost, device=args.device)


def main(argv: Optional[List[str]] = None) -> Optional[TrainState]:
    try:
        return train(parse_args(argv))
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
