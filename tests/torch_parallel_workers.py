"""Rank functions of the port's data-parallel CPU tests.

Spawned by ``torch.multiprocessing.spawn`` from ``tests/test_torch_parallel.py``,
``tests/test_torch_tensor_parallel.py`` and ``tests/test_torch_multiprocess.py``;
this module imports nothing of JAX,
so a rank starts with torch and the port alone. Ranks meet over gloo at a
``file://`` store: no TCP port, so that test workers running side by side
cannot collide.
"""

import dataclasses
import os
import shutil
import signal

import numpy as np
import torch

from acr_wsss_tpu_torch import train as train_mod
from acr_wsss_tpu_torch.parallel import distributed
from acr_wsss_tpu_torch.parallel.mesh import make_data_mesh_for_batch, make_mesh
from acr_wsss_tpu_torch.parallel.sharding import full_like, full_tensors, shard_like, unwrap
from acr_wsss_tpu_torch.utils import schedule
from acr_wsss_tpu_torch.utils.checkpoint import CheckpointManager

# The 2-rank step job: (name, backbone, TrainConfig overrides). JAX_CASES
# are held against JAX's data-mesh and FSDP steps, CHECKPOINTED ones are
# resumed in one process and held against two JAX steps, ONE_PROCESS ones
# against the port's one-process step with the same options. vitb is the
# backbone of JAX's FSDP test (vit_small's position embedding, 577 x 384,
# does not split over JAX's devices); the rest run on vit_small, but for
# the hybrid's case, whose stem no other backbone has.
STEP_CASES = (("ddp", "vitb", {}), ("fsdp", "vitb", {"fsdp": True}),
              ("ddp_resume", "vit_small", {}), ("fsdp_resume", "vit_small", {"fsdp": True}),
              ("ddp_accum", "vit_small", {"accum_steps": 2}),
              ("fsdp_clip_accum", "vit_small",
               {"fsdp": True, "accum_steps": 2, "clip_grad_norm": 1.0}),
              ("hybrid", "vitb_hybrid", {}))
JAX_CASES = ("ddp", "fsdp")
CHECKPOINTED = ("ddp_resume", "fsdp_resume")
ONE_PROCESS = ("ddp", "ddp_accum", "fsdp_clip_accum", "hybrid")
THREADS = 1
MAX_STEP = 100
SEED = 3


def _join(rank, world, store):
    torch.set_num_threads(THREADS)
    distributed.initialize("cpu", init_method=f"file://{store}", rank=rank, world_size=world)


def load_full(model, state_dict):
    """The one-device ``state_dict`` into ``model``, sharded where FSDP's or
    the model axis's is."""
    base = unwrap(model)
    current = base.state_dict(keep_vars=True)
    base.load_state_dict({k: shard_like(v, current[k]) for k, v in state_dict.items()})


def _steps(model, opt, cfg, mesh, batches, rows, n):
    """Loss parts of ``n`` calls of the train step, call k on batch k."""
    step = train_mod.make_train_step(model, opt, cfg, (cfg.crop_size // 16,) * 2, mesh)
    return [{k: float(v) for k, v in step({"image": batches[f"image{i}"][rows],
                                           "label": batches[f"label{i}"][rows]}).items()}
            for i in range(n)]


def weights_file(tmp, backbone):
    """JAX's numpy weights of ``backbone`` in the port's layout, written
    by the test process (vitb and vit_small)."""
    return os.path.join(tmp, f"weights_{backbone}.pt")


def seeded_state_dict(model, seed):
    """``init_random_``'s distributions (fan-in normal weights, unit norm
    scales, zero biases and tokens, position embedding N(0, 0.02^2)), drawn
    by torch: its numpy draws take seconds for 10^8 parameters."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("pos_embed"):
            out[name] = 0.02 * torch.randn(p.shape, generator=gen)
        elif leaf == "weight" and p.dim() > 1:
            out[name] = torch.randn(p.shape, generator=gen) / float(np.prod(p.shape[1:])) ** 0.5
        elif leaf == "weight":
            out[name] = torch.ones(p.shape)
        else:
            out[name] = torch.zeros(p.shape)
    return out


def _case(tmp, cfg, backbone, overrides, mesh=None):
    """(config, model, optimizer, the weights) of a case: the weights from
    ``weights_file``, or the hybrid's ``seeded_state_dict``, the same in
    every process."""
    ccfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=backbone),
                               **overrides)
    model, opt = train_mod.create_train_state(ccfg, MAX_STEP, init=False, mesh=mesh)
    path = weights_file(tmp, backbone)
    if os.path.exists(path):
        weights = torch.load(path, weights_only=True)
    else:   # drawn over the one-device shapes, whatever the mesh cut
        with torch.device("meta"):
            shapes = train_mod.build_model(ccfg.model)
        weights = seeded_state_dict(shapes, SEED)
    load_full(model, weights)
    return ccfg, model, opt, weights


def update_rel(after, ref, before):
    """Per tensor, |(after - before) - (ref - before)| / |ref - before|."""
    return {k: float(((after[k] - before[k]) - (r - before[k])).norm()
                     / (r - before[k]).norm().clamp_min(1e-30)) for k, r in ref.items()}


def step_job(rank, world, store, tmp, cfg):
    """The 2-rank steps, then, once the group is closed, the one-process
    work split over the ranks, which the test process would otherwise
    do while JAX compiles.

    On the group, each case of STEP_CASES on this rank's rows of the
    batches in ``tmp/batches.npz``; rank 0 writes ``tmp/<case>.pt`` (loss
    parts, the qkv weight's local shard size and, for JAX_CASES, the
    parameters after the update) and, for CHECKPOINTED cases, a
    one-device checkpoint of step 0 under ``tmp/<case>_ckpt``. Then, in
    one process each: ``one_<case>.pt`` for the ONE_PROCESS cases, the
    one-process step with the case's options (its loss parts, its
    largest difference from the 2-rank parameters, which each rank keeps
    in memory, and, per tensor, the relative distance of the 2-rank
    update from its own), and ``resumed_<case>.pt``, the parameters after
    one step on batch 1 from a CHECKPOINTED case's checkpoint."""
    _join(rank, world, store)
    batches = np.load(os.path.join(tmp, "batches.npz"))
    cases = {name: (backbone, overrides) for name, backbone, overrides in STEP_CASES}
    tasks = [("one", name) for name in ONE_PROCESS] + [("resumed", name) for name in CHECKPOINTED]
    mine = tasks[rank::world]
    after = {}
    for name, (backbone, overrides) in cases.items():
        mesh = make_data_mesh_for_batch(cfg.batch_size, "cpu")
        ccfg, model, opt, _ = _case(tmp, cfg, backbone, overrides, mesh)
        per = ccfg.batch_size // world
        history = _steps(model, opt, ccfg, mesh, batches, slice(rank * per, (rank + 1) * per),
                         ccfg.accum_steps)
        qkv = unwrap(model).trunk.blocks[0].attn.qkv.weight
        out = {"history": history, "qkv_numel": qkv.numel(),
               "qkv_local": (qkv.to_local() if hasattr(qkv, "to_local") else qkv).numel()}
        if name in JAX_CASES or name in ONE_PROCESS:   # a collective under FSDP
            params = full_tensors({k: v.detach() for k, v in unwrap(model).named_parameters()})
            if name in JAX_CASES:
                out["params"] = params
            if ("one", name) in mine:
                after[name] = params
        state = train_mod.checkpoint_state(0, model, opt) if name in CHECKPOINTED else None
        if rank == 0:
            torch.save(out, os.path.join(tmp, f"{name}.pt"))
            if state is not None:
                ckpt = CheckpointManager(os.path.join(tmp, f"{name}_ckpt"))
                ckpt.save(0, state)
                ckpt.close()
        del model, opt, state, out
    torch.distributed.barrier()
    distributed.shutdown()

    for kind, name in mine:
        backbone, overrides = cases[name]
        ccfg, model, opt, weights = _case(tmp, cfg, backbone, overrides if kind == "one" else {})
        if kind == "one":
            history = _steps(model, opt, ccfg, None, batches, slice(None), ccfg.accum_steps)
            one = {k: v.detach() for k, v in model.named_parameters()}
            ranks = after.pop(name)
            worst = max(float((v - ranks[k]).abs().max()) for k, v in one.items())
            torch.save({"history": history, "worst": worst,
                        "update_rel": update_rel(ranks, one, weights)},
                       os.path.join(tmp, f"one_{name}.pt"))
        else:
            ckpt = CheckpointManager(os.path.join(tmp, f"{name}_ckpt"))
            restored = train_mod.restore_checkpoint(ckpt, model, opt)
            ckpt.close()
            batch1 = {"image0": batches["image1"], "label0": batches["label1"]}
            _steps(model, opt, ccfg, None, batch1, slice(None), 1)
            torch.save({"restored_step": restored, "updates": opt.updates,
                        "params": model.state_dict()}, os.path.join(tmp, f"resumed_{name}.pt"))
            shutil.rmtree(ckpt.directory)
        del model, opt


def train_job(rank, world, store, cfg, sigterm_rank, sigterm_step):
    """``train.train`` through ``--multihost`` as a launcher starts it, the
    launcher's variables in the environment and the group joined over
    the test's file store first: a run in which ``sigterm_rank`` sends
    itself SIGTERM after its ``sigterm_step``'s loss, then a relaunch
    that resumes and finishes, then a launch in which the ranks other
    than 0 look for checkpoints in an empty directory of their own, as on
    nodes that share no ``checkpoint_dir``. Each rank writes the first two
    runs' results and the third's error message to
    ``<checkpoint_dir>/rank<r>.pt``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    _join(rank, world, store)
    add, validate = train_mod.AverageMeter.add, train_mod.validate
    seen, val = [], []

    def add_then_sigterm(self, values):
        add(self, values)
        seen.append(values)
        if rank == sigterm_rank and len(seen) == sigterm_step + 1:
            signal.raise_signal(signal.SIGTERM)

    def keep_val(*args, **kwargs):
        val.append(validate(*args, **kwargs))
        return val[-1]

    train_mod.AverageMeter.add, train_mod.validate = add_then_sigterm, keep_val
    results = []
    for _ in range(2):
        state = train_mod.train(dataclasses.replace(cfg, multihost=True))
        results.append(None if state is None else {
            "step": state.step, "steps": state.steps, "history": state.history,
            "val": list(val)})
        val.clear()
    unshared = dataclasses.replace(cfg, multihost=True, checkpoint_dir=os.path.join(
        cfg.checkpoint_dir, f"rank{rank}_own") if rank else cfg.checkpoint_dir)
    try:
        train_mod.train(unshared)
        results.append(None)
    except RuntimeError as e:
        results.append(str(e))
    torch.save(results, os.path.join(cfg.checkpoint_dir, f"rank{rank}.pt"))
    distributed.shutdown()


# The 4-rank tensor-parallel job on a (data, model) = TP_MESH mesh: (name,
# backbone, TrainConfig overrides). TP_JAX cases are held against JAX's
# step on the same mesh; TP_ONE ones against the port's one-process step
# on the whole batch (per-layer branch, the one the model axis takes);
# TP_RESUMED's checkpoint is resumed in one process and held against two
# JAX single-device steps. "tp_fsdp" is --fsdp on the model mesh: FSDP
# over the data axis, no cut, the model ranks replicas (JAX's rule).
TP_MESH, TP_AXES = (2, 2), ("data", "model")
TP_CASES = (("tp", "vitb", {}), ("tp_fsdp", "vitb", {"fsdp": True}),
            ("tp_hybrid", "vitb_hybrid", {}),
            ("tp_clip_accum", "vit_small", {"accum_steps": 2, "clip_grad_norm": 1.0}))
TP_JAX, TP_ONE, TP_RESUMED = ("tp", "tp_fsdp"), ("tp", "tp_hybrid", "tp_clip_accum"), "tp"


def _recorded_norms():
    """The global norms that the optimizer's clipping takes, in order."""
    norms = []
    norm = schedule.global_norm

    def record(*args, **kwargs):
        norms.append(norm(*args, **kwargs))
        return norms[-1]

    schedule.global_norm = record
    return norms


def tp_job(rank, world, store, tmp, cfg):
    """The TP_MESH ranks: each case of TP_CASES on this rank's data rows of
    ``tmp/batches.npz`` (the rows of its data coordinate); rank 0 writes
    ``tmp/<case>.pt``: the loss parts of each micro-step, the norms that
    clipping took, the cut parameters (name: dimension, groups, local
    shape), the qkv weight's local size and, for TP_JAX cases, the
    parameters after in the one-device layout; TP_RESUMED's one-device
    checkpoint goes under ``tmp/<case>_ckpt``. Then, with the group
    closed, the one-process work split over the ranks: ``one_<case>.pt``
    (loss parts, norms and, per tensor, the relative distance of the
    ranks' update from its own) and ``resumed_<case>.pt`` (the checkpoint
    restored, one step on batch 1)."""
    _join(rank, world, store)
    norms = _recorded_norms()
    batches = np.load(os.path.join(tmp, "batches.npz"))
    tasks = [("one", name) for name in TP_ONE] + [("resumed", TP_RESUMED)]
    mine = tasks[rank::world]
    after = {}
    for name, backbone, overrides in TP_CASES:
        mesh = make_mesh(TP_MESH, TP_AXES, "cpu")
        base = dataclasses.replace(cfg, mesh_shape=TP_MESH, mesh_axes=TP_AXES)
        ccfg, model, opt, _ = _case(tmp, base, backbone, overrides, mesh)
        per = ccfg.batch_size // TP_MESH[0]
        data = mesh["data"].get_local_rank()
        norms.clear()
        history = _steps(model, opt, ccfg, mesh, batches, slice(data * per, (data + 1) * per),
                         ccfg.accum_steps)
        named = dict(unwrap(model).named_parameters())
        qkv = named["trunk.blocks.0.attn.qkv.weight"]
        out = {"history": history, "norms": list(norms),
               "cut": {k: (p.tp.dim, p.tp.groups, tuple(p.shape)) for k, p in named.items()
                       if getattr(p, "tp", None) is not None},
               "qkv_local": (qkv.to_local() if hasattr(qkv, "to_local") else qkv).numel()}
        params = {k: full_like(p).detach() for k, p in named.items()}   # a collective
        if name in TP_JAX:
            out["params"] = params
        if ("one", name) in mine:
            after[name] = params
        state = train_mod.checkpoint_state(0, model, opt) if name == TP_RESUMED else None
        if rank == 0:
            torch.save(out, os.path.join(tmp, f"{name}.pt"))
            if state is not None:
                ckpt = CheckpointManager(os.path.join(tmp, f"{name}_ckpt"))
                ckpt.save(0, state)
                ckpt.close()
        del model, opt, state, out, params, named, qkv
    torch.distributed.barrier()
    distributed.shutdown()

    cases = {name: (backbone, overrides) for name, backbone, overrides in TP_CASES}
    for kind, name in mine:
        backbone, overrides = cases[name]
        one_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, fuse_consistency=kind == "resumed"))
        ccfg, model, opt, weights = _case(tmp, one_cfg, backbone,
                                          overrides if kind == "one" else {})
        norms.clear()
        if kind == "one":
            history = _steps(model, opt, ccfg, None, batches, slice(None), ccfg.accum_steps)
            one = {k: v.detach() for k, v in model.named_parameters()}
            torch.save({"history": history, "norms": list(norms),
                        "update_rel": update_rel(after.pop(name), one, weights)},
                       os.path.join(tmp, f"one_{name}.pt"))
        else:
            ckpt = CheckpointManager(os.path.join(tmp, f"{name}_ckpt"))
            restored = train_mod.restore_checkpoint(ckpt, model, opt)
            ckpt.close()
            batch1 = {"image0": batches["image1"], "label0": batches["label1"]}
            _steps(model, opt, ccfg, None, batch1, slice(None), 1)
            torch.save({"restored_step": restored, "updates": opt.updates,
                        "params": model.state_dict()}, os.path.join(tmp, f"resumed_{name}.pt"))
            shutil.rmtree(ckpt.directory)
        del model, opt


# The 2-rank Swin job: a small Swin (width 32, depths (2, 2), window 4, crop
# 64), the global batch SWIN_BATCH; the CLI case registers it as SWIN_NAME.
SWIN_KW = dict(num_classes=20, embed_dim=32, depths=(2, 2), num_heads=(2, 4), window_size=4,
               img_size=64)
SWIN_CROP, SWIN_BATCH, SWIN_LR, SWIN_NAME = 64, 4, 0.01, "swin_parallel_test"


def swin_config(**kw):
    from acr_wsss_tpu_torch.configs import ModelConfig, TrainConfig

    return TrainConfig(model=ModelConfig(backbone="swin", compute_dtype="float32"),
                       crop_size=SWIN_CROP, batch_size=SWIN_BATCH, lr=SWIN_LR, device="cpu",
                       **kw)


def swin_step(weights, batch, rows, mesh=None):
    """(loss parts, parameters after) of one ``train_swin`` step of the small
    Swin from ``weights`` on ``rows`` of ``batch``; a DDP replica on
    ``mesh``."""
    from acr_wsss_tpu_torch.models.swin import SwinTransformer
    from acr_wsss_tpu_torch.parallel.sharding import wrap_ddp
    from acr_wsss_tpu_torch.train_swin import make_swin_train_step
    from acr_wsss_tpu_torch.utils.schedule import make_optimizer

    cfg = swin_config()
    model = SwinTransformer(**SWIN_KW, dtype=torch.float32)
    model.load_state_dict(weights)
    opt = make_optimizer(model.parameters(), cfg.lr, MAX_STEP, cfg.weight_decay, cfg.momentum,
                         cfg.poly_power)
    cpu = torch.device("cpu")
    wrapped = model if mesh is None else wrap_ddp(model, cpu, mesh)
    step = make_swin_train_step(wrapped, opt, cfg, SWIN_CROP, cpu, mesh)
    parts = {k: float(v) for k, v in step({"image": batch["image"][rows],
                                           "label": batch["label"][rows]}).items()}
    return parts, {k: v.detach().clone() for k, v in model.named_parameters()}


def register_small_swin():
    from acr_wsss_tpu_torch.models import registry
    from acr_wsss_tpu_torch.models.swin import SwinTransformer

    def builder(**kwargs):
        return SwinTransformer(**{**SWIN_KW, **kwargs})

    registry._MODELS.setdefault(SWIN_NAME, builder)


def swin_job(rank, world, store, tmp, argv):
    """One ``train_swin`` step on this rank's half of ``tmp/swin_batch.npz``
    over a DDP replica (rank 0 writes ``tmp/swin_ddp.pt``: the loss parts
    and the parameters after); once the group is closed, rank 1 takes the
    one-process step on the whole batch (``tmp/swin_one.pt``); then
    ``train_swin.main(argv)`` on a new
    group, under the launcher's variables, each rank with the weight
    directory ``<argv's>/rank<r>``; each rank writes the CLI run's history
    to ``tmp/swin_cli<r>.pt``."""
    from acr_wsss_tpu_torch import train_swin

    _join(rank, world, store)
    batch = dict(np.load(os.path.join(tmp, "swin_batch.npz")))
    weights = torch.load(os.path.join(tmp, "swin_weights.pt"), weights_only=True)
    mesh = make_data_mesh_for_batch(SWIN_BATCH, "cpu")
    per = SWIN_BATCH // world
    parts, after = swin_step(weights, batch, slice(rank * per, (rank + 1) * per), mesh)
    if rank == 0:
        torch.save({"parts": parts, "params": after}, os.path.join(tmp, "swin_ddp.pt"))
    torch.distributed.barrier()
    distributed.shutdown()
    if rank == 1:
        parts, after = swin_step(weights, batch, slice(None))
        torch.save({"parts": parts, "params": after}, os.path.join(tmp, "swin_one.pt"))

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    _join(rank, world, store + "_cli")
    register_small_swin()
    argv = list(argv)
    argv[argv.index("--weight_dir") + 1] += f"/rank{rank}"
    state = train_swin.main(argv)
    torch.save({"steps": state.steps, "history": state.history},
               os.path.join(tmp, f"swin_cli{rank}.pt"))
