"""The port's data parallelism against the JAX package's, on the CPU.

* ``make_mesh`` and ``make_data_mesh_for_batch``: the shapes, the ``-1``
  and the errors of JAX's on the 8 virtual CPU devices of
  ``tests/conftest.py`` (the port's over 8 ranks); the seq and pipe axes
  refused, and a model axis that does not divide the heads
  (``tests/test_torch_tensor_parallel.py`` holds that axis).
* One vitb train step on 2 ranks (gloo, spawned, a ``file://`` store),
  DDP and FSDP2, each rank on 4 of a batch of 8, from the numpy weights
  of ``tests/torch_port_helpers.py``: against JAX's step on a data mesh of
  2 devices and with ``fsdp_shardings`` there
  (``tests/test_parallel.py:59-88,135-164``), loss and every updated
  parameter within 1e-4, JAX's own tolerances; FSDP's qkv weight holds
  half its elements on each rank.
* The 2-rank steps against the port's one-process step on the whole
  batch with the same options, loss parts and every parameter within
  1e-5, and each tensor's update within 1e-3 of the one process's
  (relative L2): vitb's DDP step; on vit_small the accumulating DDP step
  (2 micro-steps, each all-reduced) and the accumulating FSDP step with
  global-norm clipping; vitb_hybrid's DDP step, whose weight-standardized
  stem no other backbone has (the port's one-process hybrid step is held
  against JAX's in ``tests/test_torch_train_step.py``).
* Elastic resume (``tests/test_parallel.py:167-215``): a 2-rank vit_small
  step's checkpoint, with and without FSDP, restored in one process (a
  spawned one whose group is closed), plus one step, equals two JAX
  single-device steps within 1e-4.

* ``train_swin`` over the data mesh: a small Swin (width 32, depths (2,
  2), window 4, crop 64) on 2 ranks, 2 + 2 images of a batch of 4, against
  JAX's ``train_swin`` step on a data mesh of 2 devices (its
  ``train_swin.main`` layout: replicated parameters, a sharded batch) and
  against the port's one-process step on the 4; ``train_swin.main`` under
  the launcher's variables on 2 ranks: one history on both, the npz files
  on rank 0 alone.

Crop 32 in float32, lr 0.01, alpha 1 (JAX's data-mesh test). JAX steps
its per-layer branch on plain attention; the port its default, the fused
branch, whose pair-consistency entry takes its plain version on the CPU.
The ranks run in one module-scoped job, which also runs the one-process
steps once its group is closed, while JAX compiles; each job runs once
per test run, whichever pytest-xdist workers run its tests
(``torch_port_helpers.run_once``), and what the tests hold is kept.
"""

import os
import shutil

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

from acr_wsss_tpu import train as jax_train
from acr_wsss_tpu.configs import ModelConfig as JaxModelConfig
from acr_wsss_tpu.configs import TrainConfig as JaxTrainConfig
from acr_wsss_tpu.parallel import batch_sharding, fsdp_shardings, param_shardings, replicated
from acr_wsss_tpu.parallel import make_data_mesh_for_batch as jax_data_mesh
from acr_wsss_tpu.parallel import make_mesh as jax_make_mesh
from acr_wsss_tpu_torch import train as port_train
from acr_wsss_tpu_torch.configs import ModelConfig, TrainConfig
from acr_wsss_tpu_torch.models.convert import state_dict_to_flax
from acr_wsss_tpu_torch.parallel import mesh as port_mesh
from tests import torch_parallel_workers as workers
from tests.torch_port_helpers import build_acr_pair, flatten_params, run_once

CROP, BATCH, LR, MAX_STEP = 32, 8, 0.01, workers.MAX_STEP
TOL = 1e-4          # JAX's between its sharded and single-device steps
PORT_TOL = 1e-5     # the port's ranks against its one process
# Each tensor's update p1 - p0 on the ranks against the one process's,
# relative L2: float32 sums in another order (at most 7.8e-05 on this
# CPU, the hybrid stem's GroupNorm scales); an update that missed the
# all-reduce, or took it twice, reads 0.1 or more.
PORT_UPDATE_REL = 1e-3


@pytest.mark.parametrize("shape", [(-1,), (8,), (2, -1), (-1, 4), (2, 2, 2), (3,), (3, -1),
                                   (-1, -1), (16,)])
def test_mesh_shape_matches_jax(shape):
    names = ("data", "model", "seq")[:len(shape)]
    try:
        expected = jax_make_mesh(shape, names).devices.shape
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_mesh.resolve_shape(shape, 8)
        assert str(got.value) == str(e)
        return
    assert port_mesh.resolve_shape(shape, 8) == expected


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 6, 7, 8, 12, 16])
def test_data_mesh_for_batch_matches_jax(batch):
    assert port_mesh.data_extent(batch, len(jax.devices())) == jax_data_mesh(batch).devices.size


@pytest.mark.parametrize("axes", [("data", "seq"), ("data", "pipe"), ("data", "model", "seq")])
def test_other_axes_are_refused(axes):
    with pytest.raises(ValueError, match="not ported"):
        port_mesh.make_mesh((-1, 2) + (2,) * (len(axes) - 2), axes, "cpu")
    with pytest.raises(ValueError, match="not ported"):
        port_train.train(TrainConfig(mesh_shape=(-1, 2) + (2,) * (len(axes) - 2),
                                     mesh_axes=axes, device="cpu"))


@pytest.mark.parametrize("backbone, model", [("vitb_hybrid", 5), ("vit_small", 4)])
def test_a_model_axis_must_divide_the_heads(backbone, model):
    """``train`` refuses a model axis that does not divide the backbone's
    heads (12, 6) or its MLP hidden width, before it joins a group."""
    cfg = TrainConfig(model=ModelConfig(backbone=backbone), mesh_shape=(-1, model),
                      mesh_axes=("data", "model"), device="cpu")
    with pytest.raises(ValueError, match=f"{model} ranks must divide the"):
        port_train.train(cfg)


def _batches():
    rng = np.random.default_rng(0)
    out = {}
    for k in range(2):
        out[f"image{k}"] = rng.normal(size=(BATCH, CROP, CROP, 3)).astype(np.float32)
        label = np.zeros((BATCH, 20), np.float32)
        label[np.arange(BATCH), rng.integers(0, 20, BATCH)] = 1.0
        out[f"label{k}"] = label
    return out


def _jax_steps(backbone):
    """(JAX's model and parameters from the numpy weights of
    ``tests/torch_port_helpers.py``, the port's ``state_dict`` of them,
    its initial train state and jitted step)."""
    jax_model, params, port = build_acr_pair(CROP, seed=3, backbone=backbone)
    jcfg = JaxTrainConfig(model=JaxModelConfig(backbone=backbone, attn_impl="xla",
                                               compute_dtype="float32"),
                          crop_size=CROP, batch_size=BATCH, lr=LR, alpha=1.0)
    tx = jax_train.make_optimizer(jcfg.lr, MAX_STEP, jcfg.weight_decay, jcfg.momentum,
                                  jcfg.poly_power)
    state0 = jax_train.TrainState.create(apply_fn=jax_model.apply, params=params, tx=tx)
    step_fn = jax.jit(jax_train.make_train_step(jax_model, jcfg, (CROP // 16, CROP // 16)))
    return port.state_dict(), state0, step_fn


def _build_job(tmp):
    """The 2-rank step job (``torch_parallel_workers.step_job``: the
    2-rank steps, then the one-process steps and resumes) and the JAX
    side, which runs meanwhile: vitb's data-mesh and FSDP steps on batch
    0, and two vit_small single-device steps (batch 0, then batch 1).
    ``summary.pt`` keeps what the tests hold; the rest (about 1.5 GB of
    weights, parameters and checkpoints) goes."""
    batches = _batches()
    np.savez(tmp / "batches.npz", **batches)
    jax_side = {backbone: _jax_steps(backbone) for backbone in ("vitb", "vit_small")}
    for backbone, (state_dict, _, _) in jax_side.items():
        torch.save(state_dict, workers.weights_file(str(tmp), backbone))
    cfg = TrainConfig(model=ModelConfig(backbone="vitb", compute_dtype="float32"),
                      crop_size=CROP, batch_size=BATCH, lr=LR, alpha=1.0, device="cpu")
    ctx = mp.spawn(workers.step_job, args=(2, str(tmp / "store"), str(tmp), cfg), nprocs=2,
                   join=False)

    jb = [{"image": jnp.asarray(batches[f"image{k}"]), "label": jnp.asarray(batches[f"label{k}"])}
          for k in range(2)]
    _, state0, step_fn = jax_side["vitb"]
    mesh = jax_make_mesh((-1,), ("data",), devices=jax.devices()[:2])   # the ranks' 2
    sharded = {k: jax.device_put(v, batch_sharding(mesh)) for k, v in jb[0].items()}
    jax_out = {}
    for name, p_sh, o_sh in (
            ("ddp", param_shardings(mesh, state0.params), replicated(mesh)),
            ("fsdp", fsdp_shardings(mesh, state0.params), fsdp_shardings(mesh, state0.opt_state))):
        s = state0.replace(params=jax.device_put(state0.params, p_sh),
                           opt_state=jax.device_put(state0.opt_state, o_sh))
        s, parts = step_fn(s, sharded)
        jax_out[name] = (float(parts["loss"]), flatten_params(jax.device_get(s.params)))
    _, state0, step_fn = jax_side.pop("vit_small")
    s, _ = step_fn(state0, jb[0])
    s, _ = step_fn(s, jb[1])
    jax_out["two_steps"] = flatten_params(jax.device_get(s.params))
    del jax_side

    while not ctx.join(timeout=600):
        pass
    summary = {}
    for case in ("ddp", "fsdp"):
        out = torch.load(tmp / f"{case}.pt", weights_only=True)
        loss, jparams = jax_out[case]
        summary[case] = {"loss_err": abs(out["history"][0]["loss"] - loss),
                         "params": _params_err(_flax(out["params"], "vitb"), jparams),
                         "qkv": (out["qkv_local"], out["qkv_numel"])}
    for case in workers.ONE_PROCESS:
        summary[f"one_{case}"] = {
            "ranks": torch.load(tmp / f"{case}.pt", weights_only=True)["history"],
            **torch.load(tmp / f"one_{case}.pt", weights_only=True)}
    for case in ("ddp", "fsdp"):
        out = torch.load(tmp / f"resumed_{case}_resume.pt", weights_only=True)
        summary[f"resumed_{case}"] = {
            "steps": (out["restored_step"], out["updates"]),
            "params": _params_err(_flax(out["params"], "vit_small"), jax_out["two_steps"])}
    for f in list(tmp.iterdir()):
        if f.is_dir():
            shutil.rmtree(f)
        else:
            f.unlink()
    torch.save(summary, tmp / "summary.pt")


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """``_build_job``'s summary, built once per test run."""
    return torch.load(run_once(tmp_path_factory, "data_parallel_job", _build_job) / "summary.pt",
                      weights_only=True)


def _params_err(got, ref):
    """(whether the keys agree, the largest |got - ref| over every tensor)."""
    return got.keys() == ref.keys(), max(
        float(np.max(np.abs(np.asarray(got[k]) - np.asarray(ref[k])))) for k in ref if k in got)


def _assert_params(err, tol):
    same, worst = err
    assert same
    assert worst < tol, worst


def _flax(state_dict, backbone):
    """``state_dict`` in the flat flax layout JAX's params have."""
    with torch.device("meta"):
        model = port_train.build_model(ModelConfig(backbone=backbone, compute_dtype="float32"))
    return state_dict_to_flax(model, state_dict)


@pytest.mark.parametrize("case", ["ddp", "fsdp"])
def test_two_rank_step_matches_jax(job, case):
    out = job[case]
    assert out["loss_err"] < TOL
    _assert_params(out["params"], TOL)
    if case == "fsdp":
        local, numel = out["qkv"]
        assert local * 2 == numel


@pytest.mark.parametrize("case", workers.ONE_PROCESS)
def test_two_rank_step_matches_one_process(job, case):
    """Loss parts of each micro-step, every updated parameter and each
    tensor's update."""
    one = job[f"one_{case}"]
    for got, ref in zip(one["ranks"], one["history"], strict=True):
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=PORT_TOL, err_msg=k)
    assert one["worst"] < PORT_TOL, one["worst"]
    rel = one["update_rel"]
    worst = max(rel, key=rel.get)
    assert rel[worst] < PORT_UPDATE_REL, (worst, rel[worst])


@pytest.mark.parametrize("case", ["ddp", "fsdp"])
def test_elastic_resume_matches_two_jax_steps(job, case):
    """2 ranks -> checkpoint -> 1 process: the restored step continues the
    schedule and the momentum."""
    out = job[f"resumed_{case}"]
    assert out["steps"] == (0, 2)
    _assert_params(out["params"], TOL)


# --- train_swin over the data mesh ---------------------------------------------

# The Swin step's tolerances against JAX on one device
# (tests/test_torch_swin.py::test_swin_train_step_matches_jax): loss parts
# 2e-5 relative; parameters after the update 1e-4 relative plus 2e-6.
SWIN_PARTS_RTOL, SWIN_RTOL, SWIN_ATOL = 2e-5, 1e-4, 2e-6


def _swin_voc(root, n=4):
    """``n`` JPEGs at least as large as the crop (a zero-padded crop from
    the seeded init diverges, ROADMAP Queue 3), labels, a list."""
    from PIL import Image

    (root / "img").mkdir()
    rng = np.random.default_rng(4)
    labels = {}
    for i in range(n):
        h, w = 64 + 6 * (i % 3), 70 + 4 * i
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "img" / f"s{i}.jpg")
        labels[f"s{i}"] = np.eye(20, dtype=np.float32)[[i, (3 * i + 5) % 20]].sum(0)
    np.save(root / "cls_labels.npy", labels)
    (root / "train.txt").write_text("".join(f"s{i}\n" for i in range(n)))
    return ["--model", workers.SWIN_NAME, "--batch_size", str(workers.SWIN_BATCH),
            "--max_epoches", "1", "--crop_size", str(workers.SWIN_CROP), "--lr", "0.01",
            "--IMpath", str(root / "img"), "--train_list", str(root / "train.txt"),
            "--cls_labels", str(root / "cls_labels.npy"), "--weight_dir", str(root / "cli"),
            "--session_name", "sw", "--device", "cpu"]


def _build_swin_job(tmp):
    """The 2-rank Swin job (``torch_parallel_workers.swin_job``, which also
    takes the port's one-process step) and, while it runs, JAX's data-mesh
    step, whose loss parts and parameters go to ``tmp/swin_jax.pt``."""
    from acr_wsss_tpu import train_swin as jax_train_swin
    from acr_wsss_tpu.models import swin as jax_swin
    from acr_wsss_tpu.train import TrainState as JaxTrainState
    from acr_wsss_tpu_torch.models.convert import flax_to_state_dict
    from tests.torch_port_helpers import jit_o0, random_flax_params, unflatten_params

    crop, batch_size = workers.SWIN_CROP, workers.SWIN_BATCH
    kw = {k: v for k, v in workers.SWIN_KW.items() if k != "img_size"}
    jm = jax_swin.SwinTransformer(dtype=jnp.float32, **kw)
    flat = random_flax_params(jm, jnp.zeros((1, crop, crop, 3)), seed=6)
    weights = flax_to_state_dict(flat, _small_swin().state_dict())
    torch.save(weights, tmp / "swin_weights.pt")
    rng = np.random.default_rng(7)
    batch = {"image": (rng.normal(size=(batch_size, crop, crop, 3))
                       + [0.3, -0.2, 0.1]).astype(np.float32),
             "label": (rng.uniform(size=(batch_size, 20)) > 0.8).astype(np.float32)}
    np.savez(tmp / "swin_batch.npz", **batch)
    argv = _swin_voc(tmp)
    ctx = mp.spawn(workers.swin_job, args=(2, str(tmp / "store"), str(tmp), argv), nprocs=2,
                   join=False)

    jcfg = JaxTrainConfig(model=JaxModelConfig(backbone="swin"), crop_size=crop,
                          batch_size=batch_size, lr=workers.SWIN_LR)
    tx = jax_train.make_optimizer(jcfg.lr, MAX_STEP, jcfg.weight_decay, jcfg.momentum,
                                  jcfg.poly_power)
    state = JaxTrainState.create(apply_fn=jm.apply, params=unflatten_params(flat), tx=tx)
    mesh = jax_make_mesh((-1,), ("data",), devices=jax.devices()[:2])
    state = state.replace(params=jax.device_put(state.params, param_shardings(mesh, state.params)),
                          opt_state=jax.device_put(state.opt_state, replicated(mesh)))
    step = jit_o0(jax_train_swin.make_swin_train_step(jm, jcfg, crop))
    state, parts = step(state, {k: jax.device_put(jnp.asarray(v), batch_sharding(mesh))
                                for k, v in batch.items()})
    torch.save({"parts": {k: float(v) for k, v in parts.items()},
                "params": {k: torch.from_numpy(np.array(v)) for k, v in
                           flatten_params(jax.device_get(state.params)).items()}},
               tmp / "swin_jax.pt")
    while not ctx.join(timeout=600):
        pass


def _small_swin():
    from acr_wsss_tpu_torch.models import swin

    return swin.SwinTransformer(**workers.SWIN_KW, dtype=torch.float32)


@pytest.fixture(scope="module")
def swin_job(tmp_path_factory):
    """(the job's directory, JAX's loss parts and parameters, the port's
    one-process step's, the small Swin); the job built once per test run."""
    tmp = run_once(tmp_path_factory, "swin_parallel_job", _build_swin_job)
    jax_out = torch.load(tmp / "swin_jax.pt", weights_only=True)
    one = torch.load(tmp / "swin_one.pt", weights_only=True)
    return (tmp, (jax_out["parts"], {k: v.numpy() for k, v in jax_out["params"].items()}),
            (one["parts"], one["params"]), _small_swin())


def test_two_rank_swin_step_matches_jax(swin_job):
    tmp, (jparts, jparams), _, pm = swin_job
    out = torch.load(tmp / "swin_ddp.pt", weights_only=True)
    assert jparts["window_consistency"] > 0
    for k, v in jparts.items():
        np.testing.assert_allclose(out["parts"][k], v, rtol=SWIN_PARTS_RTOL, err_msg=k)
    got = state_dict_to_flax(pm, out["params"])
    assert got.keys() == jparams.keys()
    for k, v in jparams.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=SWIN_RTOL, atol=SWIN_ATOL,
                                   err_msg=k)


def test_two_rank_swin_step_matches_one_process(swin_job):
    """Loss parts and every parameter after the update within PORT_TOL, and
    each tensor's update within PORT_UPDATE_REL, of the one process's on
    the whole batch."""
    tmp, _, (parts, after), _ = swin_job
    out = torch.load(tmp / "swin_ddp.pt", weights_only=True)
    weights = torch.load(tmp / "swin_weights.pt", weights_only=True)
    for k, v in parts.items():
        np.testing.assert_allclose(out["parts"][k], v, rtol=PORT_TOL, err_msg=k)
    worst = max(float((v - after[k]).abs().max()) for k, v in out["params"].items())
    assert worst < PORT_TOL, worst
    rel = workers.update_rel(out["params"], after, weights)
    assert max(rel.values()) < PORT_UPDATE_REL, max(rel, key=rel.get)


def test_train_swin_cli_on_two_ranks_writes_the_npz_on_rank_0(swin_job):
    """4 images, a global batch of 4: 1 update, 2 steps on each rank (the
    range's and the one at its end), the same averaged loss parts on both;
    ``_last.npz`` in rank 0's weight directory only, loadable by the small
    Swin."""
    from acr_wsss_tpu_torch.models.convert import flax_to_state_dict
    from acr_wsss_tpu_torch.utils.checkpoint import load_params_npz

    tmp, _, _, pm = swin_job
    runs = [torch.load(tmp / f"swin_cli{r}.pt", weights_only=True) for r in range(2)]
    assert runs[0]["steps"] == runs[1]["steps"] == 2
    assert runs[0]["history"] == runs[1]["history"]
    assert all(np.isfinite(v) for parts in runs[0]["history"] for v in parts.values())
    assert os.listdir(tmp / "cli" / "rank0") == ["sw_last.npz"]
    assert not (tmp / "cli" / "rank1").exists()
    flax_to_state_dict(load_params_npz(str(tmp / "cli" / "rank0" / "sw_last.npz")),
                       pm.state_dict())
