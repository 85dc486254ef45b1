"""The port's training loop resumes as the JAX package's does, on the CPU.

On the fixture and config of ``tests/test_train_loop.py`` (8 images,
batch 4, 2 epochs: loop steps 0..4; vitb at crop 32 in float32):

* a run counts 5 optimizer applications (JAX ``state.step``), saves a
  checkpoint at step 3, and a second launch resumes at step 4 and counts
  4 (``:65-84``), without the seeded init that the restore overwrites;
* its metrics JSONL has the steps and keys of the JAX loop's on the same
  fixture;
* SIGTERM in the first step saves a checkpoint at step 0, writes no final
  npz and restores the previous handler; the restored parameters and
  optimizer equal the preempted run's bit for bit, the restored lr is the
  JAX schedule's at that update count, and a relaunch finishes
  (``:283-330``);
* ``profile_dir`` gets a trace of the profiler window.
"""

import dataclasses
import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch
from PIL import Image

from acr_wsss_tpu.configs import ModelConfig as JaxModelConfig
from acr_wsss_tpu.configs import TrainConfig as JaxTrainConfig
from acr_wsss_tpu.utils.schedule import poly_schedule
from acr_wsss_tpu_torch import train as train_mod
from acr_wsss_tpu_torch.configs import ModelConfig, TrainConfig
from acr_wsss_tpu_torch.utils.checkpoint import CheckpointManager
from tests.torch_port_helpers import run_once


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Checkpoints of vitb are about 0.7 GB each: remove them after each
    test instead of leaving them to pytest's retention of the last runs."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _write_tiny_voc(root):
    (root / "img").mkdir(parents=True)
    rng = np.random.default_rng(0)
    names, labels = [], {}
    for i in range(8):
        name = f"t{i}"
        names.append(name)
        Image.fromarray(rng.integers(0, 255, size=(70, 90, 3), dtype=np.uint8)).save(
            root / "img" / f"{name}.jpg")
        lab = np.zeros(20, np.float32)
        lab[i % 20] = 1.0
        labels[name] = lab
    np.save(root / "cls_labels.npy", labels)
    (root / "train.txt").write_text("\n".join(names) + "\n")
    (root / "val.txt").write_text("\n".join(names[:2]) + "\n")
    return root


@pytest.fixture(scope="module")
def tiny_voc(tmp_path_factory):
    return _write_tiny_voc(tmp_path_factory.mktemp("torch_resume"))


def _fields(root, weight_dir):
    return dict(crop_size=32, batch_size=4, max_epochs=2, lr=0.001, alpha=1.0,
                log_every=2, val_every=1000, checkpoint_every=3,
                checkpoint_dir=str(weight_dir), session_name="tinytrain",
                image_dir=str(root / "img"), train_list=str(root / "train.txt"),
                val_list=str(root / "val.txt"), cls_labels_path=str(root / "cls_labels.npy"),
                num_workers=2)


def _cfg(root, weight_dir, **kw):
    return TrainConfig(model=ModelConfig(backbone="vitb", compute_dtype="float32"),
                       device="cpu", **_fields(root, weight_dir), **kw)


def _records(cfg):
    with open(os.path.join(cfg.checkpoint_dir, f"{cfg.session_name}_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _build_resumed_run(root):
    """A full run with the profiler window on steps 1-2, then a relaunch
    of the same config, which restores every parameter and so must not
    draw the seeded init first. ``summary.pt`` keeps what the tests hold
    and ``trace.json`` the trace; the checkpoints (about 0.7 GB each) and
    the npz go."""
    weight = root / "weight"
    cfg = _cfg(_write_tiny_voc(root / "voc"), weight, profile_dir=str(weight / "profile"))
    window = train_mod.PROFILE_WINDOW
    train_mod.PROFILE_WINDOW = (1, 2)
    try:
        first = train_mod.train(cfg)
    finally:
        train_mod.PROFILE_WINDOW = window
    records = _records(cfg)

    def no_init(model, seed):
        raise AssertionError("the relaunch drew the seeded init before restoring")

    init = train_mod.init_random_
    train_mod.init_random_ = no_init
    try:
        second = train_mod.train(dataclasses.replace(cfg, profile_dir=None))
    finally:
        train_mod.init_random_ = init
    npz = os.path.exists(os.path.join(cfg.checkpoint_dir, "tinytrain_last.npz"))
    ckpt_steps = CheckpointManager(os.path.join(cfg.checkpoint_dir, cfg.session_name)).steps()
    shutil.copy(os.path.join(cfg.checkpoint_dir, "profile", "tinytrain_trace.json"),
                root / "trace.json")
    torch.save({"first": (first.step, first.steps, first.optimizer.updates),
                "second": (second.step, second.steps, second.optimizer.updates),
                "second_history": second.history, "npz": npz, "ckpt_steps": ckpt_steps,
                "records": records}, root / "summary.pt")
    shutil.rmtree(weight)


@pytest.fixture(scope="module")
def resumed_run(tmp_path_factory):
    """``_build_resumed_run``'s directory and summary, built once per test
    run."""
    root = run_once(tmp_path_factory, "torch_resumed_run", _build_resumed_run)
    return root, torch.load(root / "summary.pt", weights_only=True)


def test_train_checkpoints_and_resumes_like_jax(resumed_run):
    _, out = resumed_run
    # 5 optimizer applications (loop steps 0..4), as JAX's state.step
    assert out["first"] == (5, 5, 5)
    assert out["npz"]
    assert out["ckpt_steps"] == [3]
    # the relaunch restores step 3 and runs loop step 4 only
    assert out["second"] == (4, 1, 5)
    history = out["second_history"]
    assert len(history) == 1 and np.isfinite(history[0]["loss"])


def test_metrics_stream_matches_the_jax_loop(resumed_run, tiny_voc, tmp_path):
    """Same steps and keys as the JAX loop's JSONL on the same fixture."""
    from acr_wsss_tpu.train import train as jax_train

    records = resumed_run[1]["records"]
    jax_cfg = JaxTrainConfig(model=JaxModelConfig(backbone="vitb", attn_impl="xla",
                                                  compute_dtype="float32"),
                             **{**_fields(tiny_voc, tmp_path), "checkpoint_every": 10 ** 6})
    jax_train(jax_cfg)
    jax_records = _records(jax_cfg)
    assert [r["step"] for r in records] == [r["step"] for r in jax_records] == [0, 2, 4]
    assert [sorted(r) for r in records] == [sorted(r) for r in jax_records]
    assert all(r["kind"] == "train" and np.isfinite(r["loss"]) for r in records)


def test_profiler_window_writes_a_trace(resumed_run):
    with open(resumed_run[0] / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_preemption_saves_and_resumes(tiny_voc, tmp_path, monkeypatch):
    cfg = _cfg(tiny_voc, tmp_path / "weight")
    orig_add = train_mod.AverageMeter.add
    fired = []

    def add_then_sigterm(self, values):
        orig_add(self, values)
        if not fired:
            fired.append(True)
            signal.raise_signal(signal.SIGTERM)

    monkeypatch.setattr(train_mod.AverageMeter, "add", add_then_sigterm)
    before = signal.getsignal(signal.SIGTERM)
    state = train_mod.train(cfg)
    monkeypatch.setattr(train_mod.AverageMeter, "add", orig_add)

    assert (state.step, state.steps) == (1, 1)
    assert not os.path.exists(os.path.join(cfg.checkpoint_dir, "tinytrain_last.npz"))
    ckpt = CheckpointManager(os.path.join(cfg.checkpoint_dir, cfg.session_name))
    assert ckpt.latest_step() == 0
    assert signal.getsignal(signal.SIGTERM) == before

    # what a relaunch restores is the preempted state, bit for bit
    model, opt = train_mod.create_train_state(dataclasses.replace(cfg, seed=1), max_step=4)
    assert train_mod.restore_checkpoint(ckpt, model, opt) == 0
    for (k, a), b in zip(state.model.state_dict().items(), model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(state.optimizer.params, opt.params, strict=True):
        assert torch.equal(state.optimizer.sgd.state[a]["momentum_buffer"],
                           opt.sgd.state[b]["momentum_buffer"])
    assert opt.updates == 1
    np.testing.assert_allclose(opt.lr, float(poly_schedule(cfg.lr, 4, cfg.poly_power)(1)),
                               rtol=1e-6)
    del model, opt

    state2 = train_mod.train(cfg)
    assert (state2.step, state2.steps) == (4, 4)
    assert os.path.exists(os.path.join(cfg.checkpoint_dir, "tinytrain_last.npz"))
