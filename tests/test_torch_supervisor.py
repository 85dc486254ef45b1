"""The port's failure recovery on the CPU: the hung-step watchdog, the
preemption guard, the metric stream and the relaunch supervisor
(``acr_wsss_tpu_torch/utils/{watchdog,preemption,logging,supervisor}.py``),
held to the behaviour of the JAX package's copies
(``tests/test_utils.py``, ``tests/test_supervisor.py:67-110``).

The supervised run trains vitb at crop 32 in float32 on the CPU in a
spawned child: a hang injected after the step-2 checkpoint
(``ACR_FAULT_HANG_ONCE``) trips the watchdog, the child exits 75, and the
relaunch resumes from that checkpoint and finishes.
"""

import dataclasses
import json
import os
import shutil
import signal
import time

import numpy as np
import pytest
from PIL import Image

from acr_wsss_tpu.utils.logging import MetricWriter as JaxMetricWriter
from acr_wsss_tpu_torch.configs import ModelConfig, TrainConfig
from acr_wsss_tpu_torch.utils.checkpoint import CheckpointManager
from acr_wsss_tpu_torch.utils.logging import MetricWriter
from acr_wsss_tpu_torch.utils.preemption import PreemptionGuard
from acr_wsss_tpu_torch.utils.supervisor import run_train_supervised
from acr_wsss_tpu_torch.utils.watchdog import EX_TEMPFAIL, StepWatchdog


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Checkpoints of vitb are about 0.7 GB each: remove them after each
    test instead of leaving them to pytest's retention of the last runs."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture()
def tiny_voc(tmp_path):
    img_dir = tmp_path / "img"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    names, labels = [], {}
    for i in range(8):
        name = f"s{i}"
        names.append(name)
        Image.fromarray(rng.integers(0, 255, size=(40, 48, 3), dtype=np.uint8)).save(
            img_dir / f"{name}.jpg")
        lab = np.zeros(20, np.float32)
        lab[i % 20] = 1.0
        labels[name] = lab
    np.save(tmp_path / "cls_labels.npy", labels)
    (tmp_path / "train.txt").write_text("\n".join(names) + "\n")
    return tmp_path


def _cfg(root, step_timeout_s=0.0):
    return TrainConfig(
        model=ModelConfig(backbone="vitb", compute_dtype="float32"), crop_size=32,
        batch_size=4, max_epochs=2,            # 2 steps/epoch -> loop steps 0..4
        lr=0.001, alpha=1.0, log_every=1, val_every=1000, checkpoint_every=2,
        checkpoint_dir=str(root / "weight"), session_name="sup",
        image_dir=str(root / "img"), train_list=str(root / "train.txt"),
        val_list=str(root / "train.txt"), cls_labels_path=str(root / "cls_labels.npy"),
        num_workers=2, step_timeout_s=step_timeout_s, device="cpu")


def test_hang_watchdog_relaunch_resumes_to_completion(tiny_voc, monkeypatch, capsys):
    # A live step with its checkpoint takes seconds on a loaded CPU (the
    # children run torch on one thread, beside the other test workers); the
    # injected hang sleeps for good, so the watchdog still fires, later.
    cfg = _cfg(tiny_voc, step_timeout_s=30.0)
    sentinel = tiny_voc / "hang_injected"
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MKL_NUM_THREADS", "1")
    monkeypatch.setenv("ACR_FAULT_HANG_ONCE", str(sentinel))
    monkeypatch.setenv("ACR_FAULT_HANG_BEAT", "3")   # the beat after step 2's checkpoint
    t0 = time.monotonic()
    relaunches = run_train_supervised(cfg, max_relaunches=1)
    assert relaunches == 1 and sentinel.exists()
    assert "relaunch 1/1" in capsys.readouterr().out
    assert os.path.exists(os.path.join(cfg.checkpoint_dir, "sup_last.npz"))
    ckpt = CheckpointManager(os.path.join(cfg.checkpoint_dir, "sup"))
    assert ckpt.steps() == [2, 4]          # step 2 before the hang; step 4 after the resume
    assert time.monotonic() - t0 >= cfg.step_timeout_s
    # the relaunch went on from step 3: each step logged once
    with open(os.path.join(cfg.checkpoint_dir, "sup_metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [0, 1, 2, 3, 4]


def test_non_watchdog_failure_is_not_retried(tiny_voc):
    cfg = dataclasses.replace(_cfg(tiny_voc), image_dir=str(tiny_voc / "does_not_exist"))
    with pytest.raises(RuntimeError, match="exit code 1 after 0 relaunch"):
        run_train_supervised(cfg, max_relaunches=3)


def test_step_watchdog_fires_on_stall():
    """No beat within the budget -> exit_fn once with a diagnosis; steady
    beats keep it quiet."""
    fired = []
    wd = StepWatchdog(0.3, exit_fn=fired.append)
    for _ in range(4):
        wd.beat()
        time.sleep(0.1)
    assert not fired
    time.sleep(1.0)
    assert len(fired) == 1 and "watchdog" in fired[0] and str(EX_TEMPFAIL) in fired[0]
    wd.stop()


def test_step_watchdog_disabled_and_clock_starts_at_first_beat():
    fired = []
    off = StepWatchdog(0.0, exit_fn=fired.append)
    off.beat()
    time.sleep(0.3)
    assert not fired and not off.enabled
    off.stop()
    armed = StepWatchdog(0.1, exit_fn=fired.append)   # never beaten: no clock
    time.sleep(0.3)
    assert not fired
    armed.stop()


def test_preemption_guard_flags_then_restores_handlers():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.fired
        signal.raise_signal(signal.SIGTERM)
        assert guard.fired
    assert signal.getsignal(signal.SIGTERM) == before


def test_metric_writer_records_match_jax(tmp_path):
    """The same records as the JAX package's writer, apart from the time."""
    records = {}
    for name, cls in (("port", MetricWriter), ("jax", JaxMetricWriter)):
        path = tmp_path / f"{name}.jsonl"
        with cls(str(path)) as w:
            w.write(10, {"loss": 1.5, "imps": np.float32(100.0)})
            w.write(20, {"loss": 1.2, "tag": "x"}, kind="val")
        records[name] = [json.loads(line) for line in open(path)]
    for r in records["port"] + records["jax"]:
        assert isinstance(r.pop("time"), float)
    assert records["port"] == records["jax"]
