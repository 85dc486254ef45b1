"""Checkpoints and pretrained weights of the port, on the CPU.

* ``CheckpointManager`` with ``train.checkpoint_state`` /
  ``restore_checkpoint``: a round trip of vitb (crop 32, float32) and its
  ``PolySGD`` restores parameters, momentum buffers, lr, the schedule's
  position and the counters bit for bit, also in the middle of a gradient
  accumulation (its running mean too), and the next step from the
  restored state equals the next step from the state in memory; only the
  newest 3 entries are kept; a temporary file left by an interrupted save
  is not an entry; a save is a copy.
* ``models/zoo.init_with_pretrained``: on a zoo npz written from
  JAX-initialized weights, the port's trunk, through ``state_dict_to_flax``,
  equals what the JAX package's ``init_with_pretrained`` grafts, bit for
  bit; the head keeps its seeded init.
"""

import dataclasses
import re
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acr_wsss_tpu.models import zoo as jax_zoo
from acr_wsss_tpu.models.acr import ACR as JaxACR
from acr_wsss_tpu.utils.checkpoint import save_params_npz as jax_save_params_npz
from acr_wsss_tpu_torch import train as port_train
from acr_wsss_tpu_torch.configs import ModelConfig, TrainConfig
from acr_wsss_tpu_torch.models import zoo
from acr_wsss_tpu_torch.models.convert import state_dict_to_flax
from acr_wsss_tpu_torch.utils.checkpoint import CheckpointManager
from tests.torch_port_helpers import flatten_params

CROP = 32


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Checkpoints of vitb are about 0.7 GB each: remove them after each
    test instead of leaving them to pytest's retention of the last runs."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cfg(**kw):
    return TrainConfig(model=ModelConfig(backbone="vitb", compute_dtype="float32"),
                       crop_size=CROP, batch_size=2, lr=0.01, alpha=1.0, device="cpu", **kw)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(2, CROP, CROP, 3)).astype(np.float32),
             "label": (rng.uniform(size=(2, 20)) > 0.7).astype(np.float32)}
            for _ in range(n)]


def _optimizer_tensors(opt):
    """Every tensor of the optimizer state: SGD's per-parameter state and
    the accumulation buffers."""
    out = {f"sgd/{i}/{k}": v for i, p in enumerate(opt.params)
           for k, v in opt.sgd.state[p].items()}
    out.update({f"acc/{i}": a for i, a in enumerate(opt._acc if opt.mini_step else [])})
    return out


def _assert_same_state(model_a, opt_a, model_b, opt_b):
    for (ka, a), (kb, b) in zip(model_a.state_dict().items(), model_b.state_dict().items(),
                                strict=True):
        assert ka == kb and torch.equal(a, b), ka
    ta, tb = _optimizer_tensors(opt_a), _optimizer_tensors(opt_b)
    assert ta.keys() == tb.keys() and ta
    assert all(torch.equal(ta[k], tb[k]) for k in ta)
    assert (opt_a.lr, opt_a.mini_step, opt_a.updates) == (opt_b.lr, opt_b.mini_step,
                                                          opt_b.updates)
    assert opt_a.schedule.state_dict() == opt_b.schedule.state_dict()


@pytest.mark.parametrize("accum_steps,steps", [(1, 2), (2, 3)],
                         ids=["after_update", "mid_accumulation"])
def test_round_trip_is_bit_exact(tmp_path, accum_steps, steps):
    cfg = _cfg(accum_steps=accum_steps)
    grid = (CROP // 16, CROP // 16)
    model, opt = port_train.create_train_state(cfg, max_step=10)
    step = port_train.make_train_step(model, opt, cfg, grid)
    batches = _batches(steps + 1)
    for b in batches[:steps]:
        step(b)
    assert opt.mini_step == (steps % accum_steps)   # 3 calls at accum 2: 1 in flight
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save(steps - 1, port_train.checkpoint_state(steps - 1, model, opt))
    ckpt.close()

    fresh_model, fresh_opt = port_train.create_train_state(
        dataclasses.replace(cfg, seed=1), max_step=10)
    assert port_train.restore_checkpoint(ckpt, fresh_model, fresh_opt) == steps - 1
    _assert_same_state(model, opt, fresh_model, fresh_opt)
    # the next step from either state lands on the same bits
    port_train.make_train_step(fresh_model, fresh_opt, cfg, grid)(batches[-1])
    step(batches[-1])
    _assert_same_state(model, opt, fresh_model, fresh_opt)


def test_keeps_newest_three_and_ignores_temporary_files(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    assert ckpt.latest_step() is None and ckpt.restore() is None
    for step in (5, 10, 15, 20, 25):
        ckpt.save(step, {"w": torch.full((3,), float(step)), "step": step})
    ckpt.wait()
    assert ckpt.steps() == [15, 20, 25]
    # what a save killed before its rename leaves behind
    (tmp_path / "ck" / "30.pt.tmp4242").write_bytes(b"partial")
    assert ckpt.latest_step() == 25
    restored = ckpt.restore()
    assert restored["step"] == 25 and torch.equal(restored["w"], torch.full((3,), 25.0))
    assert ckpt.restore(15)["step"] == 15
    ckpt.close()


def test_save_copies_before_returning(tmp_path):
    """The trainer updates its tensors in place right after a save."""
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    w = torch.zeros(1000)
    ckpt.save(1, {"w": w, "nested": [w]})
    w.add_(1.0)
    restored = ckpt.restore()
    assert torch.equal(restored["w"], torch.zeros(1000))
    assert torch.equal(restored["nested"][0], torch.zeros(1000))


def test_init_with_pretrained_matches_jax_graft(tmp_path):
    """Zoo npz of JAX-initialized weights (trunk and head); both packages
    graft its trunk, the head stays each side's own init."""
    dummy = jnp.zeros((1, CROP, CROP, 3))
    jax_model = JaxACR(backbone_name="vitb", dtype=jnp.float32)
    donor = jax_model.init(jax.random.key(3), dummy)
    jax_save_params_npz(jax_zoo.npz_path("vitb", str(tmp_path)), donor)
    ref = flatten_params(jax_zoo.init_with_pretrained(jax_model, jax.random.key(4), dummy,
                                                      directory=str(tmp_path)))
    donor = flatten_params(donor)

    port = zoo.init_with_pretrained(port_train.build_model(ModelConfig(backbone="vitb")),
                                    seed=5, directory=str(tmp_path))
    got = state_dict_to_flax(port)
    assert got.keys() == ref.keys()
    trunk = [k for k in got if k.startswith("params/trunk/")]
    head = [k for k in got if not k.startswith("params/trunk/")]
    assert len(trunk) > 100 and head
    for k in trunk:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    seeded = state_dict_to_flax(port_train.init_random_(
        port_train.build_model(ModelConfig(backbone="vitb")), seed=5))
    for k in head:
        np.testing.assert_array_equal(got[k], seeded[k], err_msg=k)
    assert not np.array_equal(got["params/cls_head/kernel"],
                              np.asarray(donor["params/cls_head/kernel"]))


def test_pretrained_flag_reads_the_zoo_and_a_missing_file_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("ACR_WSSS_ZOO", str(tmp_path))
    cfg = _cfg(pretrained=True)
    with pytest.raises(FileNotFoundError, match=re.escape(str(tmp_path / "vitb_in21k.npz"))):
        port_train.create_train_state(cfg, max_step=1)
    donor = port_train.init_random_(port_train.build_model(cfg.model), seed=9)
    zoo_flat = {k: v for k, v in state_dict_to_flax(donor).items()
                if k.startswith("params/trunk/")}
    np.savez(tmp_path / "vitb_in21k.npz", **zoo_flat)
    model, _ = port_train.create_train_state(cfg, max_step=1)
    got = state_dict_to_flax(model)
    assert all(np.array_equal(got[k], v) for k, v in zoo_flat.items())
    np.savez(tmp_path / "vitb_in21k.npz", **dict(list(zoo_flat.items())[1:]))
    with pytest.raises(ValueError, match="missing"):
        port_train.create_train_state(cfg, max_step=1)
