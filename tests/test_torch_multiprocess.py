"""The port's training loop and CAM inference across processes, on the CPU.

On the tiny VOC fixture of ``tests/test_torch_resume.py`` (8 images of
70x90; 3 validation names here, so that the ranks' shares differ), vit_small
at crop 32 in float32, ranks spawned over gloo and a ``file://`` store:

* ``train.train`` through ``--multihost`` with the launcher's variables in
  each rank's environment, 2 ranks at global batch 4. SIGTERM to rank 1
  alone: the flag is agreed at the next ``log_every`` step, and both
  ranks stop there with one checkpoint. The relaunch resumes on both and
  finishes the 5 steps with the same loss parts; rank 0 alone writes the
  ``_last.npz`` and the metrics (one record per logged step); the last
  validation loss, reduced over the ranks, equals one process's
  validation of the npz's weights. A launch in which rank 1 sees no
  checkpoint where rank 0 sees one fails on both ranks.
* A rank beyond the data mesh (the largest divisor of the global batch
  that the ranks can hold) idles: ``train.train`` returns None there, on
  torch's in-process fake process group.
* ``--multihost`` without a launcher's environment fails with its message.
* ``infer_cam --dp 2 --device cpu`` writes the files of ``--dp 0``, with
  and without ``--pamr 2``, to the bit, although each worker batches its
  share of the list (``--batch_images`` 4) in other groups; the one
  process runs on a worker's share of the CPU's threads, since CPU
  kernels sum in an order that depends on their thread count. ``--dp``
  beyond the visible GPUs fails with JAX's message.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from PIL import Image

from acr_wsss_tpu_torch import infer_cam
from acr_wsss_tpu_torch import train as train_mod
from acr_wsss_tpu_torch.configs import InferConfig, ModelConfig, TrainConfig
from acr_wsss_tpu_torch.models.acr import ACR, init_random_
from acr_wsss_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from acr_wsss_tpu_torch.utils.checkpoint import (CheckpointManager, load_params_npz,
                                                 save_params_npz)
from tests import torch_parallel_workers as workers

BACKBONE, CROP = "vit_small", 32


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Checkpoints and npz files of vit_small: removed after each test."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def tiny_voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_multiprocess")
    (root / "img").mkdir()
    rng = np.random.default_rng(0)
    names, labels = [], {}
    for i in range(8):
        name = f"t{i}"
        names.append(name)
        Image.fromarray(rng.integers(0, 255, size=(70, 90, 3), dtype=np.uint8)).save(
            root / "img" / f"{name}.jpg")
        lab = np.zeros(20, np.float32)
        lab[i % 20] = 1.0
        lab[(3 * i + 5) % 20] = 1.0
        labels[name] = lab
    np.save(root / "cls_labels.npy", labels)
    (root / "train.txt").write_text("\n".join(names) + "\n")
    (root / "val.txt").write_text("\n".join(names[:3]) + "\n")
    yield root
    shutil.rmtree(root, ignore_errors=True)


def _cfg(root, weight_dir, **kw):
    fields = dict(crop_size=CROP, batch_size=4, max_epochs=2, lr=0.001, alpha=1.0,
                  log_every=2, val_every=2, checkpoint_every=1000,
                  checkpoint_dir=str(weight_dir), session_name="mp",
                  image_dir=str(root / "img"), train_list=str(root / "train.txt"),
                  val_list=str(root / "val.txt"), cls_labels_path=str(root / "cls_labels.npy"),
                  num_workers=2, device="cpu")
    fields.update(kw)
    return TrainConfig(model=ModelConfig(backbone=BACKBONE, compute_dtype="float32"), **fields)


@pytest.fixture(scope="module")
def runs(tiny_voc, tmp_path_factory):
    """2 ranks at global batch 4: a run with SIGTERM to rank 1 alone after
    step 1, a relaunch that resumes from its checkpoint and finishes, and
    a launch whose rank 1 sees another checkpoint directory; each rank's
    results of the three."""
    weight = tmp_path_factory.mktemp("mp_weight")
    cfg = _cfg(tiny_voc, weight)
    mp.spawn(workers.train_job, args=(2, str(weight / "store"), cfg, 1, 1), nprocs=2,
             join=True)
    yield cfg, [torch.load(weight / f"rank{r}.pt", weights_only=False) for r in range(2)]
    shutil.rmtree(weight, ignore_errors=True)


def test_sigterm_to_one_rank_stops_both_at_one_step(runs):
    cfg, ((r0, _, _), (r1, _, _)) = runs
    # the signal lands in step 1; the flag is agreed at step 2 (log_every)
    assert (r0["step"], r0["steps"]) == (r1["step"], r1["steps"]) == (3, 3)
    assert r0["history"] == r1["history"]


def test_relaunch_on_two_data_ranks_resumes_and_finishes(runs):
    cfg, ((_, r0, _), (_, r1, _)) = runs
    # the step-2 checkpoint restored (JAX's step count 2), then steps 3 and 4
    assert (r0["step"], r0["steps"]) == (r1["step"], r1["steps"]) == (4, 2)
    assert r0["history"] == r1["history"] and r0["val"] == r1["val"]
    assert len(r0["val"]) == 1 and np.isfinite(r0["val"]).all()
    ckpt = CheckpointManager(os.path.join(cfg.checkpoint_dir, cfg.session_name))
    assert ckpt.steps() == [2]
    files = sorted(os.listdir(cfg.checkpoint_dir))
    assert "mp_last.npz" in files and "mp_metrics.jsonl" in files
    # rank 0 alone logs: steps 0 and 2 of the first run, 4 of the relaunch
    with open(os.path.join(cfg.checkpoint_dir, "mp_metrics.jsonl")) as f:
        assert [int(line.split('"step": ')[1].split(",")[0]) for line in f] == [0, 2, 4]

    # one process validates the npz's weights (those of the last validation)
    model = train_mod.build_model(cfg.model)
    model.load_state_dict(flax_to_state_dict(
        load_params_npz(os.path.join(cfg.checkpoint_dir, "mp_last.npz")), model.state_dict()))
    one = train_mod.validate(cfg, model, train_mod.make_eval_step(model))
    np.testing.assert_allclose(r0["val"][-1], one, rtol=1e-6)


def test_ranks_that_see_other_checkpoints_fail(runs):
    """Rank 0 sees the step-2 checkpoint, rank 1 none: both fail before
    building the model, rather than train from other states."""
    _, ((_, _, e0), (_, _, e1)) = runs
    for error in (e0, e1):
        assert error is not None and "shared by every node" in error
        assert "latest step none on one rank, 2 on another" in error


@pytest.mark.parametrize("rank,world,batch", [(2, 3, 4), (3, 4, 6), (4, 5, 8)])
def test_a_rank_beyond_the_data_mesh_idles(tmp_path, rank, world, batch):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    torch.distributed.init_process_group("fake", store=FakeStore(), rank=rank,
                                         world_size=world)
    try:
        assert train_mod.train(TrainConfig(batch_size=batch, device="cpu",
                                           checkpoint_dir=str(tmp_path))) is None
    finally:
        torch.distributed.destroy_process_group()


def test_multihost_needs_the_launcher_environment(tiny_voc, tmp_path, monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        train_mod.train(_cfg(tiny_voc, tmp_path / "weight", multihost=True))


@pytest.fixture(scope="module")
def weights(tiny_voc):
    path = tiny_voc / "weights.npz"
    save_params_npz(str(path), state_dict_to_flax(init_random_(ACR(backbone_name=BACKBONE),
                                                               seed=4)))
    return path


def _infer_cfg(root, weights, out, **kw):
    return InferConfig(model=ModelConfig(backbone=BACKBONE, compute_dtype="float32"),
                       weights=str(weights), crop_size=CROP, image_dir=str(root / "img"),
                       infer_list=str(root / "train.txt"),
                       cls_labels_path=str(root / "cls_labels.npy"), out_cam=str(out),
                       device="cpu", **kw)


@pytest.mark.parametrize("pamr", [0, 2])
def test_infer_dp_writes_the_files_of_one_process(tiny_voc, weights, tmp_path, pamr):
    one = _infer_cfg(tiny_voc, weights, tmp_path / "one", pamr_iters=pamr)
    two = dataclasses.replace(one, out_cam=str(tmp_path / "two"), dp=2)
    threads = torch.get_num_threads()
    # One thread per worker (the workers share this process's threads
    # out): spinning thread pools of processes that outnumber the cores
    # slowed these runs tenfold beside the other test files. The one
    # process runs on a worker's threads: CPU kernels sum in an order
    # that depends on the thread count.
    torch.set_num_threads(2)
    try:
        torch.set_num_threads(infer_cam.cpu_threads_per_worker(2))
        assert infer_cam.run(one) == {"device": 0, "host": 0}
        torch.set_num_threads(2)
        assert infer_cam.run(two) == {"device": 0, "host": 0}
    finally:
        torch.set_num_threads(threads)
    names = sorted(os.listdir(tmp_path / "one"))
    assert len(names) == 8 and sorted(os.listdir(tmp_path / "two")) == names
    for name in names:
        a = np.load(tmp_path / "one" / name, allow_pickle=True).item()
        b = np.load(tmp_path / "two" / name, allow_pickle=True).item()
        assert sorted(a) == sorted(b)
        for c in a:
            np.testing.assert_array_equal(b[c], a[c])


def test_infer_dp_beyond_the_visible_gpus_fails(tiny_voc, weights, tmp_path):
    cfg = _infer_cfg(tiny_voc, weights, tmp_path / "out",
                     dp=max(2, torch.cuda.device_count() + 1))
    with pytest.raises(ValueError, match="requested but only .* devices visible"):
        infer_cam.run(dataclasses.replace(cfg, device="cuda"))
