"""The port's segmentation trainer (``train_seg.py``) against the JAX
package's.

* ``make_seg_train_step``: three SGD steps (lr 1e-4, poly decay over 100
  updates, momentum 0.9, weight decay 5e-4) of the full-width DPT model at
  crop 32 on three seeded batches, from the same seeded numpy weights,
  float32 and plain attention on both sides. At lr 1e-4 three updates are
  small against the parameters' bounds, so step 0's update p1 - p0 is held
  on its own, per tensor in relative L2, against JAX's (``UPDATE_REL``).
  vitb (lr as ``tests/test_train_seg.py``): loss parts within 1e-5
  relative, every parameter within rtol 2e-3 / atol 2e-4 (the vitb bounds
  of ``tests/test_torch_train_step.py``). Step-0 update: JAX against JAX
  reads at most 3.7e-4 (weights moved by one float32 ulp, two draws:
  2.8e-4, 3.7e-4; the batch's two images swapped: 9.1e-5; op by op under
  ``jax.disable_jit``: 2.6e-4) and the port 8.4e-4, in a LayerNorm bias
  (``blocks_7.norm2``) whose gradient sums every token; bound 2e-3.
  vitb_hybrid: from these weights a run at the ACR tests' lr 0.01 diverges
  in JAX itself (loss 7.45, 33.3, 19141), and so does it at 1e-3; at 1e-4
  the weight-standardized stem still amplifies rounding: JAX against JAX
  on weights perturbed by one float32 ulp differs by 3.2e-3 and 2.95e-2 in
  the losses of steps 1 and 2, by up to 47% in a tensor's update after
  three steps, and stays within rtol 5e-2 / atol 5e-3 in every parameter
  (measured). So step 0's loss parts within 1e-5, those of steps 1-2
  within 6e-2 (twice that spread; the port measured 1.9e-3 and 2.7e-2),
  every parameter within 5e-2 / 5e-3, the hybrid bound of
  ``tests/test_torch_train_step.py``. Step-0 update: JAX against JAX reads
  up to 3.83e-2 in the stem's GroupNorms (one-ulp draws 3.78e-2 and
  3.83e-2, op by op 1.38e-2, batch swapped 7.4e-5), the port 3.78e-2;
  bound 8e-2. An unchanged model reads 1.0 there, and the port with its
  ``stem_features`` detached from the graph (the decoder's gradient kept
  out of the stem) 0.128 (``stages_1_blocks_3.norm3``): both fail.
  With ``contrast_weight`` the port's step-0 parts are held to JAX's loss
  parts of its forward at the same weights, composed as JAX's step
  composes them (a step's parts are those of the weights before its
  update); JAX's gradient is NaN there (an absent class's zero centroid,
  see ``tests/test_torch_seg_losses.py``), the port's update finite.
* ``load_seg_batch`` against JAX's on the same names and generator seed.
* The CLI end to end on the 48x56 fixture of ``tests/test_train_seg.py``
  with ``--device cpu``: the ``_last.npz`` and a periodic snapshot
  written, the mIoU in [0, 1], and the JAX model applied to the npz gives
  the port's logits.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from acr_wsss_tpu import losses as jax_losses
from acr_wsss_tpu import train_seg as jax_train_seg
from acr_wsss_tpu.models.dpt import DPTSegmentationModel as JaxDPT
from acr_wsss_tpu.train import TrainState
from acr_wsss_tpu.utils.schedule import make_optimizer as jax_make_optimizer
from acr_wsss_tpu_torch import train_seg
from acr_wsss_tpu_torch.models.convert import flax_to_state_dict
from acr_wsss_tpu_torch.models.dpt import DPTSegmentationModel
from acr_wsss_tpu_torch.utils.checkpoint import load_params_npz
from acr_wsss_tpu_torch.utils.schedule import make_optimizer
from tests.torch_port_helpers import (dpt_flax_params, flatten_params, jax_dpt_apply,
                                      unflatten_params)

CROP, BATCH, STEPS, MAX_STEP = 32, 2, 3, 100
LR = 1e-4
LOSS_RTOL = {"vitb": (1e-5, 1e-5, 1e-5), "vitb_hybrid": (1e-5, 6e-2, 6e-2)}
PARAM_TOL = {"vitb": dict(rtol=2e-3, atol=2e-4), "vitb_hybrid": dict(rtol=5e-2, atol=5e-3)}
UPDATE_REL = {"vitb": 2e-3, "vitb_hybrid": 8e-2}


def _batches():
    rng = np.random.default_rng(2)
    return [{"image": rng.normal(size=(BATCH, CROP, CROP, 3)).astype(np.float32),
             "seg_label": np.where(rng.uniform(size=(BATCH, CROP, CROP)) < 0.05, 255,
                                   rng.integers(0, 3, size=(BATCH, CROP, CROP))).astype(np.int32)}
            for _ in range(STEPS)]


def _weights(backbone):
    return dpt_flax_params(backbone, 1, CROP)


def _jax_steps(backbone, batches):
    """(loss parts of each step, flat params after step 0, after the last)."""
    model = JaxDPT(backbone_name=backbone)
    state = TrainState.create(apply_fn=model.apply,
                              params=unflatten_params(_weights(backbone)),
                              tx=jax_make_optimizer(LR, MAX_STEP))
    step = jax.jit(jax_train_seg.make_seg_train_step(model))
    history, after = [], []
    for batch in batches:
        state, parts = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        history.append({k: float(v) for k, v in parts.items()})
        if not after:
            after.append(flatten_params(state.params))
    return history, after[0], flatten_params(state.params)


def _port_steps(backbone, contrast_weight, batches):
    """(loss parts of each step, state dict after step 0, model)."""
    model = DPTSegmentationModel(backbone_name=backbone)
    model.load_state_dict(flax_to_state_dict(_weights(backbone), model.state_dict()))
    step = train_seg.make_seg_train_step(
        model, make_optimizer(model.parameters(), LR, MAX_STEP), contrast_weight)
    history, after = [], []
    for batch in batches:
        history.append({k: float(v) for k, v in step(batch).items()})
        if not after:
            after.append({k: v.clone() for k, v in model.state_dict().items()})
    return history, after[0], model


@pytest.mark.parametrize("backbone", ["vitb", "vitb_hybrid"])
def test_seg_train_steps_match_jax(backbone):
    batches = _batches()
    ref_hist, ref_first, ref_params = _jax_steps(backbone, batches)
    hist, first, model = _port_steps(backbone, 0.0, batches)
    for got, ref, rtol in zip(hist, ref_hist, LOSS_RTOL[backbone]):
        assert sorted(got) == sorted(ref) == ["ce_loss", "loss"]
        for k in ref:
            assert abs(got[k] - ref[k]) <= rtol * abs(ref[k]), (k, got, ref)
    template = model.state_dict()
    p0 = flax_to_state_dict(_weights(backbone), template)
    ref_p1 = flax_to_state_dict(ref_first, template)
    rel = {k: float((first[k].double() - ref_p1[k].double()).norm()
                    / (ref_p1[k].double() - p0[k].double()).norm().clamp_min(1e-30))
           for k in ref_p1}
    worst = max(rel, key=rel.get)
    assert rel[worst] <= UPDATE_REL[backbone], (worst, rel[worst])
    ref_sd = flax_to_state_dict(ref_params, template)
    for k, v in template.items():
        np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), err_msg=k,
                                   **PARAM_TOL[backbone])


def test_seg_train_step_with_contrast():
    batch = _batches()[0]
    out = jax_dpt_apply("vitb")(unflatten_params(_weights("vitb")),
                                jnp.asarray(batch["image"]))

    @jax.jit
    def parts(logits, label):
        flat = logits.reshape(logits.shape[0], logits.shape[1], -1)
        ce = jax_losses.compute_joint_ce(logits, label)
        contrast = jax_losses.prototype_contrast_loss(flat, flat, logits.shape[1])
        return {"ce_loss": ce, "contrast": contrast, "loss": ce + 0.1 * contrast}

    ref = {k: float(v) for k, v in parts(out["seg_logits"],
                                         jnp.asarray(batch["seg_label"])).items()}
    hist, _, model = _port_steps("vitb", 0.1, [batch])
    assert sorted(hist[0]) == sorted(ref)
    for k, r in ref.items():
        assert abs(hist[0][k] - r) <= LOSS_RTOL["vitb"][0] * abs(r), (k, hist, ref)
    assert all(torch.isfinite(p).all() for p in model.parameters())


@pytest.fixture(scope="module")
def tiny_seg(tmp_path_factory):
    """The fixture of tests/test_train_seg.py: four 48x56 JPEGs, pseudo
    masks of classes 0-2 with one 255 pixel, ground truth PNGs."""
    root = tmp_path_factory.mktemp("tinyseg")
    for d in ("img", "pseudo", "gt"):
        (root / d).mkdir()
    rng = np.random.default_rng(13)
    names = []
    for i in range(4):
        name = f"s{i}"
        names.append(name)
        Image.fromarray(rng.integers(0, 255, size=(48, 56, 3), dtype=np.uint8)).save(
            root / "img" / f"{name}.jpg")
        mask = rng.integers(0, 3, size=(48, 56)).astype(np.uint8)
        mask[0, 0] = 255
        Image.fromarray(mask).save(root / "pseudo" / f"{name}.png")
        Image.fromarray(rng.integers(0, 3, size=(48, 56), dtype=np.uint8)).save(
            root / "gt" / f"{name}.png")
    (root / "list.txt").write_text("\n".join(names) + "\n")
    return root, names


def test_load_seg_batch_matches_jax(tiny_seg):
    root, names = tiny_seg

    class Source:
        image_dir = str(root / "img")

    got = train_seg.load_seg_batch(Source.image_dir, str(root / "pseudo"), names, CROP,
                                   np.random.default_rng(0))
    ref = jax_train_seg.load_seg_batch(Source, str(root / "pseudo"), names, CROP,
                                       np.random.default_rng(0))
    assert got["image"].dtype == np.float32 and got["seg_label"].dtype == np.int32
    np.testing.assert_array_equal(got["seg_label"], ref["seg_label"])
    np.testing.assert_allclose(got["image"], ref["image"], rtol=0, atol=1e-5)


def test_train_seg_cli_end_to_end(tiny_seg, tmp_path, capsys):
    root, _ = tiny_seg
    weight_dir = tmp_path / "weight"
    miou = train_seg.main([
        "--IMpath", str(root / "img"), "--pseudo_dir", str(root / "pseudo"),
        "--train_list", str(root / "list.txt"), "--backbone", "vitb",
        "--batch_size", "2", "--max_epoches", "1", "--lr", "0.001",
        "--crop_size", str(CROP), "--session_name", "seg_test",
        "--weight_dir", str(weight_dir), "--save_every", "2",
        "--val_list", str(root / "list.txt"), "--gt_dir", str(root / "gt"),
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Iter:    0/2" in out and "seg val mIoU" in out
    assert miou is not None and 0.0 <= miou <= 1.0
    assert os.path.exists(weight_dir / "seg_test_snapshot.npz")

    flat = load_params_npz(str(weight_dir / "seg_test_last.npz"))
    x = np.random.default_rng(4).normal(size=(BATCH, CROP, CROP, 3)).astype(np.float32)
    ref = jax_dpt_apply("vitb")(unflatten_params(flat), jnp.asarray(x))
    model = DPTSegmentationModel(backbone_name="vitb")
    model.load_state_dict(flax_to_state_dict(flat, model.state_dict()))
    with torch.no_grad():
        got = model(torch.from_numpy(x), export="none")["seg_logits"].numpy()
    ref = np.asarray(ref["seg_logits"])
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
