"""The port's on-device augmentation (``acr_wsss_tpu_torch/data/device_aug.py``)
against the JAX package's (``acr_wsss_tpu/data/device_aug.py``) and the
port's host transform, on the CPU.

* ``pack_example`` gives JAX's padded raster and descriptor, bit for bit;
* ``device_augment`` is within 1e-5 of JAX's ``device_augment`` on the
  same packed batch (both float32, the same index arithmetic; only the
  order of a few float operations may differ), and within 3e-4 of the
  host transform on the same rng stream (the constant of
  ``tests/test_device_aug.py``: the host resizes first and crops second,
  the gather composes both), with the pad region exactly 0;
* an image larger than ``aug_pad`` is refused;
* ``TrainIterator(device_aug=True)`` yields JAX's packed batches, and one
  train step on them agrees with one on the host batches within the step
  gates of ``chip_smoke.py`` (loss parts 2e-2, updates 5e-2 in L2).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from acr_wsss_tpu.data import device_aug as jax_device_aug
from acr_wsss_tpu.data import transforms as jax_transforms
from acr_wsss_tpu.data import voc as jax_voc
from acr_wsss_tpu_torch import train as train_mod
from acr_wsss_tpu_torch.configs import ModelConfig, TrainConfig
from acr_wsss_tpu_torch.data import device_aug, transforms
from acr_wsss_tpu_torch.data import voc as port_voc

SHAPES = [(130, 100), (100, 130), (60, 50), (500, 375)]
CROP, PAD = 96, 512
LOSS_RTOL, UPDATE_REL = 2e-2, 5e-2


def _example(shape, seed):
    img = np.random.default_rng(seed).integers(0, 255, size=shape + (3,), dtype=np.uint8)
    params = transforms.train_aug_params(img.shape[:2], CROP, np.random.default_rng((11, seed)))
    return img, params


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pack_example_matches_jax(shape, seed):
    img, params = _example(shape, seed)
    jax_params = jax_transforms.train_aug_params(img.shape[:2], CROP,
                                                 np.random.default_rng((11, seed)))
    assert tuple(params) == tuple(jax_params)
    padded, vec = device_aug.pack_example(img, params, PAD)
    ref_padded, ref_vec = jax_device_aug.pack_example(img, jax_params, PAD)
    assert padded.dtype == ref_padded.dtype and vec.dtype == ref_vec.dtype
    np.testing.assert_array_equal(padded, ref_padded)
    np.testing.assert_array_equal(vec, ref_vec)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_augment_matches_jax_and_the_host_chain(shape, seed):
    img, params = _example(shape, seed)
    padded, vec = device_aug.pack_example(img, params, PAD)
    got = device_aug.device_augment(torch.from_numpy(padded[None]),
                                    torch.from_numpy(vec[None]), CROP)[0].numpy()
    ref = np.asarray(jax_device_aug.device_augment(padded[None], vec[None], CROP)[0])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    host, mask = transforms.train_transform(img, CROP, np.random.default_rng((11, seed)))
    np.testing.assert_allclose(got, host, rtol=0, atol=3e-4)
    assert np.all(got[~mask] == 0.0)


def test_batched_augment_equals_per_example():
    examples = [device_aug.pack_example(*_example(shape, i), PAD)
                for i, shape in enumerate(SHAPES)]
    images = torch.from_numpy(np.stack([e[0] for e in examples]))
    vecs = torch.from_numpy(np.stack([e[1] for e in examples]))
    batched = device_aug.device_augment(images, vecs, CROP)
    for i in range(len(SHAPES)):
        assert torch.equal(batched[i], device_aug.device_augment(images[i:i + 1],
                                                                 vecs[i:i + 1], CROP)[0])


def test_pack_example_rejects_oversize():
    img = np.zeros((600, 200, 3), np.uint8)
    params = transforms.train_aug_params((600, 200), CROP, np.random.default_rng(0))
    with pytest.raises(ValueError, match="aug_pad"):
        device_aug.pack_example(img, params, pad_to=512)


@pytest.fixture(scope="module")
def voc_fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_device_aug")
    rng = np.random.default_rng(0)
    names, labels = [], {}
    for i in range(6):
        name = f"d{i}"
        h, w = ((70, 90), (90, 60), (48, 64))[i % 3]
        Image.fromarray(rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)).save(
            root / f"{name}.jpg")
        lab = np.zeros(20, np.float32)
        lab[[i % 20, (3 * i + 5) % 20]] = 1.0
        names.append(name)
        labels[name] = lab
    return root, names, labels


def test_packed_batches_match_jax_and_train_like_host_batches(voc_fixture):
    root, names, labels = voc_fixture
    crop, pad = 32, 128
    it = {}
    for mode in ("jax", "packed", "host"):
        voc = jax_voc if mode == "jax" else port_voc
        it[mode] = voc.TrainIterator(voc.VOCClassificationSource(str(root), labels, crop),
                                     names, 2, seed=3, num_workers=2,
                                     device_aug=mode != "host", aug_pad=pad)
    batches = {mode: next(i) for mode, i in it.items()}
    for mode in ("packed", "host"):
        it[mode].close()
    packed, ref = batches["packed"], batches["jax"]
    assert packed["name"] == ref["name"] == batches["host"]["name"]
    for k in ("image_u8", "aug", "label"):
        assert packed[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(packed[k], ref[k])
    crops = device_aug.materialize_batch(packed, crop, torch.device("cpu"))["image"]
    np.testing.assert_allclose(crops.numpy(), batches["host"]["image"], rtol=0, atol=3e-4)

    cfg = TrainConfig(model=ModelConfig(backbone="vitb", compute_dtype="float32"),
                      crop_size=crop, batch_size=2, lr=0.01, alpha=1.0, device="cpu")
    runs = {}
    for mode in ("packed", "host"):
        model, opt = train_mod.create_train_state(cfg, max_step=4)
        before = {k: v.detach().clone() for k, v in model.named_parameters()}
        parts = train_mod.make_train_step(model, opt, cfg, (2, 2))(batches[mode])
        runs[mode] = ({k: float(v) for k, v in parts.items()}, before,
                      dict(model.named_parameters()))
    (parts, p0, p1), (ref_parts, _, ref_p1) = runs["packed"], runs["host"]
    for k in ref_parts:
        assert abs(parts[k] - ref_parts[k]) <= LOSS_RTOL * abs(ref_parts[k]), k
    for k in ref_p1:
        ref_u = ref_p1[k].detach() - p0[k]
        err = (p1[k].detach() - p0[k] - ref_u).norm() / ref_u.norm().clamp_min(1e-30)
        assert err <= UPDATE_REL, k
