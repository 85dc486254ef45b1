"""The port's training slice against the JAX package's, on the CPU.

* data: the same seed gives the same training and validation batches as
  the JAX iterators, exactly;
* the trunk's ``mirror_second_half`` (stacked and interleaved) against the
  JAX trunk's;
* ``state_dict_to_flax`` against the JAX model's parameter paths;
* ``train()`` end to end on a synthetic VOC fixture, its npz read by the
  JAX package's ``load_params_npz`` and giving the same logits.

Models run in float32 (vitb at crop 32, as the JAX package's loop tests
run it); Pallas runs in interpret mode for the pair entry. One train step
of each loss branch is in ``tests/test_torch_train_step.py``.
"""

import numpy as np
import pytest
from PIL import Image

import jax.numpy as jnp
import torch

from acr_wsss_tpu.data import transforms as jax_transforms
from acr_wsss_tpu.data import voc as jax_voc
from acr_wsss_tpu.utils.checkpoint import load_params_npz as jax_load_params_npz
from acr_wsss_tpu_torch import train as port_train
from acr_wsss_tpu_torch.configs import ModelConfig, TrainConfig
from acr_wsss_tpu_torch.data import transforms as port_transforms
from acr_wsss_tpu_torch.data import voc as port_voc
from acr_wsss_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from tests.torch_port_helpers import build_acr_pair, random_flax_params


@pytest.fixture(scope="module")
def voc_fixture(tmp_path_factory):
    """8 seeded JPEGs of mixed sizes, labels, and train/val lists."""
    root = tmp_path_factory.mktemp("torch_voc")
    img_dir = root / "img"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    names, labels = [], {}
    for i in range(8):
        name = f"t{i}"
        h, w = ((70, 90), (90, 60), (48, 64))[i % 3]
        Image.fromarray(rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)).save(
            img_dir / f"{name}.jpg")
        lab = np.zeros(20, np.float32)
        lab[[i % 20, (3 * i + 5) % 20]] = 1.0
        names.append(name)
        labels[name] = lab
    np.save(root / "cls_labels.npy", labels)
    (root / "train.txt").write_text("\n".join(names) + "\n")
    (root / "val.txt").write_text("\n".join(names[:3]) + "\n")
    return root, names, labels


@pytest.fixture
def same_resize(monkeypatch):
    """Both pipelines on the port's resize. The JAX package resizes with
    cv2 (INTER_LINEAR, no antialiasing), the semantics the port writes out
    in numpy; where cv2 is missing, as here, it falls back to PIL, whose
    downscaling antialiases: another function. The test holds the rest of
    the pipeline (seed streams, flip, normalize, crop) exactly."""
    monkeypatch.setattr(jax_transforms, "resize_bilinear_np", port_transforms.resize_hwc)


def test_train_and_eval_batches_match_jax(voc_fixture, same_resize):
    root, names, labels = voc_fixture
    crop = 32
    jit = jax_voc.TrainIterator(jax_voc.VOCClassificationSource(str(root / "img"), labels, crop),
                                names, 3, seed=5, num_workers=2)
    pit = port_voc.TrainIterator(port_voc.VOCClassificationSource(str(root / "img"), labels, crop),
                                 names, 3, seed=5, num_workers=2)
    for _ in range(6):                      # 18 examples: crosses two epochs
        jb, pb = next(jit), next(pit)
        assert jb["name"] == pb["name"]
        np.testing.assert_array_equal(pb["label"], jb["label"])
        np.testing.assert_array_equal(pb["image"], jb["image"])
    pit.close()

    je = jax_voc.EvalIterator(jax_voc.VOCClassificationSource(str(root / "img"), labels, crop),
                              names[:5], batch_size=2)
    pe = port_voc.EvalIterator(port_voc.VOCClassificationSource(str(root / "img"), labels, crop),
                               names[:5], batch_size=2)
    for jb, pb in zip(je, pe, strict=True):
        assert jb["name"] == pb["name"]
        np.testing.assert_array_equal(pb["image"], jb["image"])
        np.testing.assert_array_equal(pb["label"], jb["label"])
    assert port_voc.read_file(str(root / "train.txt")) == jax_voc.read_file(
        str(root / "train.txt"))


def test_augmentation_parameters_and_crops_match_jax(same_resize):
    rng_img = np.random.default_rng(1)
    img = rng_img.integers(0, 255, size=(50, 70, 3), dtype=np.uint8)
    for seed in range(6):
        jp = jax_transforms.train_aug_params(img.shape[:2], 64, np.random.default_rng(seed))
        pp = port_transforms.train_aug_params(img.shape[:2], 64, np.random.default_rng(seed))
        assert tuple(jp) == tuple(pp)
        jc, jm = jax_transforms.train_transform(img, 64, np.random.default_rng(seed))
        pc, pm = port_transforms.train_transform(img, 64, np.random.default_rng(seed))
        np.testing.assert_array_equal(pc, jc)
        np.testing.assert_array_equal(pm, jm)
        jr = jax_transforms.random_crop(img.astype(np.float32), 40, np.random.default_rng(seed))
        pr = port_transforms.random_crop(img.astype(np.float32), 40, np.random.default_rng(seed))
        np.testing.assert_array_equal(pr[0], jr[0])
        np.testing.assert_array_equal(pr[1], jr[1])
        jl = jax_transforms.random_resize_long(img, 30, 90, np.random.default_rng(seed))
        pl = port_transforms.random_resize_long(img, 30, 90, np.random.default_rng(seed))
        np.testing.assert_array_equal(pl, jl)


@pytest.mark.parametrize("mode", [True, "interleaved"])
def test_mirror_second_half_matches_jax(mode):
    """Probs and logits of the un-mirrored trunk, both views on the batch."""
    crop = 32
    jax_model, params, port = build_acr_pair(crop, seed=3, backbone="vitb")
    x = np.random.default_rng(4).normal(size=(4, crop, crop, 3)).astype(np.float32)
    ref = jax_model.apply(params, jnp.asarray(x), method=jax_model.forward_cls,
                          mirror_second_half=mode)
    with torch.no_grad():
        got = port.forward_cls(torch.from_numpy(x), mirror_second_half=mode)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(ref["logits"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(ref["probs"]), atol=1e-5)
    assert got["n_tokens"] == ref["n_tokens"] == (crop // 16) ** 2 + 1
    for g, r in zip(got["probs_layers"], ref["probs_layers"], strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def test_pair_l1_export_matches_jax():
    """Per-layer consistency sums of the interleaved trunk (JAX: Pallas
    entry in interpret mode) and the logits."""
    from jax.experimental.pallas import tpu as pltpu

    crop = 32
    jax_model, params, port = build_acr_pair(crop, seed=5, backbone="vitb",
                                             jax_impl="pallas")
    x = np.random.default_rng(6).normal(size=(4, crop, crop, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_model.apply(params, jnp.asarray(x), method=jax_model.forward_cls,
                              export="pair_l1", mirror_second_half="interleaved")
    with torch.no_grad():
        got = port.forward_cls(torch.from_numpy(x), export="pair_l1",
                               mirror_second_half="interleaved")
    assert got["probs"] is None and len(got["consistency_sums"]) == 12
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(ref["logits"]),
                               rtol=1e-4, atol=1e-4)
    for (gc, ga), (rc, ra) in zip(got["consistency_sums"], ref["consistency_sums"],
                                  strict=True):
        np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=1e-4)
        np.testing.assert_allclose(ga.numpy(), np.asarray(ra), rtol=1e-4)


def test_forward_mirror_splits_the_doubled_batch():
    crop = 32
    _, _, port = build_acr_pair(crop, seed=7, backbone="vitb")
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(4, crop, crop, 3)).astype(np.float32))
    with torch.no_grad():
        first, second = port.forward_mirror(x[:2], x[2:])
        both = port.forward_cls(x)
    assert torch.equal(first["logits"], both["logits"][:2])
    assert torch.equal(second["probs"], both["probs"][2:])
    assert first["grid"] == (2, 2) and "taps" not in first


def test_state_dict_to_flax_inverts_the_converter():
    """Same flax paths and shapes as the JAX model's params, and the
    converter maps them back to the same state_dict."""
    from acr_wsss_tpu.models.acr import ACR as JaxACR
    from acr_wsss_tpu_torch.models.acr import ACR, init_random_

    for backbone in ("vitb_hybrid", "vitb"):
        jax_model = JaxACR(backbone_name=backbone, dtype=jnp.float32)
        ref = random_flax_params(jax_model, jnp.zeros((1, 32, 32, 3)), seed=0)
        port = init_random_(ACR(backbone_name=backbone, dtype=torch.float32), seed=1)
        flat = state_dict_to_flax(port)
        assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in ref.items()}
        back = flax_to_state_dict(flat, port.state_dict())
        assert all(torch.equal(back[k], v) for k, v in port.state_dict().items())


def test_train_end_to_end_npz_loads_in_jax(voc_fixture, tmp_path, capsys):
    root, names, labels = voc_fixture
    cfg = TrainConfig(
        model=ModelConfig(backbone="vitb", compute_dtype="float32"), crop_size=32,
        batch_size=4, max_epochs=1, lr=0.001, alpha=1.0, log_every=1, val_every=2,
        checkpoint_dir=str(tmp_path / "weight"), session_name="tiny",
        image_dir=str(root / "img"), train_list=str(root / "train.txt"),
        val_list=str(root / "val.txt"), cls_labels_path=str(root / "cls_labels.npy"),
        num_workers=2, device="cpu")
    state = port_train.train(cfg)
    out = capsys.readouterr().out
    # 8 images / batch 4 -> 2 updates -> steps 0..2; validation at step 2.
    assert state.steps == 3 and state.optimizer.updates == 3
    assert "val loss" in out and "model saved!" in out
    assert all(np.isfinite(v) for parts in state.history for v in parts.values())

    npz = tmp_path / "weight" / "tiny_last.npz"
    params = jax_load_params_npz(str(npz))
    from acr_wsss_tpu.models.acr import ACR as JaxACR

    jax_model = JaxACR(backbone_name="vitb", dtype=jnp.float32)
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    ref = jax_model.apply(params, jnp.asarray(x), method=jax_model.forward_cls)
    with torch.no_grad():
        got = state.model.forward_cls(torch.from_numpy(x))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(ref["logits"]),
                               rtol=1e-4, atol=1e-4)


def test_parse_args_defaults_to_the_recipe_on_cuda():
    cfg = port_train.parse_args(["--LISTpath", "l.txt"])
    assert cfg.device == "cuda" and cfg.train_list == "l.txt"
    assert (cfg.batch_size, cfg.crop_size, cfg.lr, cfg.weight_decay, cfg.alpha) == (
        4, 384, 0.05, 5e-4, 125.0)
    assert cfg.model.attn_impl == "kernel" and cfg.model.fuse_consistency
    assert port_train.uses_fused_consistency(cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_train.create_train_state(cfg, 10)


def test_validate_pads_the_last_batch(voc_fixture):
    """Validation loss over 3 images at batch 2 equals the mean of the
    per-example losses (the padded row carries weight 0)."""
    root, names, labels = voc_fixture
    cfg = TrainConfig(model=ModelConfig(backbone="vitb", compute_dtype="float32"),
                      crop_size=32, batch_size=2, image_dir=str(root / "img"), device="cpu")
    model, _ = port_train.create_train_state(cfg, 1)
    eval_step = port_train.make_eval_step(model)
    got = port_train.validate(cfg, model, eval_step, names[:3], labels)
    src = port_voc.VOCClassificationSource(str(root / "img"), labels, 32)
    per = []
    for n in names[:3]:
        img, lab = src.load_val(n)
        s, c = eval_step({"image": img[None], "label": lab[None], "weight": np.ones(1)})
        per.append(float(s) / float(c))
    np.testing.assert_allclose(got, np.mean(per), rtol=1e-5)
