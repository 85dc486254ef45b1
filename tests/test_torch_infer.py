"""The port's GETAM / CAM inference slice against the JAX package's.

Full vitb_hybrid width at crop 64 (N = 17 tokens), float32, shared numpy
weights. GETAM runs with the recipe's truncated taps (offsets from layer
10, ``start_layer`` 10); ``process_image`` with flip TTA and 4 class
slots on a synthetic non-square JPEG; ``evaluate`` on the same CAM dicts.

Tolerances: both sides run in float32, so GETAM CAMs are held to 1e-4
relative to their largest value (gradients through two blocks and the
heads, summed in another order); the min-max normalized CAM dicts, which
lie in [0, 1], to 1e-4 absolute; the mIoU curve must be identical, since
the decode and the counting are the same integer arithmetic.
"""

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp
import torch

from acr_wsss_tpu import evaluate as jax_evaluate
from acr_wsss_tpu.getam import getam_cams as jax_getam_cams
from acr_wsss_tpu.getam import make_forward_for_getam as jax_forward_for_getam
from acr_wsss_tpu.infer_cam import build_infer_fn as jax_build_infer_fn
from acr_wsss_tpu.infer_cam import process_image as jax_process_image
from acr_wsss_tpu.models.acr import ACR as JaxACR
from acr_wsss_tpu_torch import evaluate as port_evaluate
from acr_wsss_tpu_torch.getam import GETAM_FUNCS, getam_cams, make_forward_for_getam, tap_config
from acr_wsss_tpu_torch.infer_cam import (build_infer_fn, process_image,
                                          process_images_batched)
from tests.torch_port_helpers import build_acr_pair

CROP = 64
N = (CROP // 16) ** 2 + 1
START_LAYER = 10
CLASS_IDS = [3, 5, 7]


@pytest.fixture(scope="module")
def pair():
    return build_acr_pair(CROP, seed=1, jax_impl="xla", torch_impl="kernel")


@pytest.fixture(scope="module")
def views():
    return np.random.default_rng(9).normal(size=(2, CROP, CROP, 3)).astype(np.float32)


def _export(func):
    return "full" if func in ("cam_grad", "cam_grad_s") else "mean"


@pytest.fixture(scope="module")
def jax_getam(pair, views):
    """All eight (func, use_aff) results of the JAX getam_cams, one jit."""
    jax_model, params, _ = pair

    def run(p, x):
        out = {}
        for func in GETAM_FUNCS:
            for aff in (False, True):
                fwd = jax_forward_for_getam(jax_model, p, x, export=_export(func))
                out[f"{func}/{aff}"] = jax_getam_cams(
                    fwd, (12 - START_LAYER, 2, 12, N, N), 20, START_LAYER, func,
                    1, aff, jnp.asarray(CLASS_IDS), START_LAYER)
        return out

    return jax.device_get(jax.jit(run)(params, jnp.asarray(views)))


@pytest.mark.parametrize("use_aff", [False, True])
@pytest.mark.parametrize("func", GETAM_FUNCS)
def test_getam_cams_match_jax(pair, views, jax_getam, func, use_aff):
    _, _, port = pair
    off_start, export = tap_config(port, START_LAYER, func)
    assert (off_start, export) == (START_LAYER, _export(func))
    fwd = make_forward_for_getam(port, torch.from_numpy(views), export=export)
    cams, logits, patch_aff = getam_cams(
        fwd, (12 - off_start, 2, 12, N, N), 20, START_LAYER, func, 1, use_aff,
        CLASS_IDS, off_start, device="cpu")
    cams_j, logits_j, aff_j = jax_getam[f"{func}/{use_aff}"]
    assert cams.shape == (len(CLASS_IDS), 2, N - 1)
    np.testing.assert_allclose(logits.numpy(), logits_j, rtol=0,
                               atol=1e-4 * np.abs(logits_j).max())
    np.testing.assert_allclose(patch_aff.numpy(), aff_j, rtol=0, atol=1e-5)
    assert np.abs(cams_j).max() > 0
    np.testing.assert_allclose(cams.numpy(), cams_j, rtol=0,
                               atol=1e-4 * np.abs(cams_j).max())


def test_getam_cams_refuse_offsets_past_start_layer(pair, views):
    _, _, port = pair
    fwd = make_forward_for_getam(port, torch.from_numpy(views), export="mean")
    with pytest.raises(ValueError, match="offsets_start"):
        getam_cams(fwd, (1, 2, 12, N, N), 20, START_LAYER, "grad",
                   offsets_start=11, device="cpu")


@pytest.fixture(scope="module")
def jpeg(tmp_path_factory):
    """A synthetic non-square JPEG with 3 labels."""
    path = tmp_path_factory.mktemp("img") / "2007_000001.jpg"
    rng = np.random.default_rng(4)
    small = rng.integers(0, 256, (9, 12, 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(small).resize((75, 53), Image.BILINEAR))
    Image.fromarray(img).save(path, quality=90)
    label = np.zeros(20, np.float32)
    label[[2, 11, 14]] = 1.0
    return str(path), label


def test_process_image_matches_jax(pair, jpeg):
    """Flip TTA, 4 class slots, the recipe's GETAM; JAX runs the pipeline's
    default ``attn_impl="pallas"`` (interpret mode)."""
    from jax.experimental.pallas import tpu as pltpu

    _, params, port = pair
    path, label = jpeg
    jax_model = JaxACR(dtype=jnp.float32, attn_impl="pallas")
    jax_fn = jax_build_infer_fn(jax_model, params, CROP, START_LAYER, "grad", True,
                                20, class_slots=4)
    with pltpu.force_tpu_interpret_mode():
        cam_j, patch_j, rgb_j = jax_process_image(jax_fn, path, label, CROP)

    fn = build_infer_fn(port, CROP, START_LAYER, "grad", True, 20, class_slots=4)
    cam_t, patch_t, rgb_t = process_image(fn, path, label, CROP)

    np.testing.assert_array_equal(rgb_t, rgb_j)
    assert sorted(cam_t) == sorted(cam_j) == [2, 11, 14]
    for c in cam_j:
        assert cam_t[c].shape == (53, 75) and cam_t[c].dtype == np.float32
        np.testing.assert_allclose(cam_t[c], cam_j[c], rtol=0, atol=1e-4)
        np.testing.assert_allclose(patch_t[c], patch_j[c], rtol=0, atol=1e-4)


def test_process_images_batched_equals_single_images(pair, jpeg, tmp_path):
    """Two images in one pass give each image's own result. Tolerance 1e-4:
    the batch of 4 views and the union of the class slots change the
    float32 summation order of the CPU matrix products."""
    _, _, port = pair
    path, label = jpeg
    other = str(tmp_path / "b.jpg")
    Image.fromarray(np.random.default_rng(5).integers(0, 256, (40, 64, 3),
                                                      dtype=np.uint8)).save(other)
    label2 = np.zeros(20, np.float32)
    label2[[0]] = 1.0
    fn = build_infer_fn(port, CROP, START_LAYER, "grad", True, 20, class_slots=4)
    batched = process_images_batched(fn, [path, other], [label, label2], CROP)
    for (cam_b, patch_b, _), p, lab in zip(batched, [path, other], [label, label2]):
        cam_s, patch_s, _ = process_image(fn, p, lab, CROP)
        assert sorted(cam_b) == sorted(cam_s)
        for c in cam_s:
            np.testing.assert_allclose(cam_b[c], cam_s[c], rtol=0, atol=1e-4)
            np.testing.assert_allclose(patch_b[c], patch_s[c], rtol=0, atol=1e-4)


def test_evaluate_matches_jax(tmp_path):
    """Same CAM dicts and GT PNGs -> the same 100-point mIoU curve."""
    rng = np.random.default_rng(6)
    pred, gt = tmp_path / "pred", tmp_path / "gt"
    pred.mkdir()
    gt.mkdir()
    names = [f"img{i}" for i in range(4)]
    for name in names:
        h, w = rng.integers(20, 40, size=2)
        classes = rng.choice(20, size=rng.integers(1, 4), replace=False)
        np.save(pred / f"{name}.npy",
                {int(c): rng.random((h, w)).astype(np.float32) for c in classes})
        label = rng.choice(np.concatenate([[0], classes + 1]), size=(h, w))
        label[rng.random((h, w)) < 0.05] = 255
        Image.fromarray(label.astype(np.uint8)).save(gt / f"{name}.png")
    curve_t = port_evaluate.do_python_eval_curve(str(pred), str(gt), names, num_workers=1)
    curve_j = jax_evaluate.do_python_eval_curve(str(pred), str(gt), names, num_workers=1)
    assert len(curve_t) == len(curve_j) == 100
    assert [c["mIoU"] for c in curve_t] == [c["mIoU"] for c in curve_j]
    assert curve_t[30] == {k: v for k, v in curve_j[30].items() if k in curve_t[30]}
    assert port_evaluate.do_python_eval(str(pred), str(gt), names, 21, "npy", 0.3, 1) \
        == curve_t[30]


def test_cli_writes_cam_dicts_that_the_evaluate_cli_scores(tmp_path, monkeypatch, capsys):
    """``infer_cam.main`` over a VOC-style list and label store, then
    ``evaluate.main`` on its output. A small random vit_small at crop 32
    stands in for the npz weights (the converter is tested on its own)."""
    from acr_wsss_tpu_torch import infer_cam
    from acr_wsss_tpu_torch.models.acr import ACR, init_random_

    rng = np.random.default_rng(7)
    names = ["2008_000001", "2008_000002"]
    (tmp_path / "img").mkdir()
    (tmp_path / "gt").mkdir()
    labels = {}
    for i, name in enumerate(names):
        Image.fromarray(rng.integers(0, 256, (30 + i, 41, 3), dtype=np.uint8)).save(
            tmp_path / "img" / f"{name}.jpg")
        Image.fromarray(rng.integers(0, 3, (30 + i, 41), dtype=np.uint8)).save(
            tmp_path / "gt" / f"{name}.png")
        labels[name] = np.zeros(20, np.float32)
        labels[name][[0, 1 + i]] = 1.0
    (tmp_path / "list.txt").write_text("\n".join(names) + "\n")
    np.save(tmp_path / "labels.npy", labels)

    def small_model(cfg):
        assert cfg.device == "cpu" and cfg.model.backbone == "vit_small"
        model = ACR(backbone_name="vit_small", dtype=torch.float32,
                    attn_impl=cfg.model.attn_impl)
        return init_random_(model, seed=0)

    monkeypatch.setattr(infer_cam, "load_model", small_model)
    out = tmp_path / "cams"
    infer_cam.main(["--weights", "unused.npz", "--backbone", "vit_small",
                    "--LISTpath", str(tmp_path / "list.txt"),
                    "--IMpath", str(tmp_path / "img"),
                    "--cls_labels", str(tmp_path / "labels.npy"),
                    "--out_cam", str(out), "--crop_size", "32",
                    "--batch_images", "2", "--device", "cpu"])
    for i, name in enumerate(names):
        cam = np.load(out / f"{name}.npy", allow_pickle=True).item()
        assert sorted(cam) == [0, 1 + i]
        assert all(m.shape == (30 + i, 41) and 0 <= m.min() and m.max() <= 1
                   for m in cam.values())
    port_evaluate.main(["--list", str(tmp_path / "list.txt"), "--predict_dir", str(out),
                        "--gt_dir", str(tmp_path / "gt"),
                        "--logfile", str(tmp_path / "evallog.txt"), "--comment", "cli",
                        "--type", "npy", "--curve", "True", "--num_workers", "1"])
    assert "mIoU" in (tmp_path / "evallog.txt").read_text()
    assert "99/60 background score" in capsys.readouterr().out
