"""The port's ``--out_crf`` stage, heatmaps and the CLI against the JAX
package's ``infer_cam``, on the CPU.

``crf_with_alpha`` runs the host engine on both sides (1e-6).
``crf_with_alpha_device`` runs JAX's jit-compiled ``crf_inference_jax``
and the port's ``crf_inference_torch`` (scatter, t=10, the
``crf_inference`` recipe) at a 64x64 bucket: the bound of the t=10
scatter case of ``tests/test_torch_crf.py``, 5e-5 (measured up to
9.8e-6 on these CAM-shaped inputs), with the same argmax. Heatmaps are
the same arrays, so the same JPEG bytes. On ``chip_smoke.py``'s phase 4
CAMs (the tracked npz) both routes have JAX's argmax at every pixel, so
they part exactly where JAX's do.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from acr_wsss_tpu import infer_cam as jax_infer_cam
from acr_wsss_tpu.ops import bilateral as jax_bilateral
from acr_wsss_tpu_torch import infer_cam
from acr_wsss_tpu_torch.models.acr import ACR, init_random_
from acr_wsss_tpu_torch.ops import crf as crf_ops

PAD = 64
DEVICE_ATOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """JAX's native library, built by its own wrapper into a directory of
    this module's (no race with another test process's build)."""
    path = str(tmp_path_factory.mktemp("jax_native") / "libacrnative.so")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bilateral, "_LIB_PATH", path)
        assert jax_bilateral.load_library(rebuild=True) is not None


def _cam_dict(rng, h, w, classes=(2, 7, 14)):
    """Min-max normalized blobs plus noise, one per class."""
    yy, xx = np.mgrid[0:h, 0:w]
    cams = {}
    for c in classes:
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        m = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 15.0 ** 2))
        m = m + rng.uniform(0, 0.1, (h, w))
        cams[c] = ((m - m.min()) / (m.max() - m.min())).astype(np.float32)
    return cams


def _assert_crf_dicts_close(got, ref, atol):
    assert sorted(got) == sorted(ref)
    keys = sorted(ref)
    for k in keys:
        assert got[k].shape == ref[k].shape and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol)
    np.testing.assert_array_equal(np.argmax(np.stack([got[k] for k in keys]), 0),
                                  np.argmax(np.stack([ref[k] for k in keys]), 0))


@pytest.mark.parametrize("alpha", [1, 12])
def test_crf_with_alpha_matches_jax(alpha):
    rng = np.random.default_rng(alpha)
    img = rng.integers(0, 256, (50, 60, 3), dtype=np.uint8)
    cams = _cam_dict(rng, 50, 60)
    got = infer_cam.crf_with_alpha(cams, alpha, img)
    _assert_crf_dicts_close(got, jax_infer_cam.crf_with_alpha(cams, alpha, img), 1e-6)
    assert sorted(got) == [0, 3, 8, 15]
    empty = infer_cam.crf_with_alpha({}, alpha, img)
    assert list(empty) == [0] and (empty[0] == 1).all() and empty[0].shape == (50, 60)


@pytest.mark.parametrize("alpha", [1, 12])
def test_crf_with_alpha_device_matches_jax(alpha):
    rng = np.random.default_rng(10 + alpha)
    img = rng.integers(0, 256, (50, 60, 3), dtype=np.uint8)
    cams = _cam_dict(rng, 50, 60)
    got = infer_cam.crf_with_alpha_device(cams, alpha, img, "cpu", num_classes=20, pad=PAD)
    ref = jax_infer_cam.crf_with_alpha_device(
        cams, alpha, img, jax_infer_cam.make_crf_device_fn(PAD), num_classes=20, pad=PAD)
    _assert_crf_dicts_close(got, ref, DEVICE_ATOL)
    assert sorted(got) == [0, 3, 8, 15]


def test_wiring_case_routes_agree_as_jax():
    """JAX's wiring test (``tests/test_bilateral_crf.py:171-190``) on the
    port: ``chip_smoke.crf_toy_inputs`` is JAX's input, and the port's
    device route at pad 32 agrees with its host route as JAX's does, above
    JAX's bound of 0.9."""
    import chip_smoke

    img, cams = chip_smoke.crf_toy_inputs()
    rng = np.random.default_rng(0)
    ref_img = np.zeros((24, 20, 3), np.float32)
    ref_img[:, :10] = [200, 30, 30]
    ref_img[:, 10:] = [30, 30, 200]
    ref_img += rng.normal(0, 5, size=ref_img.shape).astype(np.float32)
    np.testing.assert_array_equal(img, np.clip(ref_img, 0, 255).astype(np.uint8))
    pad = chip_smoke.CRF_TOY_PAD

    def agree(a, b):
        keys = sorted(a)
        return float((np.argmax(np.stack([a[k] for k in keys]), 0)
                      == np.argmax(np.stack([b[k] for k in keys]), 0)).mean())

    host = infer_cam.crf_with_alpha(cams, 4.0, img)
    dev = infer_cam.crf_with_alpha_device(cams, 4.0, img, "cpu", pad=pad)
    jax_host = jax_infer_cam.crf_with_alpha(cams, 4.0, img)
    jax_dev = jax_infer_cam.crf_with_alpha_device(
        cams, 4.0, img, jax_infer_cam.make_crf_device_fn(pad), num_classes=20, pad=pad)
    assert sorted(dev) == sorted(host) == [0, 5, 12]
    assert agree(dev, host) == agree(jax_dev, jax_host) > chip_smoke.CRF_ROUTE_AGREE


@pytest.fixture(scope="module")
def phase_4_cams(tmp_path_factory):
    """``chip_smoke.py``'s phase 4 images and their CAM dicts from the
    port's ``infer_cam`` on the CPU with the tracked npz
    (``chip_smoke.WEIGHTS``): vitb_hybrid at full width, crop 384."""
    import chip_smoke

    tmp = str(tmp_path_factory.mktemp("phase_4"))
    names, paths, labels = chip_smoke.make_images(tmp, seed=0)
    lst, labels_npy = f"{tmp}/list.txt", f"{tmp}/labels.npy"
    with open(lst, "w") as f:
        f.write("\n".join(names) + "\n")
    np.save(labels_npy, dict(zip(names, labels)))
    infer_cam.run(infer_cam.parse_args([
        "--weights", chip_smoke.WEIGHTS, "--LISTpath", lst, "--IMpath", tmp,
        "--cls_labels", labels_npy, "--crop_size", str(chip_smoke.CROP),
        "--batch_images", "1", "--out_cam", f"{tmp}/cams", "--device", "cpu"]))
    return {n: (np.load(f"{tmp}/cams/{n}.npy", allow_pickle=True).item(),
                np.asarray(Image.open(p).convert("RGB"))) for n, p in zip(names, paths)}


@pytest.mark.parametrize("name", ["smoke_0", "smoke_1"])
@pytest.mark.parametrize("alpha", [1, 12])
def test_phase_4_routes_agree_as_jax(phase_4_cams, name, alpha):
    """On trained weights' CAMs the device route (a 512 bucket of edge-
    replicated rows on a bilateral grid) and the host route (the lattice
    at the native size) part on 12% of smoke_0's pixels in JAX itself:
    the port's device route has JAX's argmax at every pixel, its host
    route JAX's marginals (1e-6), so its routes agree exactly as JAX's do
    (measured 0.878245 / 0.876715 on smoke_0, 0.965099 / 0.964979 on
    smoke_1, alpha 1 / 12)."""
    cams, rgb = phase_4_cams[name]
    dev = infer_cam.crf_with_alpha_device(cams, alpha, rgb, "cpu", pad=512)
    host = infer_cam.crf_with_alpha(cams, alpha, rgb)
    jax_dev = jax_infer_cam.crf_with_alpha_device(
        cams, alpha, rgb, jax_infer_cam.make_crf_device_fn(512), num_classes=20, pad=512)
    jax_host = jax_infer_cam.crf_with_alpha(cams, alpha, rgb)
    keys = sorted(jax_dev)
    assert sorted(dev) == keys == sorted(host) == sorted(jax_host)

    def labels(d):
        return np.argmax(np.stack([d[k] for k in keys]), 0)

    for k in keys:
        np.testing.assert_allclose(host[k], jax_host[k], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(labels(dev), labels(jax_dev))
    np.testing.assert_array_equal(labels(host), labels(jax_host))
    print(f"{name} alpha {alpha}: routes agree on "
          f"{(labels(dev) == labels(host)).mean():.6f} of the pixels")


def test_device_route_runs_one_bucket(monkeypatch):
    """Every image reaches ``crf_inference_torch`` edge-replicated to the
    (pad, pad) bucket with the full label slab, on the device asked for."""
    calls = []
    real = crf_ops.crf_inference_torch

    def recording(img, probs, device):
        calls.append((tuple(img.shape), tuple(probs.shape), img.device, probs.device, device))
        return real(img, probs, device=device)

    monkeypatch.setattr(crf_ops, "crf_inference_torch", recording)
    rng = np.random.default_rng(6)
    for h, w in ((50, 60), (PAD, 17)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got = infer_cam.crf_with_alpha_device(_cam_dict(rng, h, w), 1, img, "cpu",
                                              num_classes=20, pad=PAD)
        assert all(m.shape == (h, w) for m in got.values())
    cpu = torch.device("cpu")
    assert calls == [((PAD, PAD, 3), (21, PAD, PAD), cpu, cpu, "cpu")] * 2


def test_larger_than_pad_takes_the_host_engine(monkeypatch):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (PAD + 6, 40, 3), dtype=np.uint8)
    cams = _cam_dict(rng, PAD + 6, 40)
    assert not infer_cam.fits_crf_bucket(img.shape, PAD)
    assert infer_cam.fits_crf_bucket((PAD, PAD, 3), PAD)

    def never(*_, **__):
        raise AssertionError("the device route ran on an image beyond the bucket")

    monkeypatch.setattr(crf_ops, "crf_inference_torch", never)
    got = infer_cam.crf_with_alpha_device(cams, 4, img, "cpu", pad=PAD)
    _assert_crf_dicts_close(got, infer_cam.crf_with_alpha(cams, 4, img), 0)
    empty = infer_cam.crf_with_alpha_device({}, 4, img, "cpu", pad=PAD)
    assert list(empty) == [0] and (empty[0] == 1).all()


def test_save_heatmaps_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (30, 41, 3), dtype=np.uint8)
    cams = _cam_dict(rng, 30, 41, classes=(0, 14, 25))
    infer_cam.save_heatmaps(str(tmp_path / "port"), "img", rgb, cams)
    jax_infer_cam.save_heatmaps(str(tmp_path / "jax"), "img", rgb, cams)
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == ["img_aeroplane_getam.jpg", "img_class25_getam.jpg",
                     "img_person_getam.jpg"]
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
        assert np.asarray(Image.open(tmp_path / "port" / f)).shape == (30, 41, 3)


def test_cli_writes_both_alpha_folders_and_heatmaps(tmp_path, monkeypatch, capsys):
    """``infer_cam.main --out_crf --crf_device --heatmap`` on a small random
    vit_small at crop 32 (the converter is tested on its own): one image
    within the 64x64 bucket, one beyond it. Each alpha's dicts match JAX's
    ``crf_with_alpha_device`` applied to the port's own CAM dicts."""
    rng = np.random.default_rng(7)
    names, sizes = ["2008_000001", "2008_000002"], [(30, 41), (PAD + 2, 50)]
    (tmp_path / "img").mkdir()
    labels = {}
    for i, (name, (h, w)) in enumerate(zip(names, sizes)):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            tmp_path / "img" / f"{name}.jpg")
        labels[name] = np.zeros(20, np.float32)
        labels[name][[0, 1 + i]] = 1.0
    (tmp_path / "list.txt").write_text("\n".join(names) + "\n")
    np.save(tmp_path / "labels.npy", labels)

    def small_model(cfg):
        assert cfg.device == "cpu" and cfg.crf_pad == PAD
        return init_random_(ACR(backbone_name="vit_small", dtype=torch.float32,
                                attn_impl=cfg.model.attn_impl), seed=0)

    monkeypatch.setattr(infer_cam, "load_model", small_model)
    argv = ["--weights", "unused.npz", "--backbone", "vit_small",
            "--LISTpath", str(tmp_path / "list.txt"), "--IMpath", str(tmp_path / "img"),
            "--cls_labels", str(tmp_path / "labels.npy"), "--crop_size", "32",
            "--batch_images", "2", "--device", "cpu", "--out_cam", str(tmp_path / "cams"),
            "--out_crf", str(tmp_path / "crf"), "--crf_device", "--crf_pad", str(PAD),
            "--heatmap", str(tmp_path / "heat")]
    cfg = infer_cam.parse_args(argv)
    assert (cfg.out_crf, cfg.crf_device, cfg.crf_pad, cfg.low_alpha, cfg.high_alpha) == (
        str(tmp_path / "crf"), True, PAD, 1, 12)
    assert infer_cam.run(cfg) == {"device": 1, "host": 1}
    assert f"crf: 1 on cpu, 1 on host (larger than pad {PAD})" in capsys.readouterr().out

    jax_fn = jax_infer_cam.make_crf_device_fn(PAD)
    for name, (h, w) in zip(names, sizes):
        cam = np.load(tmp_path / "cams" / f"{name}.npy", allow_pickle=True).item()
        rgb = np.asarray(Image.open(tmp_path / "img" / f"{name}.jpg").convert("RGB"))
        for alpha in (1, 12):
            got = np.load(tmp_path / f"crf_{alpha}" / f"{name}.npy", allow_pickle=True).item()
            assert all(m.shape == (h, w) for m in got.values())
            ref = jax_infer_cam.crf_with_alpha_device(cam, alpha, rgb, jax_fn,
                                                      num_classes=20, pad=PAD)
            _assert_crf_dicts_close(got, ref, DEVICE_ATOL)
        heat = sorted(p.name for p in (tmp_path / "heat").glob(f"{name}_*"))
        assert heat == sorted(f"{name}_{c}_getam.jpg"
                              for c in ("aeroplane", ("bicycle", "bird")[names.index(name)]))

    # without --crf_device every image takes the host engine
    assert infer_cam.run(infer_cam.parse_args(
        [a for a in argv if a != "--crf_device"])) == {"device": 0, "host": 2}
    assert "crf: 2 on host" in capsys.readouterr().out
