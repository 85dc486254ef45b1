"""The port's pseudo-label toolbox (``pseudo_label.py``: every recipe,
``utils/visualization.py``, the JET and VOC palettes of ``ops/imops.py``)
against the JAX package's, on the CPU.

Both sides run the same numpy and the same C++ engine (each package's own
build of ``cpp/``; JAX's into a private directory so that no other test
process's build races it), so the masks are held equal and the dense
energy to 1e-6 relative.
"""

import numpy as np
import pytest
from PIL import Image

from acr_wsss_tpu import pseudo_label as jax_pl
from acr_wsss_tpu.ops import bilateral as jax_bilateral
from acr_wsss_tpu.ops import imops as jax_imops
from acr_wsss_tpu.utils import visualization as jax_vis
from acr_wsss_tpu_torch import pseudo_label
from acr_wsss_tpu_torch.ops import imops
from acr_wsss_tpu_torch.utils import visualization

SIZES = ((40, 52), (36, 48), (44, 30))


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_native") / "libacrnative.so")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bilateral, "_LIB_PATH", path)
        assert jax_bilateral.load_library(rebuild=True) is not None


def _blob_cams(rng, h, w, classes):
    yy, xx = np.mgrid[0:h, 0:w]
    cams = {}
    for c in classes:
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        m = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 10.0 ** 2))
        m = m + rng.uniform(0, 0.05, (h, w))
        cams[int(c)] = ((m - m.min()) / (m.max() - m.min())).astype(np.float32)
    return cams


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """JPEGs of two-tone regions, CAM dicts as ``infer_cam --out_cam`` writes
    them (one at half size, to take the resize), saliency PNGs, a list."""
    root = tmp_path_factory.mktemp("pseudo")
    for d in ("img", "cam", "sal"):
        (root / d).mkdir()
    rng = np.random.default_rng(0)
    names = []
    for i, (h, w) in enumerate(SIZES):
        name = f"2007_{i:06d}"
        names.append(name)
        img = np.full((h, w, 3), 60, np.uint8)
        img[h // 4: 3 * h // 4, w // 4: 3 * w // 4] = (200, 90, 40)
        img = np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(root / "img" / f"{name}.jpg")
        classes = rng.choice(20, size=1 + i % 3, replace=False)
        cams = _blob_cams(rng, h, w, classes)
        if i == 1:
            cams = {c: m[::2, ::2].copy() for c, m in cams.items()}
        np.save(root / "cam" / f"{name}.npy", cams)
        sal = (rng.uniform(size=(h, w)) > 0.3).astype(np.uint8) * 255
        Image.fromarray(sal).save(root / "sal" / f"{name}.png")
    (root / "list.txt").write_text("\n".join(names) + "\n")
    return root, names


def _assert_same_pngs(a_dir, b_dir):
    files = sorted(p.name for p in a_dir.iterdir())
    assert files and files == sorted(p.name for p in b_dir.iterdir())
    for f in files:
        np.testing.assert_array_equal(np.asarray(Image.open(a_dir / f)),
                                      np.asarray(Image.open(b_dir / f)))
    return files


@pytest.mark.parametrize("recipe,saliency", [("default", False), ("default", True),
                                             ("two_step", True), ("rrm", False)])
def test_generate_pseudo_masks_matches_jax(corpus, tmp_path, recipe, saliency):
    root, names = corpus
    sal = str(root / "sal") if saliency else None
    pseudo_label.generate_pseudo_masks(str(root / "cam"), str(root / "img"), names,
                                       str(tmp_path / "port"), recipe=recipe,
                                       saliency_dir=sal)
    jax_pl.generate_pseudo_masks(str(root / "cam"), str(root / "img"), names,
                                 str(tmp_path / "jax"), recipe=recipe, saliency_dir=sal)
    files = _assert_same_pngs(tmp_path / "port", tmp_path / "jax")
    masks = [f"{n}.png" for n in names]
    assert sorted(f for f in files if not f.endswith("_color.png")) == masks
    for name, (h, w) in zip(names, SIZES):
        mask = np.asarray(Image.open(tmp_path / "port" / f"{name}.png"))
        assert mask.shape == (h, w) and mask.dtype == np.uint8
        assert set(np.unique(mask).tolist()) <= set(range(21)) | {255}


def test_main_writes_the_masks(corpus, tmp_path):
    root, names = corpus
    argv = ["--cam_dir", str(root / "cam"), "--IMpath", str(root / "img"),
            "--list", str(root / "list.txt"), "--recipe", "rrm", "--cut_threshold", "0.8"]
    pseudo_label.main(argv + ["--out_dir", str(tmp_path / "port")])
    jax_pl.main(argv + ["--out_dir", str(tmp_path / "jax")])
    assert _assert_same_pngs(tmp_path / "port", tmp_path / "jax") == [f"{n}.png" for n in names]


# The recipes ``generate_pseudo_masks`` reaches, then the eight it does not
# (two of them COCO's, on 80 classes).
RECIPES = ["compute_seg_label", "compute_seg_label_two_step", "compute_seg_label_rrm",
           "compute_seg_label_coco", "compute_seg_label_crf_sure", "compute_seg_label_2",
           "compute_seg_label_old", "compute_seg_label_no_saliency", "compute_seg_label_4",
           "compute_seg_label_5", "compute_seg_label_two_step_coco"]
NO_SALIENCY = ("compute_seg_label_rrm", "compute_seg_label_old", "compute_seg_label_no_saliency")


@pytest.mark.parametrize("n_classes", [1, 3])
@pytest.mark.parametrize("recipe", RECIPES)
def test_recipes_match_jax(recipe, n_classes):
    """Every recipe, with one present class and with three: the same masks
    (and saliency, and ``_5``'s dilated foreground) as JAX's."""
    rng = np.random.default_rng(10 * RECIPES.index(recipe) + n_classes)
    h, w = 48, 56
    total = 80 if recipe.endswith("_coco") else 20
    img = np.clip(rng.normal(120, 40, (h, w, 3)), 0, 255).astype(np.uint8)
    cam_label = np.zeros(total, np.float32)
    classes = rng.choice(total, size=n_classes, replace=False)
    cam_label[classes] = 1.0
    norm_cam = np.zeros((total, h, w), np.float32)
    for c, m in _blob_cams(rng, h, w, classes).items():
        norm_cam[c] = m
    sal = (rng.uniform(size=(h, w)) > 0.2).astype(np.uint8)
    args = (img, cam_label, norm_cam) + (() if recipe in NO_SALIENCY else (sal,))
    got = getattr(pseudo_label, recipe)(*(a.copy() for a in args))
    ref = getattr(jax_pl, recipe)(*(a.copy() for a in args))
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert got[0].shape == (h, w) and got[0].dtype == np.uint8


def test_crf_with_alpha_matches_jax():
    rng = np.random.default_rng(9)
    img = np.clip(rng.normal(120, 40, (40, 44, 3)), 0, 255).astype(np.uint8)
    cams = _blob_cams(rng, 40, 44, (3, 11))
    got = pseudo_label.crf_with_alpha(img, cams, 8)
    assert got.shape == (21, 40, 44)
    np.testing.assert_allclose(got, jax_pl.crf_with_alpha(img, cams, 8), rtol=0, atol=1e-6)


def test_dense_energy_loss_matches_jax():
    rng = np.random.default_rng(11)
    images = np.clip(rng.normal(120, 50, (2, 24, 28, 3)), 0, 255).astype(np.float32)
    logits = rng.normal(size=(2, 4, 24, 28))
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    crops = (rng.uniform(size=(2, 24, 28)) > 0.1).astype(np.float32)
    value, grad = pseudo_label.dense_energy_loss(images, probs, crops)
    ref_value, ref_grad = jax_pl.dense_energy_loss(images, probs, crops)
    assert np.isfinite(value) and value > 0
    np.testing.assert_allclose(value, ref_value, rtol=1e-6)
    assert grad.shape == probs.shape
    np.testing.assert_allclose(grad, ref_grad, rtol=0, atol=1e-6)


def test_palettes_and_visualization_match_jax():
    rng = np.random.default_rng(12)
    gray = rng.integers(0, 256, (9, 11), dtype=np.uint8)
    np.testing.assert_array_equal(imops.apply_colormap_jet(gray), jax_imops.apply_colormap_jet(gray))
    np.testing.assert_array_equal(imops.voc_colormap(), jax_imops.voc_colormap())
    np.testing.assert_array_equal(visualization.get_pascal_labels(), jax_vis.get_pascal_labels())
    labels = rng.integers(0, 23, (9, 11)).astype(np.uint8)
    labels[0, 0] = 255
    for dataset in ("pascal", "coco"):
        np.testing.assert_array_equal(visualization.decode_segmap(labels, dataset),
                                      jax_vis.decode_segmap(labels, dataset))
    with pytest.raises(ValueError, match="unknown dataset"):
        visualization.decode_segmap(labels, "ade")
    png = visualization.voc_label_to_colormap_png(labels)
    assert png.mode == "P" and png.getpalette() == jax_vis.voc_label_to_colormap_png(
        labels).getpalette()
    prob = rng.uniform(-0.1, 1.1, (3, 9, 11)).astype(np.float32)
    img = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    np.testing.assert_array_equal(visualization.color_pro(prob[0]), jax_vis.color_pro(prob[0]))
    np.testing.assert_array_equal(visualization.color_pro(prob[0], img.transpose(2, 0, 1), "chw"),
                                  jax_vis.color_pro(prob[0], img.transpose(2, 0, 1), "chw"))
    np.testing.assert_array_equal(visualization.max_norm(prob), jax_vis.max_norm(prob))
    np.testing.assert_array_equal(visualization.generate_vis(prob, img),
                                  jax_vis.generate_vis(prob, img))
