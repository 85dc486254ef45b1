"""The port's dataset layer (``data/datasets.py``) against the JAX
package's, on the CPU, to the bit.

* ``radius_search_dist`` and ``get_indices_of_pairs`` at PSA's radius 5
  and others, on square and oblong grids;
* ``ExtractAffinityLabelInRadius`` on a label map with ignored (255)
  pixels: the bg-pos, fg-pos and neg targets;
* ``VOC12AffDataset``: the la/ha fusion (no-score pixels included) and
  whole items (the image, the targets on the stride-8 grid) from CAM dicts
  on disk;
* ``VOC12ImageDataset``, ``VOC12ClsDataset`` and ``VOC12ClsDatasetMSF``
  (three scales, mirrors, an ``inter_transform``) on JPEGs.

The JAX package resizes with cv2 (``INTER_LINEAR``) and the port with its
numpy copy of those semantics, 3e-5 apart on a uint8 image (another order
of float32 operations); the multi-scale case runs JAX's dataset on the
port's resize, as ``tests/test_torch_train.py`` does, so that it holds the
rest of the enumeration (scales, rounding of the target size, mirrors,
order, labels) to the bit.
"""

import numpy as np
import pytest
from PIL import Image

from acr_wsss_tpu.data import datasets as jax_datasets
from acr_wsss_tpu.data import transforms as jax_transforms
from acr_wsss_tpu_torch.data import datasets
from acr_wsss_tpu_torch.data import transforms


@pytest.mark.parametrize("radius,size", [(5, (16, 16)), (5, (24, 20)), (3, (9, 14)),
                                         (8, (32, 32))])
def test_pair_indices_match_jax(radius, size):
    assert datasets.radius_search_dist(radius) == jax_datasets.radius_search_dist(radius)
    got = datasets.get_indices_of_pairs(radius, size)
    want = jax_datasets.get_indices_of_pairs(radius, size)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _label_map(rng, size):
    label = rng.choice([0, 0, 3, 7, 255], size=size).astype(np.uint8)
    label[: size[0] // 2, : size[1] // 3] = 12
    return label


@pytest.mark.parametrize("cropsize,radius", [(24, 5), (17, 3)])
def test_affinity_labels_match_jax(cropsize, radius):
    label = _label_map(np.random.default_rng(cropsize), (cropsize, cropsize))
    got = datasets.ExtractAffinityLabelInRadius(cropsize, radius)(label)
    want = jax_datasets.ExtractAffinityLabelInRadius(cropsize, radius)(label)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert all(t.sum() > 0 for t in got)


def _cam_dict(rng, h, w, classes, zero_corner=False):
    cams = {int(c): rng.uniform(size=(h, w)).astype(np.float32) for c in classes}
    if zero_corner:      # a no-score region: every channel below 1e-5
        for c in cams:
            cams[c][:4, :5] = 0.0
    return cams


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """JPEGs, labels, and la/ha CAM dicts (background first, as the CRF
    writes them) in a temporary directory."""
    root = tmp_path_factory.mktemp("datasets")
    for d in ("img", "la", "ha"):
        (root / d).mkdir()
    rng = np.random.default_rng(0)
    names, labels = [], {}
    for i, (h, w) in enumerate(((40, 52), (37, 29), (64, 48))):
        name = f"2008_{i:06d}"
        names.append(name)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "img" / f"{name}.jpg")
        classes = sorted(rng.choice(20, size=1 + i, replace=False))
        labels[name] = np.eye(20, dtype=np.float32)[classes].sum(0)
        keys = [0] + [c + 1 for c in classes]
        for d, seed in (("la", 1), ("ha", 2)):
            np.save(root / d / f"{name}.npy",
                    _cam_dict(np.random.default_rng(10 * i + seed), h, w, keys,
                              zero_corner=True))
    return root, names, labels


def test_la_ha_fusion_matches_jax(voc):
    root, names, _ = voc
    for name in names:
        la = np.load(root / "la" / f"{name}.npy", allow_pickle=True).item()
        ha = np.load(root / "ha" / f"{name}.npy", allow_pickle=True).item()
        got = datasets.VOC12AffDataset.fuse_la_ha(None, la, ha)
        want = jax_datasets.VOC12AffDataset.fuse_la_ha(None, la, ha)
        assert got.dtype == np.uint8 and 255 in got and 0 in got
        np.testing.assert_array_equal(got, want)


def test_affinity_dataset_items_match_jax(voc):
    root, names, _ = voc
    args = (names, str(root / "img"), str(root / "la"), str(root / "ha"), 64)
    port, ref = datasets.VOC12AffDataset(*args), jax_datasets.VOC12AffDataset(*args)
    assert len(port) == len(ref) == len(names)
    for i in range(len(names)):
        (img, targets), (ref_img, ref_targets) = port[i], ref[i]
        np.testing.assert_array_equal(img, ref_img)
        for g, w in zip(targets, ref_targets, strict=True):
            np.testing.assert_array_equal(g, w)


def test_image_and_cls_datasets_match_jax(voc):
    root, names, labels = voc
    for cls, args in ((datasets.VOC12ImageDataset, (names, str(root / "img"))),
                      (datasets.VOC12ClsDataset, (names, str(root / "img"), labels))):
        ref = getattr(jax_datasets, cls.__name__)(*args)
        for got, want in zip(cls(*args), (ref[i] for i in range(len(ref)))):
            assert got[0] == want[0]
            for g, w in zip(got[1:], want[1:], strict=True):
                np.testing.assert_array_equal(g, w)


def test_msf_dataset_matches_jax(voc, monkeypatch):
    root, names, labels = voc
    monkeypatch.setattr(jax_transforms, "resize_bilinear_np", transforms.resize_hwc)
    kw = dict(scales=(1.0, 0.5, 1.5, 0.75), inter_transform=transforms.normalize)
    port = datasets.VOC12ClsDatasetMSF(names, str(root / "img"), labels, **kw)
    ref = jax_datasets.VOC12ClsDatasetMSF(names, str(root / "img"), labels, **kw)
    for i in range(len(names)):
        (name, imgs, label), (ref_name, ref_imgs, ref_label) = port[i], ref[i]
        assert name == ref_name and len(imgs) == len(ref_imgs) == 8
        np.testing.assert_array_equal(label, ref_label)
        for g, w in zip(imgs, ref_imgs):
            assert g.shape == w.shape and g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(imgs[1], imgs[0][:, ::-1])
