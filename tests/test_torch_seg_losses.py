"""The segmentation stage's host and loss pieces against the JAX package's:
the seg losses (value and gradient), ``Evaluator`` and ``pred_acc``,
``random_scale_crop`` and ``seg_validation`` with and without the CRF.

Tolerances: the losses are the same float32 operations on both sides, so
values within 1e-6 relative and gradients within 1e-6 of their largest
|value| (measured 1.9e-9). JAX's gradient of ``prototype_contrast_loss``
with an absent class is NaN everywhere: the zero centroid of the absent
class goes through ``jnp.linalg.norm``, whose derivative at 0 is inf,
times a zero mask. The port takes that norm's gradient as 0; its value is
held to JAX's, and its gradient to float64 central differences of its own
value (``torch.autograd.gradcheck``). ``random_scale_crop``: the draws and
the mask are equal, the image within 1e-5 (JAX resizes with OpenCV where
it is installed, the port in numpy: measured 4.8e-7). ``seg_validation``
runs one deterministic predictor through both packages; each side's
validation transform and logit resize differ by float32 rounding at most
(as above), so the argmax may differ at a tie-close pixel: mIoU within
1e-3.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from acr_wsss_tpu import evaluate as jax_evaluate
from acr_wsss_tpu import losses as jax_losses
from acr_wsss_tpu.data import transforms as jax_transforms
from acr_wsss_tpu.ops import bilateral as jax_bilateral
from acr_wsss_tpu.utils import metrics as jax_metrics
from acr_wsss_tpu_torch import evaluate, losses
from acr_wsss_tpu_torch.data import transforms
from acr_wsss_tpu_torch.utils import metrics

RTOL = 1e-6


def _logits_labels(seed, classes=5, shape=(2, 8, 8)):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(shape[0], classes) + shape[1:]).astype(np.float32)
    labels = rng.integers(0, classes, size=shape).astype(np.int32)
    labels[0, :2] = 255
    labels[1, :, :3] = 0
    return logits, labels


def _check(jax_fn, torch_fn, *args):
    """Value and gradient with respect to the first argument."""
    ref, ref_grad = jax.jit(jax.value_and_grad(jax_fn))(*map(jnp.asarray, args))
    x = torch.from_numpy(args[0]).requires_grad_(True)
    got = torch_fn(x, *map(torch.from_numpy, args[1:]))
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(ref)) <= RTOL * abs(float(ref)), (float(got), float(ref))
    ref_grad = np.asarray(ref_grad)
    assert np.abs(x.grad.numpy() - ref_grad).max() <= RTOL * np.abs(ref_grad).max()


@pytest.mark.parametrize("name", ["softmax_cross_entropy_ignore", "focal_loss_ignore",
                                  "compute_joint_ce"])
def test_seg_losses_match_jax(name):
    logits, labels = _logits_labels(0)
    _check(getattr(jax_losses, name), getattr(losses, name), logits, labels)


def test_cross_entropy_of_an_all_ignored_mask_is_zero():
    logits, _ = _logits_labels(2)
    labels = np.full((2, 8, 8), 255, np.int32)
    assert float(losses.softmax_cross_entropy_ignore(torch.from_numpy(logits),
                                                     torch.from_numpy(labels))) == 0.0


def _proto_inputs(seed, absent):
    rng = np.random.default_rng(seed)
    b, c, n, d = 2, 21, 60, 8
    logits = rng.normal(size=(b, c, n)).astype(np.float32)
    if absent:
        logits[:, 5:] -= 10.0        # classes 5-20 win no pixel
    else:
        logits[:, :, :c] += 20.0 * np.eye(c, dtype=np.float32)   # every class wins one
    return logits, rng.normal(size=(b, d, n)).astype(np.float32)


def test_prototype_contrast_loss_matches_jax():
    logits, feats = _proto_inputs(3, absent=False)
    _check(lambda f, lg: jax_losses.prototype_contrast_loss(lg, f, 21),
           lambda f, lg: losses.prototype_contrast_loss(lg, f, 21), feats, logits)


def test_prototype_contrast_loss_with_absent_classes():
    logits, feats = _proto_inputs(4, absent=True)
    ref = float(jax.jit(jax_losses.prototype_contrast_loss, static_argnums=2)(
        jnp.asarray(logits), jnp.asarray(feats), 21))
    got = float(losses.prototype_contrast_loss(torch.from_numpy(logits),
                                               torch.from_numpy(feats), 21))
    assert abs(got - ref) <= RTOL * abs(ref)
    f64 = torch.from_numpy(feats).double().requires_grad_(True)
    lg = torch.from_numpy(logits).double()
    assert torch.autograd.gradcheck(lambda f: losses.prototype_contrast_loss(lg, f, 21), (f64,))


def test_evaluator_and_pred_acc_match_jax():
    rng = np.random.default_rng(5)
    ours, theirs = metrics.Evaluator(21), jax_metrics.Evaluator(21)
    for _ in range(3):
        gt = rng.integers(0, 21, size=(17, 23))
        gt[rng.uniform(size=gt.shape) < 0.1] = 255
        pred = np.where(rng.uniform(size=gt.shape) < 0.6, gt % 21, rng.integers(0, 21, gt.shape))
        ours.add_batch(gt, pred)
        theirs.add_batch(gt, pred)
    np.testing.assert_array_equal(ours.confusion_matrix, theirs.confusion_matrix)
    for m in ("Pixel_Accuracy", "Pixel_Accuracy_Class", "Mean_Intersection_over_Union",
              "Frequency_Weighted_Intersection_over_Union"):
        assert getattr(ours, m)() == getattr(theirs, m)(), m
    with pytest.raises(ValueError):
        ours.add_batch(gt, pred[:-1])
    target = np.zeros(20)
    target[[2, 7, 11]] = 1
    scores = rng.normal(size=20)
    assert metrics.pred_acc(target, scores) == jax_metrics.pred_acc(target, scores)


@pytest.mark.parametrize("crop,scale_range", [(32, (0.75, 1.25)), (64, (0.5, 2.0))])
def test_random_scale_crop_matches_jax(crop, scale_range):
    rng = np.random.default_rng(6)
    img = transforms.normalize(rng.integers(0, 256, (48, 56, 3), dtype=np.uint8))
    mask = rng.integers(0, 3, (48, 56)).astype(np.uint8)
    mask[0, 0] = 255
    ours, theirs = np.random.default_rng(11), np.random.default_rng(11)
    got, got_mask = transforms.random_scale_crop(img, mask, crop, ours, scale_range)
    ref, ref_mask = jax_transforms.random_scale_crop(img, mask, crop, theirs, scale_range)
    assert got.shape == ref.shape == (crop, crop, 3)
    np.testing.assert_array_equal(got_mask, ref_mask)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert ours.integers(1 << 30) == theirs.integers(1 << 30)
    if crop == 64:
        assert (got_mask == 255).sum() > 1, "the pad is not the ignore label"


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """JAX's host CRF library, built by its own wrapper into this module's
    directory (no other test process's build races it)."""
    path = str(tmp_path_factory.mktemp("jax_native") / "libacrnative.so")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bilateral, "_LIB_PATH", path)
        assert jax_bilateral.load_library(rebuild=True) is not None
        yield


W_PREDICT = np.random.default_rng(8).normal(size=(3, 21)).astype(np.float32)


def _predict(x):
    """(1, crop, crop, 3) -> (21, crop, crop): a fixed linear map of the
    normalized pixels onto classes 0-3 (the others at -2)."""
    logits = np.einsum("hwc,ck->khw", np.asarray(x)[0], W_PREDICT)
    logits[4:] = -2.0
    return logits


@pytest.fixture(scope="module")
def seg_fixture(tmp_path_factory):
    """Three images; ground truth is the predictor's argmax at native size
    with a fifth of the pixels relabelled at random and a 255 band."""
    root = tmp_path_factory.mktemp("segval")
    rng = np.random.default_rng(7)
    names = []
    for i, (h, w) in enumerate(((48, 56), (40, 40), (37, 61))):
        name = f"v{i}"
        coarse = rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8)
        img = Image.fromarray(coarse).resize((w, h), Image.BILINEAR)
        img.save(root / f"{name}.jpg", quality=95)
        gt = _predict(transforms.normalize(np.asarray(img))[None]).argmax(0).astype(np.uint8)
        noise = rng.uniform(size=gt.shape) < 0.2
        gt[noise] = rng.integers(0, 4, int(noise.sum()))
        gt[:3] = 255
        Image.fromarray(gt).save(root / f"{name}.png")
        names.append(name)
    return str(root), names


@pytest.mark.parametrize("use_crf", [False, True])
def test_seg_validation_matches_jax(seg_fixture, jax_native, use_crf):
    root, names = seg_fixture
    ref = jax_evaluate.seg_validation(_predict, names, root, root, crop_size=32,
                                      use_crf=use_crf)
    got = evaluate.seg_validation(_predict, names, root, root, crop_size=32, use_crf=use_crf)
    assert 0.0 < got < 1.0
    assert abs(got - ref) <= 1e-3, (got, ref)
