"""The port's PAMR (``acr_wsss_tpu_torch/ops/pamr.py``) against the JAX
package's, on the CPU, where the port's wrappers take their plain versions.

* the whole refinement against ``acr_wsss_tpu.ops.pamr.pamr`` (XLA), over
  dilation lists up to the production one and a dilation beyond the image;
* against ``pamr_pallas`` (the TPU kernels K3 and K4) in interpret mode,
  on an image taller than one 48-row tile;
* the affinity tensor itself against JAX's, built from ``_local_std`` and
  ``_neighbors``: a sign flipped in both stencils would give the same
  mask but another affinity tensor;
* ``process_image`` with ``pamr_fn`` against JAX's ``process_image`` with
  ``pamr_jit``, on stub CAMs and at full vitb_hybrid width.

Tolerances: rtol 2e-5 / atol 2e-6 on the mask and the affinity, JAX's own
tolerance between its Pallas kernels and its XLA formulation
(``tests/test_pamr.py``): both sides are float32 and sum the taps and the
neighbours in other orders. ``process_image`` on stub CAMs is held to
1e-4 absolute on the [0, 1] CAM dicts, as in ``tests/test_torch_infer.py``;
at full width the tolerance of each stage is given in its test.
"""

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp
import torch

from acr_wsss_tpu.infer_cam import build_infer_fn as jax_build_infer_fn
from acr_wsss_tpu.infer_cam import process_image as jax_process_image
from acr_wsss_tpu.models.acr import ACR as JaxACR
from acr_wsss_tpu.ops import pamr as jax_pamr
from acr_wsss_tpu_torch.infer_cam import build_infer_fn, parse_args, process_image
from acr_wsss_tpu_torch.ops import pamr as port_pamr
from tests.torch_port_helpers import build_acr_pair

RTOL, ATOL = 2e-5, 2e-6
PRODUCTION = (1, 2, 4, 8, 12, 24)


def _inputs(seed, x_shape, mask_shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=x_shape).astype(np.float32),
            rng.uniform(size=mask_shape).astype(np.float32))


def _jax_affinity(x, dilations):
    x = jnp.asarray(x)
    logits = -jnp.abs(jax_pamr._neighbors(x, dilations) - x[:, :, None]) \
        / (1e-8 + 0.1 * jax_pamr._local_std(x, dilations))
    return np.asarray(jax.nn.softmax(jnp.mean(logits, axis=1), axis=1))


CASES = [((2, 3, 37, 29), (2, 5, 17, 11), d) for d in [(1,), (1, 2), (1, 2, 4, 8), PRODUCTION]]
# 17x13 with dilation 24: every tap of that dilation clamps to an edge.
BEYOND = ((1, 3, 17, 13), (1, 4, 9, 7), (1, 24))


@pytest.mark.parametrize("num_iter", [1, 3])
@pytest.mark.parametrize("x_shape,mask_shape,dilations", CASES + [BEYOND],
                         ids=["d1", "d1-2", "d1-8", "d1-24", "beyond_image"])
def test_pamr_matches_jax(x_shape, mask_shape, dilations, num_iter):
    x, mask = _inputs(num_iter, x_shape, mask_shape)
    ref = np.asarray(jax_pamr.pamr(jnp.asarray(x), jnp.asarray(mask), num_iter=num_iter,
                                   dilations=dilations))
    before = (port_pamr.pamr_affinity.launches, port_pamr.pamr_update.launches)
    got = port_pamr.pamr(torch.from_numpy(x), torch.from_numpy(mask), num_iter, dilations)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    # CPU tensors take the plain versions: no kernel launch is counted.
    assert (port_pamr.pamr_affinity.launches, port_pamr.pamr_update.launches) == before


@pytest.mark.parametrize("dilations", [(1, 2), PRODUCTION])
def test_pamr_matches_pallas_kernels_in_interpret_mode(dilations):
    """H = 97 spans three 48-row tiles of the TPU kernels, the last one
    partial."""
    from jax.experimental.pallas import tpu as pltpu

    from acr_wsss_tpu.ops.pamr_pallas import pamr_pallas

    x, mask = _inputs(5, (1, 3, 97, 21), (1, 2, 97, 21))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pamr_pallas(jnp.asarray(x), jnp.asarray(mask), num_iter=2,
                                     dilations=dilations))
    got = port_pamr.pamr(torch.from_numpy(x), torch.from_numpy(mask), 2, dilations)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("x_shape,dilations", [
    ((2, 3, 37, 29), (1,)), ((2, 3, 37, 29), PRODUCTION), ((1, 3, 17, 13), (1, 24)),
], ids=["d1", "d1-24", "beyond_image"])
def test_affinity_matches_jax(x_shape, dilations):
    x, _ = _inputs(7, x_shape, (1,))
    got = port_pamr.pamr_affinity(torch.from_numpy(x), dilations).numpy()
    ref = _jax_affinity(x, dilations)
    assert got.shape == ref.shape == (x_shape[0], 8 * len(dilations)) + x_shape[2:]
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)


def test_shift_reads_against_the_offset_with_replicated_edges():
    x = torch.arange(20, dtype=torch.float32).reshape(4, 5)
    ref = np.asarray(jax_pamr._shift(jnp.asarray(x.numpy()), 2, -1))
    assert np.array_equal(port_pamr.shift(x, 2, -1).numpy(), ref)
    assert port_pamr.shift(x, 2, -1)[3, 1] == x[1, 2]
    assert np.array_equal(port_pamr.shift(x, 30, -30).numpy(),
                          np.asarray(jax_pamr._shift(jnp.asarray(x.numpy()), 30, -30)))
    assert port_pamr.neighbor_offsets((1, 2))[8:] == [(2 * dy, 2 * dx)
                                                      for dy, dx in jax_pamr._OFFSETS]


def test_flat_guidance_gives_uniform_finite_affinity():
    """std = 0 everywhere: the logits are 0, not NaN, and the softmax is
    uniform over the P neighbours, as in JAX."""
    x = np.full((1, 3, 9, 11), 0.25, np.float32)
    got = port_pamr.pamr_affinity(torch.from_numpy(x), PRODUCTION).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, 1.0 / 48, rtol=1e-6)
    np.testing.assert_allclose(got, _jax_affinity(x, PRODUCTION), rtol=RTOL, atol=ATOL)


def test_uniform_mask_is_a_fixed_point():
    x, _ = _inputs(8, (1, 3, 12, 12), (1,))
    mask = torch.full((1, 2, 12, 12), 0.5)
    out = port_pamr.make_pamr_fn(2, PRODUCTION)(torch.from_numpy(x), mask)
    np.testing.assert_allclose(out.numpy(), 0.5, atol=1e-5)


def test_dilation_count_is_checked():
    x = torch.zeros((1, 3, 8, 8))
    with pytest.raises(ValueError, match="1 to 8 dilations"):
        port_pamr.pamr_affinity(x, tuple(range(1, 10)))
    with pytest.raises(ValueError, match="1 to 8 dilations"):
        port_pamr.make_pamr_fn(1, ())


def test_cli_takes_pamr_flags_with_jax_defaults():
    cfg = parse_args(["--weights", "w.npz"])
    assert (cfg.pamr_iters, tuple(cfg.pamr_dilations)) == (0, PRODUCTION)
    cfg = parse_args(["--weights", "w.npz", "--pamr", "10", "--pamr_dilations", "1,3"])
    assert (cfg.pamr_iters, tuple(cfg.pamr_dilations)) == (10, (1, 3))


@pytest.fixture(scope="module")
def jpeg(tmp_path_factory):
    """A synthetic non-square JPEG with 3 labels."""
    path = tmp_path_factory.mktemp("pamr_img") / "2007_000002.jpg"
    rng = np.random.default_rng(4)
    small = rng.integers(0, 256, (9, 12, 3), dtype=np.uint8)
    Image.fromarray(np.asarray(Image.fromarray(small).resize((75, 53), Image.BILINEAR))).save(
        path, quality=90)
    label = np.zeros(20, np.float32)
    label[[2, 11, 14]] = 1.0
    return str(path), label


def test_process_image_pamr_matches_jax_on_stub_cams(jpeg):
    """The stub returns the same CAM rows for every class pass, so the
    refinement, the flip and the TTA sum are all that is compared."""
    path, label = jpeg
    crop, grid, C = 32, 2, 20
    cams = np.random.default_rng(3).uniform(size=(C, 2, grid * grid)).astype(np.float32)

    def jax_stub(batch, class_ids=None):
        B = batch.shape[0]
        return {"cams": jnp.asarray(cams), "patch_cam": jnp.zeros((B, grid * grid, C)),
                "logits": jnp.zeros((B, C))}

    def port_stub(batch, class_ids=None):
        B = batch.shape[0]
        return {"cams": torch.from_numpy(cams), "patch_cam": torch.zeros((B, grid * grid, C)),
                "logits": torch.zeros((B, C))}

    port_stub.class_slots, port_stub.device = 0, torch.device("cpu")
    ref, _, _ = jax_process_image(jax_stub, path, label, crop,
                                  pamr_fn=jax_pamr.pamr_jit(3, (1, 2)))
    got, _, _ = process_image(port_stub, path, label, crop,
                              pamr_fn=port_pamr.make_pamr_fn(3, (1, 2)))
    plain, _, _ = process_image(port_stub, path, label, crop)
    assert sorted(got) == sorted(ref) == [2, 11, 14]
    for c in ref:
        assert got[c].shape == (53, 75)
        np.testing.assert_allclose(got[c], ref[c], rtol=0, atol=1e-4)
    assert max(float(np.abs(got[c] - plain[c]).max()) for c in ref) > 1e-3


def _capture(store, key, fn):
    """``fn`` that keeps its input mask and its output in ``store[key]``."""
    def run(x, mask):
        out = fn(x, mask)
        store[key] = (np.asarray(mask), np.asarray(out))
        return out
    return run


def test_process_image_pamr_matches_jax_at_full_width(jpeg):
    """vitb_hybrid at crop 64, float32, shared weights, flip TTA, 4 class
    slots, the recipe's GETAM; PAMR with the production dilations. JAX runs
    the pipeline's ``attn_impl="pallas"`` in interpret mode.

    PAMR's input and output are held to 1e-4 of their largest value, the
    GETAM tolerance of ``tests/test_torch_infer.py``. The CAM dicts carry
    that error through the flip sum (x2) and the min-max normalization,
    which divides it by the class's range: with random weights a refined
    class map can span 1/30 of its magnitude, so each class's tolerance is
    2 * 1e-4 * max|refined| / (its range at native size)."""
    from jax.experimental.pallas import tpu as pltpu

    from acr_wsss_tpu_torch.ops.imops import resize_bilinear_np

    crop = 64
    _, params, port = build_acr_pair(crop, seed=2, jax_impl="xla", torch_impl="kernel")
    path, label = jpeg
    caps = {}
    jax_fn = jax_build_infer_fn(JaxACR(dtype=jnp.float32, attn_impl="pallas"), params, crop,
                                10, "grad", True, 20, class_slots=4)
    with pltpu.force_tpu_interpret_mode():
        ref, ref_patch, rgb = jax_process_image(
            jax_fn, path, label, crop,
            pamr_fn=_capture(caps, "jax", jax_pamr.pamr_jit(3, PRODUCTION)))
    fn = build_infer_fn(port, crop, 10, "grad", True, 20, class_slots=4)
    got, patch, _ = process_image(
        fn, path, label, crop,
        pamr_fn=_capture(caps, "port", port_pamr.make_pamr_fn(3, PRODUCTION)))

    (ref_in, ref_out), (got_in, got_out) = caps["jax"], caps["port"]
    assert got_out.shape == ref_out.shape == (2, 20, crop, crop)
    np.testing.assert_allclose(got_in, ref_in, rtol=0, atol=1e-4 * np.abs(ref_in).max())
    tol = 1e-4 * np.abs(ref_out).max()
    np.testing.assert_allclose(got_out, ref_out, rtol=0, atol=tol)
    summed = resize_bilinear_np(ref_out[0] + ref_out[1, :, :, ::-1], rgb.shape[:2],
                                align_corners=True)
    assert sorted(got) == sorted(ref) == [2, 11, 14]
    for c in ref:
        assert got[c].shape == (53, 75) and np.isfinite(got[c]).all()
        span = summed[c].max() - summed[c].min()
        np.testing.assert_allclose(got[c], ref[c], rtol=0, atol=2 * tol / span)
        np.testing.assert_allclose(patch[c], ref_patch[c], rtol=0, atol=1e-4)
