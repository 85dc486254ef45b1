"""Two model options of the JAX package in the port, against JAX.

* ``s2d_stem``: the hybrid stem's 7x7/2 conv as space-to-depth and a
  folded 4x4/1 conv (``acr_wsss_tpu/models/hybrid.py::WSConvS2D``), the
  same parameters and function as the plain conv; the train CLI's
  ``--s2d_stem``.
* The scanned checkpoint layout (``trunk/blocks_scan/block/...``, each
  block parameter stacked over the layers): ``models/convert.py``'s numpy
  ``scanned_to_unrolled`` / ``unrolled_to_scanned`` against the JAX
  functions of the same names, and ``infer_cam.load_model`` on a scanned
  npz, as ``acr_wsss_tpu/infer_cam.py:395-411`` loads one.

Tolerances: the stem in float32 through 3 weight-standardized 7x7 folds
and 16 bottlenecks, 1e-4 of the output's scale as
``tests/test_torch_model.py`` holds the stem; the layout conversions are
exact.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from acr_wsss_tpu_torch.models.convert import (flax_to_state_dict, scanned_to_unrolled,
                                               state_dict_to_flax, unrolled_to_scanned)
from tests.torch_port_helpers import flatten_params, random_flax_params, unflatten_params


def _close(actual, expected, rel=1e-4):
    actual, expected = np.asarray(actual, np.float64), np.asarray(expected, np.float64)
    assert actual.shape == expected.shape
    err, bound = np.abs(actual - expected).max(), rel * np.abs(expected).max()
    assert err <= bound, f"max abs err {err:.3g} > {bound:.3g}"


@pytest.mark.parametrize("size", [64, 38])
def test_s2d_stem_matches_jax_and_the_plain_stem(size):
    from acr_wsss_tpu.models.hybrid import ResNetV2Stem as JaxStem
    from acr_wsss_tpu_torch.models.hybrid import ResNetV2Stem, WSConvS2D

    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(np.float32)
    jax_stem = JaxStem(dtype=jnp.float32, s2d_stem=True)
    flat = random_flax_params(jax_stem, jnp.asarray(x), seed=4)
    feat_j, _ = jax.jit(jax_stem.apply)(unflatten_params(flat), jnp.asarray(x))

    s2d, plain = ResNetV2Stem(s2d_stem=True), ResNetV2Stem()
    assert isinstance(s2d.stem_conv, WSConvS2D)
    s2d.load_state_dict(flax_to_state_dict(flat, s2d.state_dict()))
    plain.load_state_dict(s2d.state_dict())
    assert set(state_dict_to_flax(s2d)) == set(flat)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        feat_s2d, _ = s2d(xt)
        feat_plain, _ = plain(xt)
        conv_s2d, conv_plain = s2d.stem_conv(xt), plain.stem_conv(xt)
    _close(feat_s2d.permute(0, 2, 3, 1).numpy(), feat_j)
    torch.testing.assert_close(conv_s2d, conv_plain, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="even"):
        s2d.stem_conv(xt[..., :-1])


def test_train_cli_takes_s2d_stem():
    from acr_wsss_tpu_torch import train

    cfg = train.parse_args(["--s2d_stem", "--device", "cpu"])
    assert cfg.model.s2d_stem and not train.parse_args([]).model.s2d_stem
    from acr_wsss_tpu_torch.models.hybrid import WSConvS2D

    assert isinstance(train.build_model(cfg.model).trunk.backbone.stem_conv, WSConvS2D)


@pytest.fixture(scope="module")
def scanned_and_unrolled():
    """(scanned flat params, unrolled flat params) of a JAX vitb ACR, the
    unrolled ones by JAX's own ``scanned_to_unrolled``."""
    from acr_wsss_tpu.models.acr import ACR as JaxACR
    from acr_wsss_tpu.models.convert import scanned_to_unrolled as jax_unroll

    flat = random_flax_params(JaxACR(backbone_name="vitb", dtype=jnp.float32,
                                     scan_blocks=True),
                              jnp.zeros((1, 32, 32, 3)), seed=9)
    assert any("trunk/blocks_scan/block/" in k for k in flat)
    unrolled = flatten_params(jax.device_get(jax_unroll(unflatten_params(flat))))
    return flat, {k: np.asarray(v) for k, v in unrolled.items()}


def test_scanned_layout_converts_as_jax_does(scanned_and_unrolled):
    from acr_wsss_tpu.models.convert import unrolled_to_scanned as jax_scan

    scanned, unrolled = scanned_and_unrolled
    got = scanned_to_unrolled(scanned)
    assert set(got) == set(unrolled) and any("trunk/blocks_11/" in k for k in got)
    for k in unrolled:
        np.testing.assert_array_equal(got[k], unrolled[k], err_msg=k)
    back = unrolled_to_scanned(got)
    ref = flatten_params(jax.device_get(jax_scan(unflatten_params(unrolled))))
    assert set(back) == set(ref) == set(scanned)
    for k in ref:
        np.testing.assert_array_equal(back[k], np.asarray(ref[k]), err_msg=k)
        np.testing.assert_array_equal(back[k], scanned[k], err_msg=k)


def test_infer_cam_loads_a_scanned_checkpoint(scanned_and_unrolled, tmp_path):
    from acr_wsss_tpu_torch import infer_cam
    from acr_wsss_tpu_torch.configs import InferConfig, ModelConfig
    from acr_wsss_tpu_torch.utils.checkpoint import save_params_npz

    scanned, unrolled = scanned_and_unrolled
    models = []
    for name, flat in (("scanned", scanned), ("unrolled", unrolled)):
        path = str(tmp_path / f"{name}.npz")
        save_params_npz(path, flat)
        models.append(infer_cam.load_model(InferConfig(
            model=ModelConfig(backbone="vitb", compute_dtype="float32"), weights=path,
            device="cpu")))
    a, b = (m.state_dict() for m in models)
    assert set(a) == set(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
