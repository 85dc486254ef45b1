"""The port's model against the JAX package's, at full vitb_hybrid width.

The ResNetV2 (3, 4, 9) stem, the 12-block, 768-wide, 12-head ViT trunk and
the ACR heads run at crop 64 (a 4 x 4 token grid, N = 17) in float32 on
shared numpy weights that reach the port through its converter. The JAX
side runs with ``attn_impl="xla"`` and with ``"pallas"`` (interpret mode).

Tolerances: float32 on both sides, but 50 convolutions and 12 blocks deep
with sums in another order: the stem and the trunk tokens are held to 1e-4
relative to their scale, the probabilities to 1e-5 absolute.
"""

import os
import zipfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from acr_wsss_tpu.models.hybrid import ResNetV2Stem as JaxStem
from acr_wsss_tpu.models.vit import VisionTransformer as JaxViT
from acr_wsss_tpu_torch.models.acr import ACR as TorchACR
from acr_wsss_tpu_torch.models.convert import flax_to_state_dict
from acr_wsss_tpu_torch.models.hybrid import ResNetV2Stem as TorchStem
from tests.torch_port_helpers import (build_acr_pair, flatten_params,
                                      random_flax_params, unflatten_params)

CROP = 64
NPZ = os.path.join(os.path.dirname(__file__), os.pardir, "bench_artifacts",
                   "stability_r3", "stability_r3_last.npz")


def _image(seed=42):
    return np.random.default_rng(seed).normal(size=(2, CROP, CROP, 3)).astype(np.float32)


def _close(actual, expected, rel=1e-4, atol=0.0):
    """|a - e| <= rel * max|e| + atol, elementwise."""
    actual, expected = np.asarray(actual, np.float64), np.asarray(expected, np.float64)
    assert actual.shape == expected.shape
    bound = rel * np.abs(expected).max() + atol
    err = np.abs(actual - expected).max()
    assert err <= bound, f"max abs err {err:.3g} > {bound:.3g}"


def test_stem_matches_jax():
    x = _image()
    jax_stem = JaxStem(dtype=jnp.float32)
    flat = random_flax_params(jax_stem, jnp.asarray(x), seed=3)
    feat_j, taps_j = jax.jit(jax_stem.apply)(unflatten_params(flat), jnp.asarray(x))

    port = TorchStem()
    port.load_state_dict(flax_to_state_dict(flat, port.state_dict()))
    with torch.no_grad():
        feat_t, taps_t = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert feat_t.shape == (2, 1024, CROP // 16, CROP // 16)
    _close(feat_t.permute(0, 2, 3, 1).numpy(), feat_j)
    for name in ("stage0", "stage1"):
        _close(taps_t[name].permute(0, 2, 3, 1).numpy(), taps_j[name])


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [(4, 6), (37, 29)])
def test_resize_bilinear_matches_jax(size, align_corners):
    """Both corner conventions, down and up (float32 interpolation weights)."""
    from acr_wsss_tpu.models.layers import resize_bilinear as jax_resize
    from acr_wsss_tpu_torch.models.layers import resize_bilinear

    x = np.random.default_rng(8).normal(size=(2, 24, 17, 5)).astype(np.float32)
    ref = jax_resize(jnp.asarray(x), size, align_corners=align_corners)
    got = resize_bilinear(torch.from_numpy(x), size, align_corners=align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_acr_forward_matches_jax(jax_impl):
    """Trunk taps, final tokens, per-layer head-mean probs, logits, patch
    logits and patch_cam of the port against ``ACR(dtype=float32)``."""
    from jax.experimental.pallas import tpu as pltpu

    jax_model, params, port = build_acr_pair(CROP, seed=1, jax_impl=jax_impl)
    x = _image()

    def jax_outputs(p, xj):
        # One trace: forward_cam, with the trunk's own outputs captured.
        out, state = jax_model.apply(
            p, xj, method=jax_model.forward_cam, mutable=["intermediates"],
            capture_intermediates=lambda m, _: isinstance(m, JaxViT))
        return out, state["intermediates"]["trunk"]["__call__"][0]

    with pltpu.force_tpu_interpret_mode():
        cam_j, trunk_j = jax.jit(jax_outputs)(params, jnp.asarray(x))

    with torch.no_grad():
        xt = torch.from_numpy(x)
        cam_t = port.forward_cam(xt)
        trunk_t = port.trunk(xt)

    n = (CROP // 16) ** 2 + 1
    assert cam_t["probs"].shape == (2, 12, n, n)
    np.testing.assert_allclose(cam_t["probs"].numpy(), np.asarray(cam_j["probs"]),
                               rtol=0, atol=1e-5)
    for layer in (8, 11):
        _close(trunk_t["taps"][layer].numpy(), trunk_j["taps"][layer])
    _close(trunk_t["tokens"].numpy(), trunk_j["tokens"])
    for key in ("logits", "patch_logits", "patch_cam"):
        _close(cam_t[key].numpy(), cam_j[key])


def test_kernel_and_plain_attention_agree_on_cpu():
    """On CPU tensors the kernel wrapper is the plain version: the model
    gives the same outputs with either ``attn_impl``."""
    _, _, port = build_acr_pair(CROP, seed=2, torch_impl="kernel")
    plain = TorchACR(dtype=torch.float32, attn_impl="plain")
    plain.load_state_dict(port.state_dict())
    xt = torch.from_numpy(_image())
    with torch.no_grad():
        a, b = port.forward_cls(xt), plain.forward_cls(xt)
    assert torch.equal(a["logits"], b["logits"])
    assert torch.equal(a["probs"], b["probs"])


@pytest.fixture(scope="module")
def flat_zeros():
    """A zero param tree of the JAX vitb_hybrid ACR, flattened."""
    from acr_wsss_tpu.models.acr import ACR as JaxACR

    shapes = jax.eval_shape(lambda: JaxACR(dtype=jnp.float32).init(
        jax.random.key(0), jnp.zeros((1, CROP, CROP, 3))))
    return {k: np.zeros(v.shape, np.float32) for k, v in flatten_params(shapes).items()}


def test_converter_consumes_a_jax_param_tree_with_or_without_prefix(flat_zeros):
    assert all(k.startswith("params/") for k in flat_zeros)
    reference = TorchACR().state_dict()
    assert set(flax_to_state_dict(flat_zeros, reference)) == set(reference)
    bare = {k[len("params/"):]: v for k, v in flat_zeros.items()}
    assert set(flax_to_state_dict(bare, reference)) == set(reference)


def test_converter_raises_on_unused_missing_or_misshapen_keys(flat_zeros):
    reference = TorchACR().state_dict()
    with pytest.raises(ValueError, match="unused"):
        flax_to_state_dict({**flat_zeros, "params/trunk/extra/kernel": np.zeros((2, 2))},
                           reference)
    dropped = dict(flat_zeros)
    dropped.pop("params/trunk/blocks_3/attn/qkv/bias")
    with pytest.raises(ValueError, match="missing"):
        flax_to_state_dict(dropped, reference)
    bad = dict(flat_zeros)
    bad["params/cls_head/kernel"] = np.zeros((20, 768), np.float32)   # not (in, out)
    with pytest.raises(ValueError, match="shape"):
        flax_to_state_dict(bad, reference)


def test_converter_takes_every_key_of_the_tracked_checkpoint():
    """Key set and shapes of the tracked vitb_hybrid npz, read from the npy
    headers only (the arrays themselves are never loaded)."""
    if not os.path.exists(NPZ):
        pytest.skip("tracked checkpoint not present in this checkout")
    flat = {}
    with zipfile.ZipFile(NPZ) as z:
        for name in z.namelist():
            with z.open(name) as f:
                version = np.lib.format.read_magic(f)
                shape, _, dtype = (np.lib.format.read_array_header_1_0(f)
                                   if version == (1, 0)
                                   else np.lib.format.read_array_header_2_0(f))
            flat[name[:-len(".npy")]] = np.broadcast_to(np.zeros((), dtype), shape)
    reference = TorchACR().state_dict()
    converted = flax_to_state_dict(flat, reference)
    assert len(flat) == len(reference) == len(converted) == 308
