"""The port's DPT segmentation model (``models/dpt.py``) and its weights'
path through the converter, against the JAX package's.

Full width (ViT-B/16, 768 wide, 12 blocks; the hybrid's R50 stem; a
256-wide decoder) at crop 32 (a 2 x 2 token grid), on seeded numpy
weights carried into the port by ``flax_to_state_dict``; JAX with
``attn_impl="xla"``, the port with ``"plain"`` (its name for it).

Tolerances, relative to the largest |value| of the JAX result:
* float32: 1e-4 for vitb and 1e-3 for the hybrid, whose 50 weight-
  standardized convolutions sum in another order (measured 1.8e-6 and
  1.8e-5 on seg_logits);
* bfloat16: both packages round at other places, so the port is held to
  the float32 JAX result within twice JAX's own bf16 error there, in the
  largest and in the mean abs difference (measured, seeds 0-1: the port's
  error 0.7-1.5x JAX's, up to 1.43 of 5.6 on the hybrid's seg_logits, JAX's
  own up to 0.97), and must differ from its float32 result by at least a
  quarter of JAX's bf16 error, so that it does round;
* the modules alone (``Reassemble`` with each readout, ``CBAM``,
  ``attention_rollout``) 1e-5.
The converter both ways is exact, transposed convs included (``vitb``'s
``up4`` and ``up2``, square with in == out), and the JAX model applied
to the npz the port writes gives the port's logits (float32 tolerance).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from acr_wsss_tpu.models import dpt as jax_dpt
from acr_wsss_tpu_torch.models import dpt
from acr_wsss_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from acr_wsss_tpu_torch.utils.checkpoint import load_params_npz, save_params_npz
from tests.torch_port_helpers import (dpt_flax_params, jax_dpt_apply, random_flax_params,
                                      unflatten_params)

CROP = 32
F32_REL = {"vitb": 1e-4, "vitb_hybrid": 1e-3}
BF16_FACTOR, BF16_MIN_FRACTION = 2.0, 0.25
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _image(seed=1):
    return np.random.default_rng(seed).normal(size=(2, CROP, CROP, 3)).astype(np.float32)


def _close(actual, expected, rel, what=""):
    actual, expected = np.asarray(actual, np.float64), np.asarray(expected, np.float64)
    assert actual.shape == expected.shape, what
    err = np.abs(actual - expected).max()
    bound = rel * np.abs(expected).max()
    assert err <= bound, f"{what}: max abs err {err:.3g} > {bound:.3g}"


def _weights(backbone):
    return dpt_flax_params(backbone, 0, CROP)


def _jax_out(backbone, dtype, flat=None):
    out = jax_dpt_apply(backbone, dtype)(unflatten_params(flat or _weights(backbone)),
                                      jnp.asarray(_image()))
    return {k: np.asarray(out[k], np.float64) for k in ("seg_logits", "cls_logits")}


def _port(backbone, dtype="float32"):
    model = dpt.DPTSegmentationModel(backbone_name=backbone, dtype=DTYPES[dtype])
    model.load_state_dict(flax_to_state_dict(_weights(backbone), model.state_dict()))
    return model.requires_grad_(False)


def _port_out(model, export="mean"):
    out = model(torch.from_numpy(_image()), export=export)
    return out, {k: out[k].double().numpy() for k in ("seg_logits", "cls_logits")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backbone", ["vitb", "vitb_hybrid"])
def test_dpt_forward_matches_jax(backbone, dtype):
    raw, got = _port_out(_port(backbone, dtype))
    assert raw["seg_logits"].dtype == torch.float32
    assert raw["seg_logits"].shape == (2, 21, CROP, CROP) and raw["cls_logits"].shape == (2, 20)
    assert raw["probs"].shape == (2, 12, 5, 5)
    ref32 = _jax_out(backbone, "float32")
    if dtype == "float32":
        for k in ref32:
            _close(got[k], ref32[k], F32_REL[backbone], k)
        return
    ref = _jax_out(backbone, dtype)
    _, port32 = _port_out(_port(backbone))
    for k in ref:
        jax_err = np.abs(ref[k] - ref32[k])
        err = np.abs(got[k] - ref32[k])
        assert err.max() <= BF16_FACTOR * jax_err.max(), (k, err.max(), jax_err.max())
        assert err.mean() <= BF16_FACTOR * jax_err.mean(), (k, err.mean(), jax_err.mean())
        rounding = np.abs(got[k] - port32[k]).max()
        assert rounding >= BF16_MIN_FRACTION * jax_err.max(), (k, rounding, jax_err.max())


def test_export_none_drops_only_the_probs():
    model = _port("vitb")
    raw, got = _port_out(model, export="none")
    assert raw["probs"] is None
    _, ref = _port_out(model)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("backbone", ["vitb", "vitb_hybrid"])
def test_weights_round_trip_and_load_in_jax(backbone, tmp_path):
    flat = _weights(backbone)
    model = _port(backbone)
    back = state_dict_to_flax(model)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    again = dpt.DPTSegmentationModel(backbone_name=backbone)
    again.load_state_dict(flax_to_state_dict(back, again.state_dict()))
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k

    # Weights the port changed (every value perturbed), saved as the
    # trainer saves them, then read by JAX's model.
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=gen))
    path = str(tmp_path / "seg_last.npz")
    save_params_npz(path, state_dict_to_flax(model))
    loaded = load_params_npz(path)
    ref = _jax_out(backbone, "float32", loaded)
    _, got = _port_out(model)
    for k in ref:
        _close(got[k], ref[k], F32_REL[backbone], k)


@pytest.mark.parametrize("readout", ["ignore", "add", "project"])
def test_reassemble_matches_jax(readout):
    """Four taps on a 3 x 4 grid into levels 0-3: both transposed convs,
    the identity level and the strided conv."""
    rng = np.random.default_rng(5)
    grid = (3, 4)
    taps = [rng.normal(size=(2, 13, 768)).astype(np.float32) for _ in range(4)]
    jm = jax_dpt.Reassemble(readout=readout)
    flat = random_flax_params(jm, [jnp.asarray(t) for t in taps], 7, args=(grid, 1))
    ref = jm.apply(unflatten_params(flat), [jnp.asarray(t) for t in taps], grid, 1)
    port = dpt.Reassemble(768, readout=readout)
    port.load_state_dict(flax_to_state_dict(flat, port.state_dict()))
    with torch.no_grad():
        got = port([torch.from_numpy(t) for t in taps], grid, 1)
    for level, (g, r) in enumerate(zip(got, ref)):
        _close(g.permute(0, 2, 3, 1).numpy(), r, 1e-5, f"level {level}")
    assert [tuple(g.shape[-2:]) for g in got] == [(12, 16), (6, 8), (3, 4), (2, 2)]


def test_cbam_matches_jax():
    x = np.random.default_rng(6).normal(size=(2, 9, 11, 64)).astype(np.float32)
    jm = jax_dpt.CBAM()
    flat = random_flax_params(jm, jnp.asarray(x), 8)
    ref = jm.apply(unflatten_params(flat), jnp.asarray(x))
    port = dpt.CBAM(64)
    port.load_state_dict(flax_to_state_dict(flat, port.state_dict()))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1).numpy(), ref, 1e-5)


@pytest.mark.parametrize("start_layer", [0, 3])
def test_attention_rollout_matches_jax(start_layer):
    p = np.random.default_rng(9).uniform(size=(2, 5, 17, 17)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    ref = jax_dpt.attention_rollout(jnp.asarray(p), start_layer)
    got = dpt.attention_rollout(torch.from_numpy(p), start_layer)
    _close(got.numpy(), ref, 1e-5)
