"""The port's ViT and DeiT classifiers and its attention forward at every
head dim they use, against the JAX package's, on the CPU.

* ``ops/attn_cuda.py``: the forward's plain version (what K1f and K1n are
  held to on the card) against JAX's Pallas entry in interpret mode
  (``tests/test_attention.py:55-61``) and its einsum path at head dims 32,
  48, 80 and 96 (PiT, ``vit_huge_patch14_224_in21k``,
  ``vit_small_patch16_224``), N = 37 and 65, with and without the export,
  in bfloat16 (and float32 against the einsum path), in the D = 64 cases'
  tolerances (``tests/test_torch_attention.py``); and its backward's plain
  version (what K1b is held to on the card) against ``jax.grad`` through
  the Pallas entry in interpret mode at head dims 48 and 96, with and
  without the export's cotangent;
* ``models/vit_classifier.py``: ``ViTClassifier`` against JAX's at a few
  blocks and a 64x64 input (32x32 for the R50 hybrid), weights crossing by
  ``flax_to_state_dict``: a plain name, a distilled one (head, dist and
  averaged logits), an ``_in21k`` one (``pre_logits``), one without qkv
  bias, the R50 hybrid, a bare stem with a ``hybrid_patch_size``
  patchify, and head dim 96 (JAX on its Pallas kernel in interpret mode);
  logits, ``features`` and the tap in float32, and one bfloat16 case;
* the refusal of a head dim outside the kernel's range.

The port runs ``attn_impl="kernel"``, every name's default: on CPU tensors
the wrapper takes the kernel's plain version.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acr_wsss_tpu.models import registry as jax_registry
from acr_wsss_tpu.ops.attention import _attention_xla
from acr_wsss_tpu_torch.models import registry
from acr_wsss_tpu_torch.models.convert import flax_to_state_dict
from acr_wsss_tpu_torch.models.vit import Attention
from acr_wsss_tpu_torch.ops.attn_cuda import FWD_HEAD_DIMS, fused_attention_qkv_cols
from tests.torch_port_helpers import random_flax_params, unflatten_params
from tests.test_torch_attention import (BF16_OUT_VS_PALLAS, BF16_OUT_VS_XLA, F32_OUT_TOL,
                                        F32_PROBS_TOL, GRAD_ATOL)

B, H = 2, 4
# float32 through the trunk: the two frameworks sum in other orders, a few
# ulps per block of values up to about 10 -> 1e-4 absolute. Where the R50
# stem (16 bottlenecks of weight-standardized convs and GroupNorms) is in
# the path its float32 convolutions in another order reach the tokens at
# 4e-4 (6.6e-5 of the largest feature at a 64x64 input; JAX's own hybrid
# tests hold 1e-4 of the largest value) -> 5e-4.
F32_ATOL, STEM_ATOL = 1e-4, 5e-4
# bfloat16 through the blocks on both sides: bf16 rounding (2^-8) of every
# block's output, in other places -> 2e-2 of the largest |logit|.
BF16_LOGITS_REL = 2e-2


def _jax_pallas_cols(qkv_j, scale, export):
    from jax.experimental.pallas import tpu as pltpu

    from acr_wsss_tpu.ops.attn_pallas import fused_attention_qkv_cols as jax_cols

    with pltpu.force_tpu_interpret_mode():
        return jax_cols(qkv_j, scale, H, export=export)


@pytest.mark.parametrize("n", [37, 65])
@pytest.mark.parametrize("d", [32, 48, 80, 96])
def test_qkv_cols_plain_matches_jax_at_other_head_dims(d, n):
    """K1f (export "mean") and K1n ("none") in bfloat16, the kernels'
    dtype, against JAX's Pallas entry and its einsum path; float32 against
    the einsum path."""
    qkv = np.random.default_rng(d + n).normal(size=(B, n, 3 * H * d)).astype(np.float32)
    scale = d ** -0.5
    for dtype in ("bfloat16", "float32"):
        qkv_j = jnp.asarray(qkv, dtype)
        q, k, v = jnp.transpose(qkv_j.reshape(B, n, 3, H, d), (2, 0, 3, 1, 4))
        f32 = dtype == "float32"
        for export in ("mean", "none"):
            out_t, probs_t = fused_attention_qkv_cols(
                torch.from_numpy(qkv).to(getattr(torch, dtype)), scale, H, export=export)
            out_x, probs_x = _attention_xla(q, k, v, scale, None, export)
            refs = [(jnp.transpose(out_x, (0, 2, 1, 3)).reshape(B, n, H * d), probs_x,
                     F32_OUT_TOL if f32 else BF16_OUT_VS_XLA)]
            if not f32:
                refs.append((*_jax_pallas_cols(qkv_j, scale, export), BF16_OUT_VS_PALLAS))
            for out_r, probs_r, tol in refs:
                np.testing.assert_allclose(out_t.float().numpy(), np.asarray(out_r, np.float32),
                                           **tol)
                if export == "none":
                    assert probs_t is None and probs_r is None
                else:
                    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_r, np.float32),
                                               **F32_PROBS_TOL)


@pytest.mark.parametrize("with_de", [True, False])
@pytest.mark.parametrize("d", [48, 96])
def test_qkv_cols_backward_plain_matches_pallas_grad_at_other_head_dims(d, with_de):
    """K1b's plain version at head dims 48 (PiT) and 96 (the small ViTs),
    float32, N = 37, against ``jax.grad`` through the Pallas entry (its
    backward kernel ``_bwd_kernel_nhd``), as at D = 64."""
    from jax.experimental.pallas import tpu as pltpu

    from acr_wsss_tpu.ops.attn_pallas import fused_attention_qkv_cols as jax_cols
    from acr_wsss_tpu_torch.ops.attn_cuda import attention_qkv_cols_backward_plain

    n, scale = 37, d ** -0.5
    rng = np.random.default_rng(d + with_de)
    qkv = rng.normal(size=(B, n, 3 * H * d)).astype(np.float32)
    g = rng.normal(size=(B, n, H * d)).astype(np.float32)
    de = rng.normal(size=(B, n, n)).astype(np.float32)
    export = "mean" if with_de else "none"

    def loss(x):
        out, probs = jax_cols(x, scale, H, export=export)
        return jnp.sum(out * g) + (jnp.sum(probs * de) if with_de else 0.0)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss)(jnp.asarray(qkv))
    got = attention_qkv_cols_backward_plain(torch.from_numpy(qkv), torch.from_numpy(g),
                                            torch.from_numpy(de) if with_de else None, scale, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=GRAD_ATOL)


def test_kernel_attention_refuses_head_dims_outside_its_range():
    assert FWD_HEAD_DIMS == (16, 32, 48, 64, 80, 96, 112, 128)
    for dim, heads in ((96, 4), (144, 1), (8, 1)):       # head dims 24, 144, 8
        with pytest.raises(ValueError, match=f"head dim .*got {dim // heads}"):
            Attention(dim, heads, attn_impl="kernel")
        Attention(dim, heads, attn_impl="plain")
    with pytest.raises(ValueError, match="got 24"):
        registry.create_model("pit_s_224", base_dims=(24, 24, 24))


def _image(crop, seed=1):
    return np.random.default_rng(seed).normal(size=(B, crop, crop, 3)).astype(np.float32)


def _pair(name, dtype, jax_attn="xla", **kw):
    """(JAX model, its flat weights, the port's model with them) of a
    registry name at ``kw``."""
    jm = jax_registry.create_model(name, dtype=getattr(jnp, dtype), attn_impl=jax_attn, **kw)
    flat = random_flax_params(jm, jnp.zeros((1, 64, 64, 3)), seed=0)
    tm = registry.create_model(name, dtype=getattr(torch, dtype), **kw)
    assert all(b.attn.attn_impl == "kernel" for b in tm.trunk.blocks)
    tm.load_state_dict(flax_to_state_dict(flat, tm.state_dict()))
    return jm, flat, tm


def _run(jm, flat, tm, x, jax_attn):
    """(the port's outputs, JAX's) on ``x``; JAX's apply jitted (one XLA
    compile, not one per op)."""
    apply = jax.jit(jm.apply)
    if jax_attn == "pallas":
        from jax.experimental.pallas import tpu as pltpu
        with pltpu.force_tpu_interpret_mode():
            want = apply(unflatten_params(flat), jnp.asarray(x))
    else:
        want = apply(unflatten_params(flat), jnp.asarray(x))
    before = fused_attention_qkv_cols.launches
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert fused_attention_qkv_cols.launches == before     # the plain version on the CPU
    return got, want


CASES = {
    "plain": ("vit_deit_tiny_patch16_224", dict(depth=2), 64, "xla"),
    "distilled": ("vit_deit_small_distilled_patch16_224", dict(depth=2), 64, "xla"),
    "in21k": ("vit_base_patch16_224_in21k", dict(depth=1, num_classes=50), 64, "xla"),
    "no_qkv_bias": ("vit_base_patch16_224_miil", dict(depth=1), 64, "xla"),
    "r50_hybrid": ("vit_base_r50_s16_384", dict(depth=1, num_classes=10), 32, "xla"),
    "bare_stem_p8": ("vit_tiny_r_s16_p8_224", dict(depth=2), 64, "xla"),
    "head_dim_96": ("vit_small_patch16_224", dict(depth=2), 64, "pallas"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_vit_classifier_matches_jax(case):
    name, kw, crop, jax_attn = CASES[case]
    jm, flat, tm = _pair(name, "float32", jax_attn, **kw)
    got, want = _run(jm, flat, tm, _image(crop), jax_attn)
    atol = STEM_ATOL if case == "r50_hybrid" else F32_ATOL
    keys = ["logits", "features"] + (["head_logits", "dist_logits"] if "distilled" in case
                                     else [])
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=atol,
                                   err_msg=k)
    assert list(got["taps"]) == [0] and got["taps"][0].dtype == torch.float32
    np.testing.assert_allclose(got["taps"][0].numpy(), np.asarray(want["taps"][0]), rtol=0,
                               atol=atol)
    assert tuple(got["grid"]) == tuple(want["grid"])
    if case == "in21k":
        assert "pre_logits/kernel" in "".join(flat)
    if case == "no_qkv_bias":
        assert tm.trunk.blocks[0].attn.qkv.bias is None
    if case == "distilled":
        torch.testing.assert_close(got["logits"], (got["head_logits"] + got["dist_logits"]) / 2)


def test_vit_classifier_matches_jax_in_bfloat16():
    jm, flat, tm = _pair("vit_small_patch16_224", "bfloat16", depth=2)
    got, want = _run(jm, flat, tm, _image(64), "xla")
    want = np.asarray(want["logits"], np.float32)
    assert got["logits"].dtype == torch.float32 and got["features"].dtype == torch.bfloat16
    np.testing.assert_allclose(got["logits"].numpy(), want, rtol=0,
                               atol=BF16_LOGITS_REL * np.abs(want).max())
