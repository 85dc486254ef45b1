"""The port's attention against the JAX package's, on the same inputs.

``acr_wsss_tpu_torch.ops.attn_cuda.fused_attention_qkv_cols`` on a CPU
tensor is the plain PyTorch version of the CUDA kernel; here it is held
against the JAX entry of the same name (the Pallas kernel, run in
interpret mode as ``tests/test_attention.py`` runs it) and against the
einsum path ``_attention_xla``. Its backward's plain math (the kernel K1b
is held to it on the card) is held against ``jax.grad`` through the
interpret-mode entry, and the pair-consistency entry of
``ops/attn_pair.py`` (values and gradients) against the JAX entry of the
same name. Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from acr_wsss_tpu.ops.attention import _attention_xla
from acr_wsss_tpu_torch.ops.attention import attention_with_probs
from acr_wsss_tpu_torch.ops.attn_cuda import (attention_qkv_cols_plain,
                                              fused_attention_qkv_cols)

B, H, D = 2, 12, 64
SCALE = D ** -0.5

# float32: the paths differ only in summation order and in where the
# softmax normalizer is applied -> a few float32 ulps.
F32_OUT_TOL = dict(rtol=1e-5, atol=1e-5)
F32_PROBS_TOL = dict(rtol=1e-5, atol=1e-6)
# bfloat16 inputs: logits and softmax are float32 on both sides, so probs
# keep the float32 tolerance. `out` is rounded to bf16 (8 mantissa bits),
# and so is p before p @ v. A float32 last-bit difference in p (exp and
# sum order differ) can flip p's bf16 rounding: one term of the sum moves
# by 2^-8 * p * |v|, absolute, up to ~2^-9 here (p <= 0.5, |v| < 4 with
# rare flips); the final rounding of `out` adds one bf16 ulp, 2^-8
# relative (rtol 2^-7 covers values just under a power of two). The
# Pallas kernel rounds the UNNORMALIZED exp to bf16 instead, a different
# rounding point for every term: twice both allowances.
BF16_OUT_VS_XLA = dict(rtol=2.0 ** -7, atol=2.0 ** -8)
BF16_OUT_VS_PALLAS = dict(rtol=2.0 ** -6, atol=2.0 ** -7)


def _qkv(n, seed):
    return np.random.default_rng(seed).normal(size=(B, n, 3 * H * D)).astype(np.float32)


def _to_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_split(qkv_j):
    n = qkv_j.shape[1]
    q, k, v = jnp.transpose(qkv_j.reshape(B, n, 3, H, D), (2, 0, 3, 1, 4))
    return q, k, v


def _jax_xla_cols(qkv_j, export):
    out, probs = _attention_xla(*_jax_split(qkv_j), SCALE, None, export)
    n = qkv_j.shape[1]
    return jnp.transpose(out, (0, 2, 1, 3)).reshape(B, n, H * D), probs


def _jax_pallas_cols(qkv_j, export):
    from jax.experimental.pallas import tpu as pltpu

    from acr_wsss_tpu.ops.attn_pallas import fused_attention_qkv_cols as jax_cols

    with pltpu.force_tpu_interpret_mode():
        return jax_cols(qkv_j, SCALE, H, export=export)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [17, 37])
@pytest.mark.parametrize("export", ["mean", "none"])
def test_qkv_cols_plain_matches_jax(n, dtype, export):
    qkv = _qkv(n, seed=n)
    qkv_j = jnp.asarray(qkv, dtype)
    qkv_t = torch.from_numpy(qkv).to(getattr(torch, dtype))
    out_t, probs_t = fused_attention_qkv_cols(qkv_t, SCALE, H, export=export)
    assert out_t.dtype == qkv_t.dtype and out_t.shape == (B, n, H * D)

    out_x, probs_x = _jax_xla_cols(qkv_j, export)
    out_p, probs_p = _jax_pallas_cols(qkv_j, export)
    out_tol_x = F32_OUT_TOL if dtype == "float32" else BF16_OUT_VS_XLA
    out_tol_p = F32_OUT_TOL if dtype == "float32" else BF16_OUT_VS_PALLAS
    np.testing.assert_allclose(out_t.float().numpy(), _to_np(out_x), **out_tol_x)
    np.testing.assert_allclose(out_t.float().numpy(), _to_np(out_p), **out_tol_p)
    if export == "none":
        assert probs_t is None and probs_p is None
        return
    assert probs_t.dtype == torch.float32 and probs_t.shape == (B, n, n)
    np.testing.assert_allclose(probs_t.numpy(), _to_np(probs_x), **F32_PROBS_TOL)
    np.testing.assert_allclose(probs_t.numpy(), _to_np(probs_p), **F32_PROBS_TOL)


def test_qkv_cols_wrapper_is_plain_version_on_cpu():
    qkv = torch.from_numpy(_qkv(37, seed=1)).bfloat16()
    before = fused_attention_qkv_cols.launches
    out, probs = fused_attention_qkv_cols(qkv, SCALE, H)
    ref_out, ref_probs = attention_qkv_cols_plain(qkv, SCALE, H)
    assert torch.equal(out, ref_out) and torch.equal(probs, ref_probs)
    assert fused_attention_qkv_cols.launches == before   # no kernel launched


def test_qkv_cols_wrapper_refuses_bad_inputs():
    qkv = torch.from_numpy(_qkv(17, seed=2))
    with pytest.raises(ValueError, match="export"):
        fused_attention_qkv_cols(qkv, SCALE, H, export="full")
    with pytest.raises(ValueError, match="3\\*H\\*D"):
        fused_attention_qkv_cols(qkv[..., :-1], SCALE, H)
    with pytest.raises(ValueError, match="device"):
        fused_attention_qkv_cols(qkv.to("meta"), SCALE, H)


@pytest.mark.parametrize("export", ["mean", "full", "none"])
def test_plain_attention_with_offset_and_its_gradient_match_jax(export):
    """Forward with a nonzero offset, and d loss / d offset, against the
    einsum path in float32 (tolerance: float32 summation order)."""
    n = 37
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(B, H, n, D)).astype(np.float32) for _ in range(3))
    offset = (0.01 * rng.normal(size=(B, H, n, n))).astype(np.float32)
    w_out = rng.normal(size=(B, H, n, D)).astype(np.float32)
    w_probs = rng.normal(size=(B, H, n, n) if export == "full"
                         else (B, n, n)).astype(np.float32)

    def loss_jax(off):
        out, probs = _attention_xla(*(jnp.asarray(a) for a in (q, k, v)), SCALE,
                                    off, export)
        loss = jnp.sum(out * w_out)
        if probs is not None:
            loss = loss + jnp.sum(probs * w_probs)
        return loss, (out, probs)

    (_, (out_j, probs_j)), g_j = jax.value_and_grad(loss_jax, has_aux=True)(
        jnp.asarray(offset))

    off_t = torch.from_numpy(offset).requires_grad_(True)
    out_t, probs_t = attention_with_probs(*(torch.from_numpy(a) for a in (q, k, v)),
                                          SCALE, probs_offset=off_t, export=export)
    loss_t = (out_t * torch.from_numpy(w_out)).sum()
    if probs_t is not None:
        loss_t = loss_t + (probs_t * torch.from_numpy(w_probs)).sum()
    (g_t,) = torch.autograd.grad(loss_t, off_t)

    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **F32_OUT_TOL)
    if export == "none":
        assert probs_t is None
    else:
        np.testing.assert_allclose(probs_t.detach().numpy(), np.asarray(probs_j),
                                   **F32_PROBS_TOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-4)


# float32 gradients through 37 keys, summed in another order than JAX's
# (and the Pallas backward's normalizer folds): 1e-4 absolute.
GRAD_ATOL = 1e-4


def _jax_pallas_pair(qkv_j):
    from jax.experimental.pallas import tpu as pltpu

    from acr_wsss_tpu.ops.attn_pallas import fused_attention_pair_consistency

    with pltpu.force_tpu_interpret_mode():
        return fused_attention_pair_consistency(qkv_j, SCALE, H)


@pytest.mark.parametrize("with_de", [True, False])
def test_qkv_cols_backward_plain_matches_jax_grad(with_de):
    from jax.experimental.pallas import tpu as pltpu

    from acr_wsss_tpu.ops.attn_pallas import fused_attention_qkv_cols as jax_cols
    from acr_wsss_tpu_torch.ops.attn_cuda import attention_qkv_cols_backward_plain

    n = 37
    rng = np.random.default_rng(11)
    qkv = _qkv(n, seed=12)
    g = rng.normal(size=(B, n, H * D)).astype(np.float32)
    de = rng.normal(size=(B, n, n)).astype(np.float32)
    export = "mean" if with_de else "none"

    def loss(x):
        out, probs = jax_cols(x, SCALE, H, export=export)
        total = jnp.sum(out * g)
        if with_de:
            total = total + jnp.sum(probs * de)
        return total

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss)(jnp.asarray(qkv))
    got = attention_qkv_cols_backward_plain(
        torch.from_numpy(qkv), torch.from_numpy(g),
        torch.from_numpy(de) if with_de else None, SCALE, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=GRAD_ATOL)

    # The same gradient through the wrapper's autograd function.
    x = torch.from_numpy(qkv).requires_grad_(True)
    out, probs = fused_attention_qkv_cols(x, SCALE, H, export=export)
    total = (out * torch.from_numpy(g)).sum()
    if with_de:
        total = total + (probs * torch.from_numpy(de)).sum()
    total.backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), rtol=0, atol=GRAD_ATOL)


@pytest.mark.parametrize("n", [17, 37])
def test_pair_consistency_entry_matches_jax(n):
    from acr_wsss_tpu_torch.ops.attn_pair import fused_attention_pair_consistency

    rng = np.random.default_rng(n + 20)
    qkv = _qkv(n, seed=n + 21)
    qkv = np.concatenate([qkv, qkv[:, :, ::-1].copy()])       # 4 rows: 2 pairs
    w_out = rng.normal(size=(4, n, H * D)).astype(np.float32)
    w_cls = np.array([3.0, -1.5], np.float32)
    w_aff = np.array([0.5, 2.0], np.float32)

    def loss_jax(x):
        out, cls_s, aff_s = _jax_pallas_pair(x)
        return jnp.sum(out * w_out) + jnp.sum(cls_s * w_cls) + jnp.sum(aff_s * w_aff)

    out_j, cls_j, aff_j = _jax_pallas_pair(jnp.asarray(qkv))
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        g_j = jax.grad(loss_jax)(jnp.asarray(qkv))

    x = torch.from_numpy(qkv).requires_grad_(True)
    out_t, cls_t, aff_t = fused_attention_pair_consistency(x, SCALE, H)
    ((out_t * torch.from_numpy(w_out)).sum() + (cls_t * torch.from_numpy(w_cls)).sum()
     + (aff_t * torch.from_numpy(w_aff)).sum()).backward()

    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=1e-5)
    np.testing.assert_allclose(cls_t.detach().numpy(), np.asarray(cls_j), rtol=1e-5)
    np.testing.assert_allclose(aff_t.detach().numpy(), np.asarray(aff_j), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), atol=GRAD_ATOL)


def test_pair_plain_versions_are_k1_plus_masked_l1():
    """K2f's plain version is K1's plain forward with explicit masked
    |delta| sums; K2b's plain version, fed that sign tile, is K1's plain
    backward with de = +-sign * g, and a None cotangent counts as zero."""
    from acr_wsss_tpu_torch.ops.attn_cuda import attention_qkv_cols_backward_plain
    from acr_wsss_tpu_torch.ops.attn_pair import (pair_consistency_backward,
                                                  pair_consistency_forward)

    n = 17
    qkv = torch.from_numpy(np.concatenate([_qkv(n, seed=31), _qkv(n, seed=32)]))
    out, cls_s, aff_s, sign = pair_consistency_forward(qkv, SCALE, H)
    ref_out, probs = attention_qkv_cols_plain(qkv, SCALE, H)
    delta = probs[0::2] - probs[1::2]
    assert torch.equal(out, ref_out)
    torch.testing.assert_close(cls_s, delta[:, 0, 1:].abs().sum(-1), rtol=1e-6, atol=0)
    torch.testing.assert_close(aff_s, delta[:, 1:, 1:].abs().sum((1, 2)), rtol=1e-6, atol=0)
    assert sign.dtype == torch.int8 and not sign[:, :, 0].any()
    assert torch.equal(sign[:, :, 1:], torch.sign(delta[:, :, 1:]).to(torch.int8))

    g = torch.from_numpy(np.random.default_rng(33).normal(
        size=(4, n, H * D)).astype(np.float32))
    g_cls, g_aff = torch.tensor([2.0, -1.0]), torch.tensor([0.5, 3.0])
    got = pair_consistency_backward(qkv, g, sign, g_cls, None, SCALE, H)
    de = sign.float() * torch.where(torch.arange(n)[None, :, None] == 0,
                                    g_cls[:, None, None], 0.0)
    de = torch.stack([de, -de], dim=1).reshape(4, n, n)
    torch.testing.assert_close(got, attention_qkv_cols_backward_plain(qkv, g, de, SCALE, H))
    with pytest.raises(ValueError, match="even batch"):
        pair_consistency_forward(qkv[:3], SCALE, H)
