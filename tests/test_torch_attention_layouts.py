"""The port's three other attention layouts against the JAX entries.

``fused_attention_with_probs`` (K5a, q, k, v (B, H, N, D)),
``fused_attention_nhd`` (K5b, split (B, N, H*D)) and ``fused_attention_qkv``
(K5c, the joint (B, N, 3*H*D) projection) of
``acr_wsss_tpu_torch.ops.attn_cuda``, on CPU tensors, are the plain
versions of the CUDA kernels. Here they are held against the JAX entries of
the same names (the Pallas kernels in interpret mode, as
``tests/test_attention.py`` runs them): out, the float32 and the bfloat16
head-mean export, and the gradients of q, k, v (or qkv) under a loss that
weights both outputs. Inputs are made with numpy from a seed, at B=2, H=2,
N=37 (not a multiple of the TPU kernels' 128), D=64, in float32.

Tolerances: out 1e-5 (float32; the Pallas kernels normalize the p @ v
output per row instead of the prob tile); the float32 export 1e-6 absolute
(probabilities <= 1, summed over 2 heads in another order); the bfloat16
export within one bf16 ulp (both round the float32 mean once, which may
fall on either side of a rounding boundary), plus 1e-6; gradients 1e-4
absolute, as ``tests/test_attention.py`` holds the Pallas backward.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from acr_wsss_tpu_torch.ops import attn_cuda
from acr_wsss_tpu_torch.ops.attention import attention_with_probs
from tests.torch_port_helpers import assert_within_one_bf16_ulp

B, H, N, D = 2, 2, 37, 64
SCALE = D ** -0.5
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
F32_PROBS_TOL = dict(rtol=0, atol=1e-6)
GRAD_ATOL = 1e-4

# (entry, probs dtype, export)
CASES = [("K5a", "float32", "mean"), ("K5a", "float32", "none"),
         ("K5b", "float32", "mean"), ("K5b", "bfloat16", "mean"), ("K5b", "float32", "none"),
         ("K5c", "float32", "mean"), ("K5c", "bfloat16", "mean"), ("K5c", "float32", "none")]


def _inputs(entry, seed=3):
    """Numpy inputs of the entry's layout."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, N, D)).astype(np.float32) for _ in range(3))
    if entry == "K5a":
        return q, k, v
    nhd = tuple(np.ascontiguousarray(t.transpose(0, 2, 1, 3).reshape(B, N, H * D))
                for t in (q, k, v))
    return nhd if entry == "K5b" else (np.concatenate(nhd, axis=-1),)


def _jax_entry(entry, probs_dtype, export):
    from acr_wsss_tpu.ops import attn_pallas

    if entry == "K5a":
        return lambda q, k, v: attn_pallas.fused_attention_with_probs(q, k, v, SCALE,
                                                                      export=export)
    dtype = jnp.dtype(probs_dtype)
    if entry == "K5b":
        return lambda q, k, v: attn_pallas.fused_attention_nhd(q, k, v, SCALE, H, export,
                                                               probs_dtype=dtype)
    return lambda qkv: attn_pallas.fused_attention_qkv(qkv, SCALE, H, export,
                                                       probs_dtype=dtype)


def _port_entry(entry, probs_dtype, export):
    dtype = getattr(torch, probs_dtype)
    if entry == "K5a":
        return lambda q, k, v: attn_cuda.fused_attention_with_probs(q, k, v, SCALE,
                                                                    export=export)
    if entry == "K5b":
        return lambda q, k, v: attn_cuda.fused_attention_nhd(q, k, v, SCALE, H, export, dtype)
    return lambda qkv: attn_cuda.fused_attention_qkv(qkv, SCALE, H, export, dtype)


def _port_plain(entry, probs_dtype, export):
    dtype = getattr(torch, probs_dtype)
    if entry == "K5a":
        return lambda q, k, v: attention_with_probs(q, k, v, SCALE, export=export)
    layout = "nhd" if entry == "K5b" else "cols"
    return lambda *xs: attn_cuda.forward_plain(layout, xs, SCALE, H, export, dtype)


def _interpret(fn, *args):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return fn(*args)


def _to_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("entry,probs_dtype,export", CASES)
def test_forward_matches_jax(entry, probs_dtype, export):
    xs = _inputs(entry)
    out_j, probs_j = _interpret(_jax_entry(entry, probs_dtype, export),
                                *(jnp.asarray(x) for x in xs))
    out_t, probs_t = _port_entry(entry, probs_dtype, export)(*(torch.from_numpy(x) for x in xs))
    assert tuple(out_t.shape) == out_j.shape and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), _to_np(out_j), **OUT_TOL)
    if export == "none":
        assert probs_t is None and probs_j is None
        return
    assert probs_t.dtype == getattr(torch, probs_dtype) and str(probs_j.dtype) == probs_dtype
    assert tuple(probs_t.shape) == (B, N, N)
    if probs_dtype == "float32":
        np.testing.assert_allclose(probs_t.numpy(), _to_np(probs_j), **F32_PROBS_TOL)
    else:
        assert_within_one_bf16_ulp(probs_t.float().numpy(), _to_np(probs_j))


@pytest.mark.parametrize("entry,probs_dtype,export", CASES)
def test_gradients_match_jax(entry, probs_dtype, export):
    """d/d inputs of sum(out * w_out) + sum(probs * w_probs): the export's
    cotangent reaches the backward in the export's dtype on both sides."""
    xs = _inputs(entry, seed=4)
    rng = np.random.default_rng(5)
    w_out = rng.normal(size=(B, H, N, D) if entry == "K5a" else (B, N, H * D)).astype(np.float32)
    w_probs = rng.normal(size=(B, N, N)).astype(np.float32)

    def loss_jax(*args):
        out, probs = _jax_entry(entry, probs_dtype, export)(*args)
        total = jnp.sum(out * w_out)
        if probs is not None:
            total = total + jnp.sum(probs.astype(jnp.float32) * w_probs)
        return total

    grads_j = _interpret(jax.grad(loss_jax, argnums=tuple(range(len(xs)))),
                         *(jnp.asarray(x) for x in xs))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    out, probs = _port_entry(entry, probs_dtype, export)(*ts)
    total = (out * torch.from_numpy(w_out)).sum()
    if probs is not None:
        total = total + (probs.float() * torch.from_numpy(w_probs)).sum()
    total.backward()
    for t, g_j in zip(ts, grads_j):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_j), rtol=0, atol=GRAD_ATOL)


@pytest.mark.parametrize("entry", ["K5a", "K5b", "K5c"])
def test_wrapper_is_plain_version_on_cpu(entry):
    xs = [torch.from_numpy(x).bfloat16() for x in _inputs(entry, seed=6)]
    probs_dtype = "float32" if entry == "K5a" else "bfloat16"
    fn = {"K5a": attn_cuda.fused_attention_with_probs, "K5b": attn_cuda.fused_attention_nhd,
          "K5c": attn_cuda.fused_attention_qkv}[entry]
    before = (fn.launches, fn.backward_launches)
    out, probs = _port_entry(entry, probs_dtype, "mean")(*xs)
    ref_out, ref_probs = _port_plain(entry, probs_dtype, "mean")(*xs)
    assert out.dtype == torch.bfloat16 and probs.dtype == getattr(torch, probs_dtype)
    assert torch.equal(out, ref_out) and torch.equal(probs, ref_probs)
    assert (fn.launches, fn.backward_launches) == before   # no kernel launched


@pytest.mark.parametrize("entry", ["K5a", "K5b", "K5c"])
def test_wrapper_refuses_a_non_unit_d_stride(entry):
    xs = [torch.from_numpy(x) for x in _inputs(entry, seed=7)]
    # The same shapes, with D strided by 2 (every other element of a wider row).
    strided = [torch.cat([x, x], dim=-1)[..., ::2] for x in xs]
    assert all(s.shape == x.shape and s.stride(-1) == 2 for s, x in zip(strided, xs))
    with pytest.raises(ValueError, match="unit stride"):
        _port_entry(entry, "float32", "mean")(*strided)


@pytest.mark.parametrize("entry", ["K5a", "K5b", "K5c"])
def test_wrapper_refuses_a_wrong_layout(entry):
    xs = [torch.from_numpy(x) for x in _inputs(entry, seed=8)]
    if entry == "K5a":      # (B, N, H*D) tensors where (B, H, N, D) belong
        wrong = [x.transpose(1, 2).flatten(2) for x in xs]
    elif entry == "K5b":    # (B, H, N, D) tensors where (B, N, H*D) belong
        wrong = [x.unflatten(-1, (H, D)).transpose(1, 2) for x in xs]
    else:                   # a feature axis that is not 3*H*D
        wrong = [xs[0][..., :-D]]
    with pytest.raises(ValueError, match=r"\(B, "):
        _port_entry(entry, "float32", "mean")(*wrong)
    with pytest.raises(ValueError, match="export"):
        _port_entry(entry, "float32", "bogus")(*xs)


@pytest.mark.parametrize("export", ["mean", "full", "none"])
def test_attention_with_probs_kernel_impl_takes_the_plain_path_for_offsets(export):
    """``impl="kernel"`` with a ``probs_offset`` (any export) or export
    "full" is the plain path, values and d loss / d offset; without an
    offset, "mean" and "none" are K5a and give the plain path's values."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(x) for x in _inputs("K5a", seed=9))
    offset = torch.from_numpy((0.01 * rng.normal(size=(B, H, N, N))).astype(np.float32))
    results = {}
    for impl in ("plain", "kernel"):
        off = offset.clone().requires_grad_(True)
        out, probs = attention_with_probs(q, k, v, SCALE, probs_offset=off, export=export,
                                          impl=impl)
        loss = out.square().sum() + (0 if probs is None else probs.square().sum())
        (g,) = torch.autograd.grad(loss, off)
        results[impl] = (out, probs, g)
    for a, b in zip(results["kernel"], results["plain"]):
        assert (a is None and b is None) or torch.equal(a, b)

    out_k, probs_k = attention_with_probs(q, k, v, SCALE, export=export, impl="kernel")
    out_p, probs_p = attention_with_probs(q, k, v, SCALE, export=export)
    assert torch.equal(out_k, out_p)
    assert (probs_k is None and probs_p is None) or torch.equal(probs_k, probs_p)
    with pytest.raises(ValueError, match="impl"):
        attention_with_probs(q, k, v, SCALE, impl="pallas")


@pytest.mark.parametrize("layout", ["cols", "nhd", "bhnd"])
def test_backward_plain_of_each_layout_is_one_math(layout):
    """The three layouts' plain backward give the same gradients, per
    head, on the same q, k, v, g and a bfloat16 de."""
    rng = np.random.default_rng(10)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, N, H, D)).astype(np.float32))
                  for _ in range(4))
    de = torch.from_numpy(rng.normal(size=(B, N, N)).astype(np.float32)).bfloat16()
    ref = attn_cuda.backward_plain("bhnd", [t.transpose(1, 2) for t in (q, k, v)],
                                   g.transpose(1, 2), de, SCALE, H)
    if layout == "bhnd":
        got = attn_cuda.backward_plain(layout, [t.transpose(1, 2) for t in (q, k, v)],
                                       g.transpose(1, 2), de, SCALE, H)
    elif layout == "nhd":
        got = attn_cuda.backward_plain(layout, [t.flatten(2) for t in (q, k, v)],
                                       g.flatten(2), de, SCALE, H)
        got = [t.unflatten(-1, (H, D)).transpose(1, 2) for t in got]
    else:
        qkv = torch.stack([q, k, v], dim=2).flatten(2)
        (dqkv,) = attn_cuda.backward_plain(layout, [qkv], g.flatten(2), de, SCALE, H)
        got = dqkv.unflatten(-1, (3, H, D)).permute(2, 0, 3, 1, 4)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
