"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need a CUDA card and ``nvcc`` and skip elsewhere.
On the card's machine, which has no JAX (``tests/conftest.py`` imports
it): ``python -m pytest --noconftest tests/test_torch_cuda.py``. Covers
K1f/K1n (with the float32 and the bfloat16 export), K1b (with a float32
and a bfloat16 de), K2f, K2b, K3 and K4, the three other attention layouts
K5a, K5b and K5c (forward and backward), their launch counters and what
they refuse; ragged token counts, more tokens than the earlier kernels'
shared-memory limit (the attention kernels and the pair forward), the
same bits from two launches, K4 on an odd shape, and K3 through its
gather kernel (a dilation beyond the tile kernel's halo); and the
on-device augmentation (``data/device_aug.py``) and the on-device dense
CRF (``ops/crf.py``), plain torch both, against their CPU runs; and one
bf16 seg step of the DPT model on the kernels (K1n, K1b with no de)
against the plain path; and the serving artifact exported on the card,
with and without embedded weights, against the live plain path; K1f at
the pit_b shapes and the pit_b forward on it (13 launches, the same bits
twice), a head dim outside the kernel's range refusing it, and a Swin
train step giving the same bits twice; K1f and K1n at head dims 16 to 128
(every multiple of 16 but 64: zero-filled tiles), ragged N, the same bits
twice, K5a's forward at head dim 96, and the ViT classifiers on K1n
against the plain path (launches counted; the PiT names at head dims 48
and 32 on K1f); a forward that asks for a gradient at a head dim the
backward kernels do not take raising before it launches.
Tolerances are those of ``chip_smoke.py``, with the reasons given there.
"""

import pytest
import torch

from acr_wsss_tpu_torch.ops.attn_cuda import (attention_qkv_cols_plain,
                                              fused_attention_qkv_cols)

pytestmark = pytest.mark.cuda

H, D = 12, 64
OUT_RTOL, OUT_ATOL, PROBS_ATOL = 2.0 ** -7, 2.0 ** -8, 1e-6


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("export", ["mean", "none"])
@pytest.mark.parametrize("batch,n", [(2, 577), (3, 37), (1, 1), (2, 9), (2, 17), (1, 1025)])
def test_attn_fwd_headmean_matches_plain(device, batch, n, export):
    gen = torch.Generator(device=device).manual_seed(n)
    qkv = torch.randn((batch, n, 3 * H * D), generator=gen, device=device).bfloat16()
    before = fused_attention_qkv_cols.launches
    out, probs = fused_attention_qkv_cols(qkv, D ** -0.5, H, export)
    ref_out, ref_probs = attention_qkv_cols_plain(qkv, D ** -0.5, H, export)
    torch.cuda.synchronize()
    assert fused_attention_qkv_cols.launches == before + 1
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=OUT_RTOL, atol=OUT_ATOL)
    if export == "mean":
        torch.testing.assert_close(probs, ref_probs, rtol=0, atol=PROBS_ATOL)
    else:
        assert probs is None


def test_attn_fwd_headmean_raises_on_what_it_does_not_take(device):
    qkv = torch.zeros((1, 5, 3 * H * D), device=device, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_attention_qkv_cols(qkv.float(), D ** -0.5, H)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention_qkv_cols(torch.zeros((1, 5, 6 * H * D), device=device,
                                             dtype=torch.bfloat16)[..., ::2], D ** -0.5, H)
    for d in (24, 144):        # not a multiple of 16; above 128
        with pytest.raises(ValueError, match=f"head dim .*got {d}"):
            fused_attention_qkv_cols(torch.zeros((1, 5, 3 * H * d), device=device,
                                                 dtype=torch.bfloat16), d ** -0.5, H)


# --- K1b, K2f, K2b --------------------------------------------------------
# Sums of |delta|: float32, another summation order -> rtol 1e-5. Sign tile:
# equal wherever |delta| of the plain version exceeds SIGN_EPS, above the
# float32 error of two 12-term head means of probabilities <= 1. dqkv:
# float32 arithmetic in another order, then one bf16 rounding on each side
# -> one bf16 ulp (2^-7 relative), plus 1e-4 of the tensor's largest value
# for entries that cancel to near zero (sums of up to N terms).
SUM_RTOL, SIGN_EPS = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL_FRAC = 2.0 ** -7, 1e-4


def _qkv(device, batch, n, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((batch, n, 3 * H * D), generator=gen, device=device).bfloat16()


def _assert_grad_close(got, ref):
    torch.testing.assert_close(got.float(), ref.float(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_FRAC * ref.float().abs().max().item())


@pytest.mark.parametrize("batch,n", [(8, 577), (2, 37), (2, 1)])
def test_attn_pair_fwd_matches_plain(device, batch, n):
    from acr_wsss_tpu_torch.ops.attn_pair import (pair_consistency_forward,
                                                  pair_consistency_forward_plain)

    qkv = _qkv(device, batch, n, seed=n + 1)
    before = pair_consistency_forward.launches
    out, cls_s, aff_s, sign = pair_consistency_forward(qkv, D ** -0.5, H)
    ref_out, ref_cls, ref_aff, ref_sign = pair_consistency_forward_plain(qkv, D ** -0.5, H)
    torch.cuda.synchronize()
    assert pair_consistency_forward.launches == before + 1
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=OUT_RTOL, atol=OUT_ATOL)
    torch.testing.assert_close(cls_s, ref_cls, rtol=SUM_RTOL, atol=1e-7)
    torch.testing.assert_close(aff_s, ref_aff, rtol=SUM_RTOL, atol=1e-7)
    _, probs = attention_qkv_cols_plain(qkv, D ** -0.5, H, "mean")
    clear = (probs[0::2] - probs[1::2]).abs() > SIGN_EPS
    assert torch.equal(sign[clear], ref_sign[clear])
    assert sign.dtype == torch.int8 and not sign[:, :, 0].any()


@pytest.mark.parametrize("batch,n", [(8, 577), (2, 37), (2, 17), (2, 1025)])
def test_attn_pair_bwd_matches_plain_with_the_kernels_sign(device, batch, n):
    from acr_wsss_tpu_torch.ops.attn_pair import (pair_consistency_backward,
                                                  pair_consistency_backward_plain,
                                                  pair_consistency_forward)

    qkv = _qkv(device, batch, n, seed=n + 2)
    gen = torch.Generator(device=device).manual_seed(n + 3)
    g = torch.randn((batch, n, H * D), generator=gen, device=device).bfloat16()
    g_cls = torch.rand(batch // 2, generator=gen, device=device) * 100
    g_aff = torch.rand(batch // 2, generator=gen, device=device) * 100
    _, _, _, sign = pair_consistency_forward(qkv, D ** -0.5, H)
    before = pair_consistency_backward.launches
    got = pair_consistency_backward(qkv, g, sign, g_cls, g_aff, D ** -0.5, H)
    ref = pair_consistency_backward_plain(qkv, g, sign, g_cls, g_aff, D ** -0.5, H)
    torch.cuda.synchronize()
    assert pair_consistency_backward.launches == before + 1
    _assert_grad_close(got, ref)


@pytest.mark.parametrize("with_de", [True, False])
@pytest.mark.parametrize("batch,n", [(8, 577), (2, 37), (1, 1), (2, 17), (1, 1025)])
def test_attn_bwd_dense_matches_plain(device, batch, n, with_de):
    from acr_wsss_tpu_torch.ops.attn_cuda import (attention_qkv_cols_backward,
                                                  attention_qkv_cols_backward_plain)

    qkv = _qkv(device, batch, n, seed=n + 4)
    gen = torch.Generator(device=device).manual_seed(n + 5)
    g = torch.randn((batch, n, H * D), generator=gen, device=device).bfloat16()
    de = torch.randn((batch, n, n), generator=gen, device=device) if with_de else None
    before = attention_qkv_cols_backward.launches
    got = attention_qkv_cols_backward(qkv, g, de, D ** -0.5, H)
    ref = attention_qkv_cols_backward_plain(qkv, g, de, D ** -0.5, H)
    torch.cuda.synchronize()
    assert attention_qkv_cols_backward.launches == before + 1
    _assert_grad_close(got, ref)


def test_attn_fwd_headmean_takes_a_gradient(device):
    from acr_wsss_tpu_torch.ops.attn_cuda import attention_qkv_cols_backward

    qkv = _qkv(device, 2, 37, seed=6).requires_grad_(True)
    before = attention_qkv_cols_backward.launches
    out, probs = fused_attention_qkv_cols(qkv, D ** -0.5, H, "mean")
    (out.float().sum() + probs.sum()).backward()
    torch.cuda.synchronize()
    assert qkv.grad is not None and torch.isfinite(qkv.grad.float()).all()
    assert attention_qkv_cols_backward.launches == before + 1


def test_backward_kernels_raise_on_what_they_do_not_take(device):
    from acr_wsss_tpu_torch.ops.attn_cuda import attention_qkv_cols_backward
    from acr_wsss_tpu_torch.ops.attn_pair import (pair_consistency_backward,
                                                  pair_consistency_forward)

    qkv = torch.zeros((2, 5, 3 * H * D), device=device, dtype=torch.bfloat16)
    g = torch.zeros((2, 5, H * D), device=device, dtype=torch.bfloat16)
    sign = torch.zeros((1, 5, 5), device=device, dtype=torch.int8)
    with pytest.raises(TypeError, match="bfloat16"):
        attention_qkv_cols_backward(qkv.float(), g, None, D ** -0.5, H)
    with pytest.raises(TypeError, match="bfloat16"):
        attention_qkv_cols_backward(qkv, g.float(), None, D ** -0.5, H)
    with pytest.raises(TypeError, match="float32"):
        attention_qkv_cols_backward(qkv, g, torch.zeros((2, 5, 5), device=device,
                                                        dtype=torch.float16), D ** -0.5, H)
    with pytest.raises(ValueError, match="head dim"):
        attention_qkv_cols_backward(qkv, g, None, D ** -0.5, 2 * H)
    with pytest.raises(ValueError, match="contiguous"):
        pair_consistency_forward(torch.zeros((2, 5, 6 * H * D), device=device,
                                             dtype=torch.bfloat16)[..., ::2], D ** -0.5, H)
    with pytest.raises(ValueError, match="even batch"):
        pair_consistency_forward(qkv[:1], D ** -0.5, H)
    with pytest.raises(TypeError, match="bfloat16"):
        pair_consistency_forward(qkv.float(), D ** -0.5, H)
    with pytest.raises(ValueError, match="head dim"):
        pair_consistency_forward(qkv, D ** -0.5, 2 * H)
    with pytest.raises(TypeError, match="int8"):
        pair_consistency_backward(qkv, g, sign.float(), None, None, D ** -0.5, H)


# --- bf16 export (K1f, K1b) and the other layouts (K5a, K5b, K5c) ---------
# bf16 export: the kernel and the plain version each round a float32 head
# mean once; the means agree within 1e-6, so the bf16 values within one
# bf16 ulp of the plain version's (2^-7 relative at most).
BF16_PROBS_RTOL = 2.0 ** -7


@pytest.mark.parametrize("batch,n", [(8, 577), (2, 37), (1, 1)])
def test_k1_bf16_export_and_bf16_de_match_plain(device, batch, n):
    from acr_wsss_tpu_torch.ops.attn_cuda import (attention_qkv_cols_backward,
                                                  attention_qkv_cols_backward_plain)

    qkv = _qkv(device, batch, n, seed=n + 7)
    out, probs = fused_attention_qkv_cols(qkv, D ** -0.5, H, "mean", torch.bfloat16)
    ref_out, ref_probs = attention_qkv_cols_plain(qkv, D ** -0.5, H, "mean", torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(n + 8)
    g = torch.randn((batch, n, H * D), generator=gen, device=device).bfloat16()
    de = torch.randn((batch, n, n), generator=gen, device=device).bfloat16()
    got = attention_qkv_cols_backward(qkv, g, de, D ** -0.5, H)
    ref = attention_qkv_cols_backward_plain(qkv, g, de, D ** -0.5, H)
    torch.cuda.synchronize()
    assert probs.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=OUT_RTOL, atol=OUT_ATOL)
    torch.testing.assert_close(probs.float(), ref_probs.float(), rtol=BF16_PROBS_RTOL, atol=1e-6)
    _assert_grad_close(got, ref)


def _entry_inputs(device, entry, batch, n, seed):
    """bf16 inputs of the entry's layout, as views of one (B, N, 3*H*D)
    projection where the layout allows it (K5a: the permute views the
    model's plain branch makes)."""
    qkv = _qkv(device, batch, n, seed)
    if entry == "K5a":
        return list(qkv.unflatten(-1, (3, H, D)).permute(2, 0, 3, 1, 4))
    if entry == "K5b":
        return [t.contiguous() for t in qkv.chunk(3, dim=-1)]
    return [qkv]


def _entry(entry):
    from acr_wsss_tpu_torch.ops import attn_cuda

    return {"K5a": attn_cuda.fused_attention_with_probs, "K5b": attn_cuda.fused_attention_nhd,
            "K5c": attn_cuda.fused_attention_qkv}[entry]


def _layout(entry):
    return {"K5a": "bhnd", "K5b": "nhd", "K5c": "cols"}[entry]


def _call(entry, xs, export="mean", probs_dtype=torch.float32):
    if entry == "K5a":
        return _entry(entry)(*xs, D ** -0.5, export=export)
    return _entry(entry)(*xs, D ** -0.5, H, export, probs_dtype)


@pytest.mark.parametrize("de_dtype", ["probs", None])
@pytest.mark.parametrize("entry,probs_dtype", [
    ("K5a", torch.float32), ("K5b", torch.float32), ("K5b", torch.bfloat16),
    ("K5c", torch.float32), ("K5c", torch.bfloat16)])
@pytest.mark.parametrize("batch,n", [(8, 577), (2, 37), (1, 1), (2, 17), (1, 1025)])
def test_attention_entries_match_plain(device, entry, probs_dtype, de_dtype, batch, n):
    """de_dtype "probs": the cotangent of the export, in its dtype."""
    from acr_wsss_tpu_torch.ops import attn_cuda

    layout = _layout(entry)
    xs = _entry_inputs(device, entry, batch, n, seed=n + 9)
    gen = torch.Generator(device=device).manual_seed(n + 10)
    fn = _entry(entry)
    before = (fn.launches, fn.launches_noexport, fn.backward_launches)
    out, probs = _call(entry, xs, "mean", probs_dtype)
    out_none, probs_none = _call(entry, xs, "none", probs_dtype)
    ref_out, ref_probs = attn_cuda.forward_plain(layout, xs, D ** -0.5, H, "mean", probs_dtype)
    g = torch.randn(out.shape, generator=gen, device=device).bfloat16()
    de = None if de_dtype is None else torch.randn((batch, n, n), generator=gen,
                                                   device=device).to(probs_dtype)
    grads = attn_cuda.backward(layout, xs, g, de, D ** -0.5, H, fn)
    refs = attn_cuda.backward_plain(layout, xs, g, de, D ** -0.5, H)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_noexport, fn.backward_launches) == (
        before[0] + 2, before[1] + 1, before[2] + 1)
    assert out.shape == ref_out.shape and probs.dtype == probs_dtype and probs_none is None
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=OUT_RTOL, atol=OUT_ATOL)
    assert torch.equal(out_none, out)
    if probs_dtype == torch.float32:
        torch.testing.assert_close(probs, ref_probs, rtol=0, atol=PROBS_ATOL)
    else:
        torch.testing.assert_close(probs.float(), ref_probs.float(), rtol=BF16_PROBS_RTOL,
                                   atol=1e-6)
    for got, ref in zip(grads, refs):
        assert got.shape == ref.shape
        _assert_grad_close(got, ref)


@pytest.mark.parametrize("entry", ["K5a", "K5b", "K5c"])
def test_attention_entries_take_a_gradient(device, entry):
    xs = [t.detach().requires_grad_(True) for t in _entry_inputs(device, entry, 2, 37, 11)]
    fn = _entry(entry)
    before = (fn.launches, fn.backward_launches)
    out, probs = _call(entry, xs)
    (out.float().sum() + (probs * torch.arange(37, device=device)).sum()).backward()
    torch.cuda.synchronize()
    assert (fn.launches, fn.backward_launches) == (before[0] + 1, before[1] + 1)
    assert all(t.grad is not None and torch.isfinite(t.grad.float()).all() for t in xs)


@pytest.mark.parametrize("entry", ["K5a", "K5b", "K5c"])
def test_attention_entries_raise_on_what_they_do_not_take(device, entry):
    xs = _entry_inputs(device, entry, 2, 37, 12)
    with pytest.raises(TypeError, match="bfloat16"):
        _call(entry, [t.float() for t in xs])
    with pytest.raises(ValueError, match="unit stride"):
        _call(entry, [torch.cat([t, t], dim=-1)[..., ::2] for t in xs])
    with pytest.raises(ValueError, match="16-byte"):   # rows start 2 bytes off
        _call(entry, [torch.cat([t, t], dim=-1)[..., 1:t.shape[-1] + 1] for t in xs])


# --- the tensor-core forward and backward: more tokens than the
# shared-memory limit of the earlier kernels (about 3.4k), and the same
# bits from run to run ----------------------------------------------------

def test_attention_kernels_take_more_tokens_than_the_old_limit(device):
    from acr_wsss_tpu_torch.ops.attn_cuda import (attention_qkv_cols_backward,
                                                  attention_qkv_cols_backward_plain)

    n = 4001
    qkv = _qkv(device, 1, n, seed=16)
    gen = torch.Generator(device=device).manual_seed(17)
    g = torch.randn((1, n, H * D), generator=gen, device=device).bfloat16()
    de = torch.randn((1, n, n), generator=gen, device=device)
    out, probs = fused_attention_qkv_cols(qkv, D ** -0.5, H, "mean")
    ref_out, ref_probs = attention_qkv_cols_plain(qkv, D ** -0.5, H, "mean")
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=OUT_RTOL, atol=OUT_ATOL)
    torch.testing.assert_close(probs, ref_probs, rtol=0, atol=PROBS_ATOL)
    del probs, ref_probs
    got = attention_qkv_cols_backward(qkv, g, de, D ** -0.5, H)
    ref = attention_qkv_cols_backward_plain(qkv, g, de, D ** -0.5, H)
    torch.cuda.synchronize()
    _assert_grad_close(got, ref)


@pytest.mark.parametrize("entry", ["K5a", "K5b", "K5c"])
def test_attention_kernels_give_the_same_bits_twice(device, entry):
    from acr_wsss_tpu_torch.ops import attn_cuda

    layout = _layout(entry)
    xs = _entry_inputs(device, entry, 2, 577, seed=18)
    gen = torch.Generator(device=device).manual_seed(19)
    fn = _entry(entry)
    for export, probs_dtype in (("mean", torch.float32), ("mean", torch.bfloat16),
                                ("none", torch.float32)):
        first, second = (attn_cuda.forward(layout, xs, D ** -0.5, H, export, probs_dtype, fn)
                         for _ in range(2))
        assert torch.equal(first[0], second[0])
        assert (first[1] is None and second[1] is None) or torch.equal(first[1], second[1])
    g = torch.randn(first[0].shape, generator=gen, device=device).bfloat16()
    for de_dtype in (None, torch.float32, torch.bfloat16):
        de = None if de_dtype is None else torch.randn((2, 577, 577), generator=gen,
                                                       device=device).to(de_dtype)
        first, second = (attn_cuda.backward(layout, xs, g, de, D ** -0.5, H, fn)
                         for _ in range(2))
        assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_pair_forward_takes_more_tokens_than_the_old_limit(device):
    """K2f at one pair of N = 4001 tokens: the earlier pair kernel held
    N-wide rows in shared memory and stopped at about 3.4k."""
    from acr_wsss_tpu_torch.ops.attn_pair import (pair_consistency_forward,
                                                  pair_consistency_forward_plain)

    qkv = _qkv(device, 2, 4001, seed=22)
    out, cls_s, aff_s, sign = pair_consistency_forward(qkv, D ** -0.5, H)
    ref_out, ref_cls, ref_aff, ref_sign = pair_consistency_forward_plain(qkv, D ** -0.5, H)
    _, probs = attention_qkv_cols_plain(qkv, D ** -0.5, H, "mean")
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=OUT_RTOL, atol=OUT_ATOL)
    torch.testing.assert_close(cls_s, ref_cls, rtol=SUM_RTOL, atol=1e-7)
    torch.testing.assert_close(aff_s, ref_aff, rtol=SUM_RTOL, atol=1e-7)
    clear = (probs[0::2] - probs[1::2]).abs() > SIGN_EPS
    assert torch.equal(sign[clear], ref_sign[clear])


def test_pair_forward_gives_the_same_bits_twice(device):
    from acr_wsss_tpu_torch.ops.attn_pair import pair_consistency_forward

    qkv = _qkv(device, 8, 577, seed=23)
    first, second = (pair_consistency_forward(qkv, D ** -0.5, H) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_pair_backward_gives_the_same_bits_twice(device):
    from acr_wsss_tpu_torch.ops.attn_pair import (pair_consistency_backward,
                                                  pair_consistency_forward)

    qkv = _qkv(device, 8, 577, seed=20)
    gen = torch.Generator(device=device).manual_seed(21)
    g = torch.randn((8, 577, H * D), generator=gen, device=device).bfloat16()
    g_cls, g_aff = (torch.rand(4, generator=gen, device=device) * 100 for _ in range(2))
    sign = pair_consistency_forward(qkv, D ** -0.5, H)[3]
    first, second = (pair_consistency_backward(qkv, g, sign, g_cls, g_aff, D ** -0.5, H)
                     for _ in range(2))
    assert torch.equal(first, second)


# --- K3, K4 ---------------------------------------------------------------
# float32 on both sides with the taps and neighbours summed in the same
# order; the softmax's sum and the scalar divisions may round otherwise ->
# JAX's own Pallas-against-XLA tolerance (tests/test_pamr.py).
PAMR_RTOL, PAMR_ATOL = 2e-5, 2e-6
PRODUCTION = (1, 2, 4, 8, 12, 24)


@pytest.mark.parametrize("batch,k,h,w,dilations", [
    (2, 3, 384, 384, PRODUCTION), (8, 3, 384, 384, PRODUCTION), (2, 3, 37, 29, (1, 2)),
    (1, 3, 17, 13, (1, 24)), (1, 1, 5, 300, tuple(range(1, 9))), (1, 3, 70, 90, (1, 40)),
])
def test_pamr_kernels_match_plain(device, batch, k, h, w, dilations):
    from acr_wsss_tpu_torch.ops import pamr

    gen = torch.Generator(device=device).manual_seed(h * w)
    x = torch.randn((batch, k, h, w), generator=gen, device=device)
    m = torch.rand((batch, 20, h, w), generator=gen, device=device)
    before = (pamr.pamr_affinity.launches, pamr.pamr_update.launches)
    aff = pamr.pamr_affinity(x, dilations)
    out = pamr.pamr_update(m, aff, dilations, num_iter=10)
    ref_aff = pamr.pamr_affinity_plain(x, dilations)
    ref = m
    for _ in range(10):
        ref = pamr.pamr_update_plain(ref, aff, dilations)
    torch.cuda.synchronize()
    assert (pamr.pamr_affinity.launches, pamr.pamr_update.launches) == (
        before[0] + 1, before[1] + 10)
    torch.testing.assert_close(aff, ref_aff, rtol=PAMR_RTOL, atol=PAMR_ATOL)
    torch.testing.assert_close(out, ref, rtol=PAMR_RTOL, atol=PAMR_ATOL)
    torch.testing.assert_close(pamr.pamr(x, m[:, :, ::4, ::4], 3, dilations),
                               pamr.pamr_plain(x, m[:, :, ::4, ::4], 3, dilations),
                               rtol=PAMR_RTOL, atol=PAMR_ATOL)


def test_pamr_update_on_an_odd_shape(device):
    """K4 at 3 images of 21 channels and 65x131 pixels, whose last block of
    128 pixels is partial and whose rows start inside a block."""
    from acr_wsss_tpu_torch.ops import pamr

    gen = torch.Generator(device=device).manual_seed(24)
    x = torch.randn((3, 3, 65, 131), generator=gen, device=device)
    m = torch.rand((3, 21, 65, 131), generator=gen, device=device)
    aff = pamr.pamr_affinity(x, PRODUCTION)
    out = pamr.pamr_update(m, aff, PRODUCTION, num_iter=10)
    ref = m
    for _ in range(10):
        ref = pamr.pamr_update_plain(ref, aff, PRODUCTION)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=PAMR_RTOL, atol=PAMR_ATOL)
    assert pamr.update_blocks_per_sm(PRODUCTION) > 1
    assert pamr.affinity_blocks_per_sm(PRODUCTION) > 1
    assert pamr.affinity_route(PRODUCTION) == "tile"
    assert pamr.affinity_route((1, 40)) == "gather"


def test_pamr_kernels_give_the_same_bits_twice(device):
    """K3 through either of its kernels and K4 chained: no atomics, sums
    in a fixed order."""
    from acr_wsss_tpu_torch.ops import pamr

    gen = torch.Generator(device=device).manual_seed(25)
    x = torch.randn((2, 3, 70, 90), generator=gen, device=device)
    m = torch.rand((2, 20, 70, 90), generator=gen, device=device)
    for dilations in (PRODUCTION, (1, 40)):
        assert torch.equal(pamr.pamr_affinity(x, dilations), pamr.pamr_affinity(x, dilations))
    aff = pamr.pamr_affinity(x, PRODUCTION)
    assert torch.equal(pamr.pamr_update(m, aff, PRODUCTION, num_iter=10),
                       pamr.pamr_update(m, aff, PRODUCTION, num_iter=10))


def test_pamr_flat_guidance_on_the_card(device):
    from acr_wsss_tpu_torch.ops import pamr

    aff = pamr.pamr_affinity(torch.full((1, 3, 40, 50), 0.5, device=device), PRODUCTION)
    torch.cuda.synchronize()
    assert torch.isfinite(aff).all()
    torch.testing.assert_close(aff, torch.full_like(aff, 1.0 / 48), rtol=1e-6, atol=0)


def test_pamr_kernels_raise_on_what_they_do_not_take(device):
    from acr_wsss_tpu_torch.ops import pamr

    x = torch.zeros((1, 3, 16, 16), device=device)
    m = torch.zeros((1, 4, 16, 16), device=device)
    aff = pamr.pamr_affinity(x, (1,))
    with pytest.raises(TypeError, match="float32"):
        pamr.pamr_affinity(x.double(), (1,))
    with pytest.raises(ValueError, match="contiguous"):
        pamr.pamr_affinity(torch.zeros((1, 3, 16, 32), device=device)[..., ::2], (1,))
    with pytest.raises(ValueError, match="1 to 8 dilations"):
        pamr.pamr_affinity(x, tuple(range(1, 10)))
    with pytest.raises(TypeError, match="float32"):
        pamr.pamr_update(m.half(), aff, (1,))
    with pytest.raises(ValueError, match="contiguous"):
        pamr.pamr_update(m.transpose(2, 3), aff, (1,))
    with pytest.raises(ValueError, match="aff must be"):
        pamr.pamr_update(m, aff, (1, 2))
    with pytest.raises(ValueError, match="1 to 8 dilations"):
        pamr.pamr_update(m, aff, tuple(range(1, 10)))


@pytest.mark.parametrize("crop,pad", [(384, 512), (384, 640)])
def test_device_augment_on_the_card_matches_the_cpu(device, crop, pad):
    """Not a kernel: the torch gather of ``data/device_aug.py``, float32 on
    both devices, within 1e-5 (the tolerance against JAX's on the CPU)."""
    import numpy as np

    from acr_wsss_tpu_torch.data import device_aug, transforms

    rng = np.random.default_rng(pad)
    images, vecs = [], []
    for i, (h, w) in enumerate(((375, 500), (500, 375), (333, 500), (pad, pad - 3))):
        img = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
        params = transforms.train_aug_params((h, w), crop, np.random.default_rng(i))
        padded, vec = device_aug.pack_example(img, params, pad)
        images.append(padded)
        vecs.append(vec)
    images, vecs = torch.from_numpy(np.stack(images)), torch.from_numpy(np.stack(vecs))
    ref = device_aug.device_augment(images, vecs, crop)
    got = device_aug.device_augment(images.to(device), vecs.to(device), crop)
    assert got.device.type == "cuda" and got.shape == (4, crop, crop, 3)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("tf32", [False, True])
def test_crf_on_the_card_matches_the_cpu(device, tf32):
    """Not a kernel: ``crf_inference_torch`` (plain torch) on the card
    against its CPU run at 64x96, 5 labels, t=10, the bound of
    ``tests/test_torch_crf.py`` against JAX (5e-5: float32 in another
    order, atomic sums), argmax agreement >= 0.999 (near-ties of uniform
    scores); also with the TF32 switches on, which would miss the bound if
    a product ran in TF32."""
    import numpy as np

    from acr_wsss_tpu_torch.ops.crf import crf_inference_torch

    rng = np.random.default_rng(64)
    img = rng.uniform(0, 255, (64, 96, 3)).astype(np.float32)
    probs = rng.uniform(0.01, 1, (5, 64, 96)).astype(np.float32)
    probs /= probs.sum(0, keepdims=True)
    ref = crf_inference_torch(img, probs, t=10, sxy_b=20.0, device="cpu")
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        got = crf_inference_torch(img, probs, t=10, sxy_b=20.0, device=device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=5e-5)
    assert (got.cpu().argmax(0) == ref.argmax(0)).float().mean() >= 0.999


def test_dpt_seg_step_on_the_kernels_matches_the_plain_path(device):
    """One seg step (``train_seg.make_seg_train_step``) of the bf16 DPT
    model (vitb_hybrid, crop 64, batch 2) with K1n and K1b (no de) in each
    block under autograd, against the same step on the plain path from the
    same weights and batch: the step gates of ``chip_smoke.py`` (loss parts
    2e-2 relative, each parameter's update 5e-2 in L2), 12 launches of each
    kernel and no other; a float32 model on the kernel path raises."""
    import numpy as np

    from acr_wsss_tpu_torch.models.acr import init_random_
    from acr_wsss_tpu_torch.models.dpt import DPTSegmentationModel
    from acr_wsss_tpu_torch.ops.attn_cuda import attention_qkv_cols_backward
    from acr_wsss_tpu_torch.train_seg import make_seg_train_step
    from acr_wsss_tpu_torch.utils.schedule import make_optimizer

    weights = init_random_(DPTSegmentationModel(backbone_name="vitb_hybrid"), 1).state_dict()
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
             "seg_label": rng.integers(0, 3, size=(2, 64, 64)).astype(np.int32)}

    def step(attn_impl):
        model = DPTSegmentationModel(backbone_name="vitb_hybrid", dtype=torch.bfloat16,
                                     attn_impl=attn_impl)
        model.load_state_dict(weights)
        model.to(device)
        before = {k: v.detach().clone() for k, v in model.named_parameters()}
        parts = make_seg_train_step(model, make_optimizer(model.parameters(), 1e-4, 4))(batch)
        return {k: float(v) for k, v in parts.items()}, before, dict(model.named_parameters())

    ref_parts, p0, ref_p1 = step("plain")
    counts = (fused_attention_qkv_cols.launches, fused_attention_qkv_cols.launches_noexport,
              attention_qkv_cols_backward.launches, attention_qkv_cols_backward.launches_no_de)
    parts, _, p1 = step("kernel")
    torch.cuda.synchronize()
    after = (fused_attention_qkv_cols.launches, fused_attention_qkv_cols.launches_noexport,
             attention_qkv_cols_backward.launches, attention_qkv_cols_backward.launches_no_de)
    assert [a - b for a, b in zip(after, counts)] == [12, 12, 12, 12]
    for k, ref in ref_parts.items():
        assert abs(parts[k] - ref) <= 2e-2 * abs(ref), (k, parts[k], ref)
    for k, ref in ref_p1.items():
        ref_u = ref.detach() - p0[k]
        rel = float((p1[k].detach() - p0[k] - ref_u).norm() / ref_u.norm().clamp_min(1e-30))
        assert rel <= 5e-2, (k, rel)

    model = DPTSegmentationModel(backbone_name="vitb_hybrid", attn_impl="kernel").to(device)
    with pytest.raises(TypeError, match="bfloat16"):
        model(torch.zeros((1, 64, 64, 3), device=device), export="none")


# --- the serving export -----------------------------------------------------

@pytest.mark.parametrize("embed", [False, True], ids=["params", "embedded"])
def test_serving_artifact_on_the_card_matches_the_live_plain_path(device, tmp_path, embed):
    """The artifact exported on the card (vit_small, crop 64, bf16, 4
    slots), with the parameters as an input or embedded, saved, loaded and
    called on other images and ids: the live plain path's outputs to 1e-5."""
    from acr_wsss_tpu_torch import serving
    from acr_wsss_tpu_torch.infer_cam import build_infer_fn
    from acr_wsss_tpu_torch.models.acr import ACR, init_random_

    model = init_random_(ACR(backbone_name="vit_small", attn_impl="plain"), seed=3).to(device)
    path = str(tmp_path / "cam.pt2")
    serving.save_exported(path, serving.export_infer(model, 64, 2, class_slots=4,
                                                     embed_weights=embed))
    x = torch.randn((2, 64, 64, 3), device=device)
    ids = torch.tensor([6, 1, 13, 2], device=device)
    args = (x, ids) if embed else (dict(model.state_dict()), x, ids)
    out = serving.load_exported(path)(*args)
    live = build_infer_fn(model, 64, 10, "grad", True, 20, class_slots=4)(x, ids)
    for k in live:
        assert out[k].device.type == "cuda"
        torch.testing.assert_close(out[k], live[k], rtol=0, atol=1e-5)


# --- data parallelism -------------------------------------------------------

@pytest.mark.parametrize("fsdp", [False, True], ids=["ddp", "fsdp"])
def test_data_parallel_step_at_world_size_1_matches_one_device(device, tmp_path, fsdp):
    """One fused train step (vit_small, crop 64, batch 2, bf16, K2f and K2b
    in each of the 12 blocks) wrapped in DDP or sharded by FSDP2 over a
    world-size-1 NCCL group (a ``file://`` store), against the same step on
    one device from the same weights and batch: the step gates of
    ``chip_smoke.py`` and 12 launches of each kernel per step."""
    import numpy as np

    from acr_wsss_tpu_torch import train as train_mod
    from acr_wsss_tpu_torch.configs import ModelConfig, TrainConfig
    from acr_wsss_tpu_torch.models.acr import init_random_
    from acr_wsss_tpu_torch.ops.attn_pair import (pair_consistency_backward,
                                                  pair_consistency_forward)
    from acr_wsss_tpu_torch.parallel import distributed
    from acr_wsss_tpu_torch.parallel.mesh import make_data_mesh_for_batch
    from acr_wsss_tpu_torch.parallel.sharding import full_tensors, shard_like, unwrap

    cfg = TrainConfig(model=ModelConfig(backbone="vit_small"), crop_size=64, batch_size=2,
                      fsdp=fsdp, device="cuda:0")
    weights = init_random_(train_mod.build_model(cfg.model), seed=2).state_dict()
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
             "label": (rng.uniform(size=(2, 20)) > 0.7).astype(np.float32)}

    def step(mesh):
        model, opt = train_mod.create_train_state(cfg, 4, init=False, mesh=mesh)
        base = unwrap(model)
        current = base.state_dict()
        base.load_state_dict({k: shard_like(v.to(device), current[k]) for k, v in weights.items()})
        counts = (pair_consistency_forward.launches, pair_consistency_backward.launches)
        parts = train_mod.make_train_step(model, opt, cfg, (4, 4), mesh)(batch)
        torch.cuda.synchronize()
        launches = (pair_consistency_forward.launches - counts[0],
                    pair_consistency_backward.launches - counts[1])
        return ({k: float(v) for k, v in parts.items()}, full_tensors(base.state_dict()),
                launches)

    ref_parts, ref_p1, ref_launches = step(None)
    assert ref_launches == (12, 12)
    distributed.initialize("cuda:0", init_method=f"file://{tmp_path}/store", rank=0,
                           world_size=1)
    try:
        parts, p1, launches = step(make_data_mesh_for_batch(cfg.batch_size, "cuda"))
    finally:
        distributed.shutdown()
    assert launches == (12, 12)
    for k, ref in ref_parts.items():
        assert abs(parts[k] - ref) <= 2e-2 * abs(ref), (k, parts[k], ref)
    for k, ref in ref_p1.items():
        ref_u = ref - weights[k].to(device)
        rel = float((p1[k] - weights[k].to(device) - ref_u).norm()
                    / ref_u.norm().clamp_min(1e-30))
        assert rel <= 5e-2, (k, rel)


# --- Swin and PiT -----------------------------------------------------------

@pytest.mark.parametrize("n,heads", [(962, 4), (257, 8), (65, 16)])
def test_attn_fwd_headmean_at_the_pit_b_shapes(device, n, heads):
    """K1f at pit_b's three stages (crop 224, B=2): N = 962, 257, 65 tokens
    with 4, 8, 16 heads of dim 64, against its plain version."""
    gen = torch.Generator(device=device).manual_seed(n)
    qkv = torch.randn((2, n, 3 * heads * D), generator=gen, device=device).bfloat16()
    before = fused_attention_qkv_cols.launches
    out, probs = fused_attention_qkv_cols(qkv, D ** -0.5, heads, "mean")
    ref_out, ref_probs = attention_qkv_cols_plain(qkv, D ** -0.5, heads, "mean")
    torch.cuda.synchronize()
    assert fused_attention_qkv_cols.launches == before + 1
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=OUT_RTOL, atol=OUT_ATOL)
    torch.testing.assert_close(probs, ref_probs, rtol=0, atol=PROBS_ATOL)


def test_pit_b_forward_launches_k1f_per_block_and_pit_s_refuses_the_kernel(device):
    """pit_b (bf16, crop 224, batch 2, export "mean") on the kernel path: 13
    K1f launches per forward, the same bits from two forwards, every export
    finite; a PiT at head dim 24, outside the kernel's range, raises at
    construction, no fallback (pit_s, head dim 48, takes the kernel)."""
    from acr_wsss_tpu_torch.models.acr import init_random_
    from acr_wsss_tpu_torch.models.registry import create_model

    model = init_random_(create_model("pit_b", num_classes=20), seed=0).to(device)
    x = torch.randn((2, 224, 224, 3), device=device)
    outs = []
    for _ in range(2):
        before = fused_attention_qkv_cols.launches
        with torch.no_grad():
            outs.append(model(x))
        torch.cuda.synchronize()
        assert fused_attention_qkv_cols.launches == before + 13
    for a, b in zip(outs[0]["probs_per_block"] + [outs[0]["logits"]],
                    outs[1]["probs_per_block"] + [outs[1]["logits"]]):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    with pytest.raises(ValueError, match="head dim .*got 24"):
        create_model("pit_s_224", num_classes=20, base_dims=(24, 24, 24))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swin_step_gives_the_same_bits_twice(device, dtype):
    """One ``train_swin`` step (a small Swin: width 32, window 4, crop 64,
    batch 2, TF32 off) from the same weights and batch, twice: the same
    bits in every loss part and every parameter after the update (the bias
    table's backward sums in a fixed order)."""
    import numpy as np

    from acr_wsss_tpu_torch.configs import TrainConfig
    from acr_wsss_tpu_torch.models.acr import init_random_
    from acr_wsss_tpu_torch.models.swin import SwinTransformer
    from acr_wsss_tpu_torch.train_swin import make_swin_train_step
    from acr_wsss_tpu_torch.utils.schedule import make_optimizer

    kw = dict(embed_dim=32, depths=(2, 2), num_heads=(2, 4), window_size=4, img_size=64)
    weights = init_random_(SwinTransformer(**kw), seed=1).state_dict()
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
             "label": (rng.uniform(size=(2, 20)) > 0.7).astype(np.float32)}
    cfg = TrainConfig(crop_size=64, batch_size=2, device="cuda")
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        runs = []
        for _ in range(2):
            model = SwinTransformer(**kw, dtype=dtype)
            model.load_state_dict(weights)
            model.to(device)
            opt = make_optimizer(model.parameters(), cfg.lr, 4)
            parts = make_swin_train_step(model, opt, cfg, 64, device)(batch)
            runs.append((parts, {k: v.detach().clone() for k, v in model.state_dict().items()}))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    (parts_a, params_a), (parts_b, params_b) = runs
    for k in parts_a:
        assert torch.isfinite(parts_a[k]) and torch.equal(parts_a[k], parts_b[k]), k
    for k in params_a:
        assert torch.equal(params_a[k], params_b[k]), k


# --- head dims other than 64 (K1f, K1n), the ViT classifiers ----------------

@pytest.mark.parametrize("export", ["mean", "mean_bf16", "none"])
@pytest.mark.parametrize("batch,n", [(2, 197), (3, 37), (2, 65), (1, 1)])
@pytest.mark.parametrize("d", [16, 32, 48, 80, 96, 112, 128])
def test_attn_fwd_headmean_at_other_head_dims(device, d, batch, n, export):
    """K1f (float32 and bf16 export) and K1n at every other head dim the
    forward takes, against the plain version: the tolerances of D = 64."""
    gen = torch.Generator(device=device).manual_seed(d * n)
    heads = 4
    qkv = torch.randn((batch, n, 3 * heads * d), generator=gen, device=device).bfloat16()
    mode, dtype = export[:4], torch.bfloat16 if export.endswith("bf16") else torch.float32
    before = fused_attention_qkv_cols.launches
    out, probs = fused_attention_qkv_cols(qkv, d ** -0.5, heads, mode, dtype)
    ref_out, ref_probs = attention_qkv_cols_plain(qkv, d ** -0.5, heads, mode, dtype)
    again = fused_attention_qkv_cols(qkv, d ** -0.5, heads, mode, dtype)
    torch.cuda.synchronize()
    assert fused_attention_qkv_cols.launches == before + 2
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=OUT_RTOL, atol=OUT_ATOL)
    assert torch.equal(out, again[0])
    if mode == "none":
        assert probs is None
        return
    assert probs.dtype == dtype and torch.equal(probs, again[1])
    torch.testing.assert_close(probs.float(), ref_probs.float(),
                               rtol=BF16_PROBS_RTOL if dtype == torch.bfloat16 else 0,
                               atol=PROBS_ATOL)


def test_k5a_forward_at_head_dim_96(device):
    """The (B, H, N, D) layout's forward at head dim 96; its backward takes
    64 only, so a forward that asks for a gradient raises before it runs."""
    from acr_wsss_tpu_torch.ops.attn_cuda import forward_plain, fused_attention_with_probs

    gen = torch.Generator(device=device).manual_seed(96)
    q, k, v = (torch.randn((2, 4, 37, 96), generator=gen, device=device).bfloat16()
               for _ in range(3))
    out, probs = fused_attention_with_probs(q, k, v, 96 ** -0.5)
    ref_out, ref_probs = forward_plain("bhnd", (q, k, v), 96 ** -0.5, None)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=OUT_RTOL, atol=OUT_ATOL)
    torch.testing.assert_close(probs, ref_probs, rtol=0, atol=PROBS_ATOL)
    q.requires_grad_(True)
    before = fused_attention_with_probs.launches
    with pytest.raises(ValueError, match="head dim 64, got 96"):
        fused_attention_with_probs(q, k, v, 96 ** -0.5)
    assert fused_attention_with_probs.launches == before


@pytest.mark.parametrize("name,heads,head_dim", [
    ("vit_small_patch16_224", 8, 96), ("vit_huge_patch14_224_in21k", 16, 80),
    ("vit_deit_base_distilled_patch16_224", 12, 64)])
def test_vit_classifier_on_k1n_matches_the_plain_path(device, name, heads, head_dim):
    """Two blocks of a classifier at its published width (bf16, crop 224,
    batch 2): one K1n launch per block, the same bits twice, logits within
    5e-2 of the largest |logit| of the plain path's (``chip_smoke.py``)."""
    from acr_wsss_tpu_torch.models.acr import init_random_
    from acr_wsss_tpu_torch.models.registry import create_model

    weights = init_random_(create_model(name, depth=2), seed=0).state_dict()
    models = {}
    for impl in ("kernel", "plain"):
        models[impl] = create_model(name, depth=2, attn_impl=impl)
        models[impl].load_state_dict(weights)
        models[impl].to(device)
    x = torch.randn((2, 224, 224, 3), generator=torch.Generator(device=device).manual_seed(0),
                    device=device)
    before = fused_attention_qkv_cols.launches_noexport
    with torch.no_grad():
        out, again, ref = models["kernel"](x), models["kernel"](x), models["plain"](x)
    torch.cuda.synchronize()
    assert fused_attention_qkv_cols.launches_noexport == before + 4
    assert models["kernel"].trunk.blocks[0].attn.scale == head_dim ** -0.5
    assert torch.equal(out["logits"], again["logits"])
    scale = ref["logits"].abs().max().item()
    torch.testing.assert_close(out["logits"], ref["logits"], rtol=0, atol=5e-2 * scale)


@pytest.mark.parametrize("name", ["pit_s_224", "pit_xs_224", "pit_ti_224"])
def test_pit_at_head_dims_48_and_32_on_k1f(device, name):
    """13 K1f launches per forward at head dim 48 or 32; the logits within
    5e-2 of the largest |logit| of the plain path's."""
    from acr_wsss_tpu_torch.models.acr import init_random_
    from acr_wsss_tpu_torch.models.registry import create_model

    weights = init_random_(create_model(name, num_classes=20), seed=0).state_dict()
    models = {}
    for impl in ("kernel", "plain"):
        models[impl] = create_model(name, num_classes=20, attn_impl=impl)
        models[impl].load_state_dict(weights)
        models[impl].to(device)
    x = torch.randn((2, 224, 224, 3), device=device)
    before = fused_attention_qkv_cols.launches
    with torch.no_grad():
        out, ref = models["kernel"](x), models["plain"](x)
    torch.cuda.synchronize()
    assert fused_attention_qkv_cols.launches == before + 12
    scale = ref["logits"].abs().max().item()
    torch.testing.assert_close(out["logits"], ref["logits"], rtol=0, atol=5e-2 * scale)


def test_vit_classifier_at_head_dim_96_refuses_a_gradient_at_the_forward(device):
    """vit_small_patch16_224 (head dim 96) on the kernels: a forward under
    no_grad runs; one that asks for a gradient raises at its first block,
    naming the head dim and the backward's, before any launch."""
    from acr_wsss_tpu_torch.models.registry import create_model

    with torch.device(device):
        model = create_model("vit_small_patch16_224", depth=1)
    x = torch.randn((1, 224, 224, 3), device=device)
    with torch.no_grad():
        assert torch.isfinite(model(x)["logits"]).all()
    before = fused_attention_qkv_cols.launches
    with pytest.raises(ValueError, match="head dim 64, got 96.*attn_impl='plain'"):
        model(x)
    assert fused_attention_qkv_cols.launches == before
