"""The operand roundings of the tensor-core attention kernels, emulated on
the CPU and held to the gates that ``chip_smoke.py`` holds the kernels to.

``csrc/attn_fwd_headmean.cu`` and ``csrc/attn_bwd.cu`` feed the tensor
cores bf16 operands and sum in fp32. q, k, v and g are bf16 already, so
the logits and g v^T are exact products. p and ds are fp32: the forward
rounds p to bf16 before p @ v, as the JAX package and the plain twin do;
the backward splits p (for p^T g) and ds (for ds k and ds^T q) into two
bf16 parts, hi = bf16(x) and lo = bf16(x - hi). Both kernels take the
softmax in two sweeps over tiles of 64 keys (the row max and the sum of
exponentials kept online, rescaled when the max grows), p = exp(s - max)
* (1 / sum), with exp as 2^(x log2 e).

Here those steps run in float32 torch at the production shape of one head
(N = 577, D = 64) on seeded numpy inputs, against the plain twins of
``ops/attn_cuda.py`` in float32. The backward with a single bf16 part for
p and ds misses the gradient gate; that is why the kernel splits them.
"""

import numpy as np
import pytest
import torch

from acr_wsss_tpu_torch.ops.attn_cuda import backward_plain, forward_plain

N, D, HEADS = 577, 64, 12
SCALE = D ** -0.5
TILE = 64
LOG2E = 1.4426950408889634
# The gates of chip_smoke.py, with the reasons given there.
PROBS_ATOL = 1e-6
OUT_RTOL, OUT_ATOL = 2.0 ** -7, 2.0 ** -8
GRAD_RTOL, GRAD_ATOL_FRAC = 2.0 ** -7, 1e-4


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [_bf16(torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)))
            for _ in range(4)]


def _de(kind, seed):
    """de / H as the kernel forms it for one of the 12 heads: a dense
    cotangent, or a pair's sign tile times g_cls (row 0) and g_aff."""
    rng = np.random.default_rng(seed + 100)
    if kind == "none":
        return None
    if kind == "dense":
        de = torch.from_numpy(rng.normal(size=(N, N)).astype(np.float32))
    else:
        sign = torch.from_numpy(rng.integers(-1, 2, size=(N, N)).astype(np.float32))
        g_cls, g_aff = (float(x) for x in rng.uniform(0, 100, size=2))
        de = sign * torch.where(torch.arange(N)[:, None] == 0, g_cls, g_aff)
    return de * (1.0 / HEADS)


def _exp(x):
    return torch.exp2(x * LOG2E)


def _two_sweep_stats(s):
    """Row max and 1 / sum of exponentials of fp32 logits s (N, N), kept
    over tiles of 64 keys as the kernels keep them."""
    m = torch.full((s.shape[0], 1), -torch.inf)
    l = torch.zeros((s.shape[0], 1))
    for j0 in range(0, s.shape[1], TILE):
        tile = s[:, j0:j0 + TILE]
        mx = torch.maximum(m, tile.max(dim=1, keepdim=True).values)
        l = l * _exp(m - mx) + _exp(tile - mx).sum(dim=1, keepdim=True)
        m = mx
    return m, 1.0 / l


def _emulated_forward(q, k, v):
    s = (q @ k.T) * SCALE
    m, rl = _two_sweep_stats(s)
    p = _exp(s - m) * rl
    return _bf16(_bf16(p) @ v), p


def _emulated_backward(q, k, v, g, de, plan):
    s = (q @ k.T) * SCALE
    m, rl = _two_sweep_stats(s)
    p = _exp(s - m) * rl
    dp = g @ v.T + (0.0 if de is None else de)
    c = (dp * p).sum(dim=1, keepdim=True)
    ds = p * (dp - c)

    def product(x, y):
        hi = _bf16(x)
        return hi @ y if plan == "bf16" else hi @ y + _bf16(x - hi) @ y

    return product(ds, k) * SCALE, product(ds.T, q) * SCALE, product(p.T, g)


def _misses(got, ref):
    """Entries outside GRAD_RTOL + GRAD_ATOL_FRAC of the largest, both
    sides rounded once to bf16 as the kernel and the twin write them."""
    got, ref = _bf16(got), _bf16(ref)
    atol = GRAD_ATOL_FRAC * ref.abs().max()
    return int(((got - ref).abs() > atol + GRAD_RTOL * ref.abs()).sum())


def _plain_backward(q, k, v, g, de):
    # One head: the twin divides de by H = 1, so it gets de / 12 as it is.
    heads = [t.to(torch.bfloat16)[None, None] for t in (q, k, v)]
    grads = backward_plain("bhnd", heads, g.to(torch.bfloat16)[None, None],
                           None if de is None else de[None], SCALE, None)
    return [t[0, 0].float() for t in grads]


@pytest.mark.parametrize("seed", [0, 1])
def test_two_sweep_forward_meets_the_forward_gates(seed):
    q, k, v, _ = _inputs(seed)
    out, probs = _emulated_forward(q, k, v)
    ref_out, ref_probs = forward_plain("bhnd", [t[None, None] for t in (q, k, v)], SCALE, None)
    torch.testing.assert_close(probs, ref_probs[0], rtol=0, atol=PROBS_ATOL)
    torch.testing.assert_close(out, ref_out[0, 0].float(), rtol=OUT_RTOL, atol=OUT_ATOL)


@pytest.mark.parametrize("de_kind", ["dense", "sign", "none"])
def test_split_operands_meet_the_gradient_gate(de_kind):
    q, k, v, g = _inputs(2)
    de = _de(de_kind, 2)
    got = _emulated_backward(q, k, v, g, de, "hilo")
    ref = _plain_backward(q, k, v, g, de)
    assert [_misses(a, b) for a, b in zip(got, ref)] == [0, 0, 0]


@pytest.mark.parametrize("de_kind", ["dense", "sign"])
def test_single_bf16_operands_miss_the_gradient_gate(de_kind):
    q, k, v, g = _inputs(3)
    de = _de(de_kind, 3)
    got = _emulated_backward(q, k, v, g, de, "bf16")
    ref = _plain_backward(q, k, v, g, de)
    misses = [_misses(a, b) for a, b in zip(got, ref)]
    assert all(n > 100 for n in misses), misses
