"""The pair forward's order of arithmetic (K2f, ``csrc/attn_pair_fwd.cu``),
emulated on the CPU and held to the gates that ``chip_smoke.py`` holds the
kernel to.

K2f's pair kernel never writes the head means. Its out pass keeps each
row's softmax statistics (the row max and 1 / the sum of exponentials,
kept over tiles of 64 keys in two sweeps); the pair kernel then recomputes
p = exp(s - max) * (1 / sum) per (64 rows, 64 keys) tile, sums it over the
heads of each view in head order into one fp32 accumulator per view, forms
delta = acc_view / H - acc_mirror / H, and writes each tile's masked
|delta| sums, which a last kernel adds in tile order. The sign tile is
sign(delta) under the same masks.

Here those steps run in float32 torch on seeded numpy inputs (values that
bf16 represents, as the card's q and k are), at token counts that leave a
partial last tile (17, 65, 129), with 2 pairs whose mirror is close to its
view. The emulation is held against the JAX pair entry in interpret mode
and against the port's plain version.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from acr_wsss_tpu_torch.ops.attn_cuda import attention_qkv_cols_plain
from acr_wsss_tpu_torch.ops.attn_pair import pair_consistency_forward_plain, pair_masks

H, D = 12, 64
SCALE = D ** -0.5
TILE = 64
PAIRS = 2
LOG2E = 1.4426950408889634
# The gates of chip_smoke.py, with the reasons given there.
SUM_RTOL, SIGN_EPS = 1e-5, 1e-5


def _qkv(n, seed):
    """(2 * PAIRS, N, 3 * H * D) float32 holding bf16 values, rows
    interleaved (view, mirror), each mirror the view plus a little noise."""
    rng = np.random.default_rng(seed)
    view = rng.normal(size=(PAIRS, n, 3 * H * D)).astype(np.float32)
    mirror = view + np.float32(0.1) * rng.normal(size=view.shape).astype(np.float32)
    qkv = np.stack([view, mirror], axis=1).reshape(2 * PAIRS, n, 3 * H * D)
    return torch.from_numpy(qkv).bfloat16().float()


def _exp(x):
    """The kernels' fast exponential, 2^(x log2 e)."""
    return torch.exp2(x * LOG2E)


def _row_stats(s):
    """Row max and 1 / sum of exponentials of the logits s (N, N), kept over
    tiles of 64 keys as the out kernel keeps them."""
    m = torch.full((s.shape[0], 1), -torch.inf)
    l = torch.zeros((s.shape[0], 1))
    for j0 in range(0, s.shape[1], TILE):
        tile = s[:, j0:j0 + TILE]
        mx = torch.maximum(m, tile.max(dim=1, keepdim=True).values)
        l = l * _exp(m - mx) + _exp(tile - mx).sum(dim=1, keepdim=True)
        m = mx
    return m, 1.0 / l


def _head_sum(qkv_b):
    """sum_h p_h (N, N) of one batch row, in head order, each p recomputed
    from its row statistics."""
    n = qkv_b.shape[0]
    q = qkv_b[:, :H * D].reshape(n, H, D)
    k = qkv_b[:, H * D:2 * H * D].reshape(n, H, D)
    acc = torch.zeros((n, n))
    for h in range(H):
        s = (q[:, h] @ k[:, h].T) * SCALE
        m, rl = _row_stats(s)
        acc = acc + _exp(s - m) * rl
    return acc


def emulated_pair_forward(qkv):
    """(cls_sums, aff_sums, sign) as K2f's pair and sums kernels form them."""
    n = qkv.shape[1]
    cls_mask, aff_mask = pair_masks(n)
    cls_sums, aff_sums, signs = [], [], []
    for i in range(qkv.shape[0] // 2):
        delta = _head_sum(qkv[2 * i]) / H - _head_sum(qkv[2 * i + 1]) / H
        absd = delta.abs()
        cls = aff = torch.zeros(())
        for r0 in range(0, n, TILE):                 # tiles in order, row-major
            for c0 in range(0, n, TILE):
                tile = (slice(r0, r0 + TILE), slice(c0, c0 + TILE))
                cls = cls + torch.where(cls_mask[tile], absd[tile], 0.0).sum()
                aff = aff + torch.where(aff_mask[tile], absd[tile], 0.0).sum()
        cls_sums.append(cls)
        aff_sums.append(aff)
        signs.append(torch.where(cls_mask | aff_mask, torch.sign(delta), 0.0).to(torch.int8))
    return torch.stack(cls_sums), torch.stack(aff_sums), torch.stack(signs)


def _jax_pallas_pair(qkv):
    from jax.experimental.pallas import tpu as pltpu

    from acr_wsss_tpu.ops.attn_pallas import fused_attention_pair_consistency

    with pltpu.force_tpu_interpret_mode():
        return fused_attention_pair_consistency(jnp.asarray(qkv.numpy()), SCALE, H)


@pytest.mark.parametrize("n", [17, 65, 129])
def test_emulated_pair_sums_match_the_jax_pair_entry(n):
    qkv = _qkv(n, seed=n)
    cls_s, aff_s, _ = emulated_pair_forward(qkv)
    _, cls_j, aff_j = _jax_pallas_pair(qkv)
    np.testing.assert_allclose(cls_s.numpy(), np.asarray(cls_j), rtol=SUM_RTOL, atol=0)
    np.testing.assert_allclose(aff_s.numpy(), np.asarray(aff_j), rtol=SUM_RTOL, atol=0)


@pytest.mark.parametrize("n", [17, 65, 129])
def test_emulated_pair_forward_matches_the_plain_version(n):
    qkv = _qkv(n, seed=n + 1)
    cls_s, aff_s, sign = emulated_pair_forward(qkv)
    _, ref_cls, ref_aff, ref_sign = pair_consistency_forward_plain(qkv, SCALE, H)
    torch.testing.assert_close(cls_s, ref_cls, rtol=SUM_RTOL, atol=0)
    torch.testing.assert_close(aff_s, ref_aff, rtol=SUM_RTOL, atol=0)
    _, probs = attention_qkv_cols_plain(qkv, SCALE, H, "mean")
    clear = (probs[0::2] - probs[1::2]).abs() > SIGN_EPS
    assert clear.any()
    assert torch.equal(sign[clear], ref_sign[clear])
    assert sign.dtype == torch.int8 and not sign[:, :, 0].any()
