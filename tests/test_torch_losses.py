"""The port's ACR losses against the JAX package's, on shared numpy inputs.

Both sides compute in float32 from the same arrays; the tolerance, rtol
1e-6, allows for summation order only.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from acr_wsss_tpu import losses as jl
from acr_wsss_tpu_torch import losses as tl

RTOL = 1e-6
GRID = (3, 4)
N = GRID[0] * GRID[1] + 1


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got, np.float64),
                               np.asarray(ref, np.float64), rtol=RTOL, atol=1e-7)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    b, L = 2, 3
    probs = rng.dirichlet(np.ones(N), size=(2 * b, L, N)).astype(np.float32)
    return {
        "logits1": rng.normal(size=(b, 20)).astype(np.float32) * 3,
        "logits2": rng.normal(size=(b, 20)).astype(np.float32) * 3,
        "labels": (rng.uniform(size=(b, 20)) > 0.7).astype(np.float32),
        "attn": probs,                                   # (2b, L, N, N)
        "layers": tuple(probs[:, i] for i in range(L)),  # L x (2b, N, N)
        "sums": tuple((rng.uniform(size=b).astype(np.float32),
                       rng.uniform(size=b).astype(np.float32) * 50) for _ in range(L)),
        "b": b,
    }


def test_hflip_token_permutation_matches():
    np.testing.assert_array_equal(tl.hflip_token_permutation(*GRID),
                                  jl.hflip_token_permutation(*GRID))


def test_unflip_attention_and_token_axis_match(data):
    x = data["attn"][:, 0, 1:, 1:]
    perm = jl.hflip_token_permutation(*GRID)
    _close(tl.unflip_attention(torch.from_numpy(x), torch.from_numpy(perm)),
           jl.unflip_attention(jnp.asarray(x), jnp.asarray(perm)))
    for axis in (-1, -2, 1):
        _close(tl._unflip_token_axis(torch.from_numpy(x), GRID, axis),
               jl._unflip_token_axis(jnp.asarray(x), GRID, axis))


def test_multilabel_soft_margin_and_l1_match(data):
    _close(tl.multilabel_soft_margin_loss(torch.from_numpy(data["logits1"]),
                                          torch.from_numpy(data["labels"])),
           jl.multilabel_soft_margin_loss(jnp.asarray(data["logits1"]),
                                          jnp.asarray(data["labels"])))
    _close(tl.l1_loss(torch.from_numpy(data["logits1"]), torch.from_numpy(data["logits2"])),
           jl.l1_loss(jnp.asarray(data["logits1"]), jnp.asarray(data["logits2"])))


def test_multilabel_soft_margin_matches_torch_reference(data):
    import torch.nn.functional as F

    logits, labels = torch.from_numpy(data["logits1"]), torch.from_numpy(data["labels"])
    _close(tl.multilabel_soft_margin_loss(logits, labels),
           F.multilabel_soft_margin_loss(logits, labels))


@pytest.mark.parametrize("use_grid", [True, False])
def test_acr_consistency_losses_match(data, use_grid):
    b = data["b"]
    a1, a2 = data["attn"][:b], data["attn"][b:]
    perm = jl.hflip_token_permutation(*GRID)
    grid = GRID if use_grid else None
    got = tl.acr_consistency_losses(torch.from_numpy(a1), torch.from_numpy(a2),
                                    torch.from_numpy(perm), grid)
    ref = jl.acr_consistency_losses(jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(perm), grid)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("aligned", [True, False])
def test_acr_total_loss_layers_matches(data, aligned):
    got_total, got = tl.acr_total_loss_layers(
        torch.from_numpy(data["logits1"]), torch.from_numpy(data["logits2"]),
        tuple(torch.from_numpy(p) for p in data["layers"]),
        torch.from_numpy(data["labels"]), GRID, 125.0, aligned=aligned)
    ref_total, ref = jl.acr_total_loss_layers(
        jnp.asarray(data["logits1"]), jnp.asarray(data["logits2"]),
        tuple(jnp.asarray(p) for p in data["layers"]), jnp.asarray(data["labels"]),
        GRID, 125.0, aligned=aligned)
    _close(got_total, ref_total)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k])
    cls_a, aff_a = tl.acr_consistency_losses_layers(
        tuple(torch.from_numpy(p) for p in data["layers"]), data["b"], GRID, aligned)
    _close(cls_a, ref["cls_align_loss"])
    _close(aff_a, ref["aff_align_loss"])


def test_acr_total_loss_fused_matches(data):
    got_total, got = tl.acr_total_loss_fused(
        torch.from_numpy(data["logits1"]), torch.from_numpy(data["logits2"]),
        tuple((torch.from_numpy(c), torch.from_numpy(a)) for c, a in data["sums"]),
        torch.from_numpy(data["labels"]), N, 125.0)
    ref_total, ref = jl.acr_total_loss_fused(
        jnp.asarray(data["logits1"]), jnp.asarray(data["logits2"]),
        tuple((jnp.asarray(c), jnp.asarray(a)) for c, a in data["sums"]),
        jnp.asarray(data["labels"]), N, 125.0)
    _close(got_total, ref_total)
    for k in ref:
        _close(got[k], ref[k])


def test_acr_total_loss_matches(data):
    b = data["b"]
    perm = jl.hflip_token_permutation(*GRID)
    got_total, got = tl.acr_total_loss(
        torch.from_numpy(data["logits1"]), torch.from_numpy(data["logits2"]),
        torch.from_numpy(data["attn"][:b]), torch.from_numpy(data["attn"][b:]),
        torch.from_numpy(data["labels"]), torch.from_numpy(perm), 125.0)
    ref_total, ref = jl.acr_total_loss(
        jnp.asarray(data["logits1"]), jnp.asarray(data["logits2"]),
        jnp.asarray(data["attn"][:b]), jnp.asarray(data["attn"][b:]),
        jnp.asarray(data["labels"]), jnp.asarray(perm), 125.0)
    _close(got_total, ref_total)
    for k in ref:
        _close(got[k], ref[k])


def test_fused_sums_normalize_to_the_layers_losses(data):
    """Per-pair |delta| sums, normalized as acr_total_loss_fused does, give
    the aligned per-layer losses (the identity the fused kernel rests on)."""
    b = data["b"]
    layers = tuple(torch.from_numpy(p) for p in data["layers"])
    sums = []
    for p in layers:
        d = (p[:b] - p[b:]).abs()
        sums.append((d[:, 0, 1:].sum(dim=-1), d[:, 1:, 1:].sum(dim=(1, 2))))
    logits1, logits2 = torch.from_numpy(data["logits1"]), torch.from_numpy(data["logits2"])
    labels = torch.from_numpy(data["labels"])
    _, fused = tl.acr_total_loss_fused(logits1, logits2, sums, labels, N, 125.0)
    _, ref = tl.acr_total_loss_layers(logits1, logits2, layers, labels, GRID, 125.0,
                                      aligned=True)
    for k in ref:
        np.testing.assert_allclose(float(fused[k]), float(ref[k]), rtol=1e-5)
