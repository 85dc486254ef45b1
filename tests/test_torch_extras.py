"""The port's auxiliary modules (``models/extras.py``: ASPP, AttentionConv)
and ``getam.grad_cam`` against the JAX package's, on the CPU.

* ``ASPP`` at DeepLab's dilations (1, 6, 12, 18) on a 20x20 map and
  ``AttentionConv`` (kernel 5, 4 groups) on a 12x10 map, float32, on the
  flax parameters converted by ``flax_to_state_dict`` (``rel_h`` and
  ``rel_w`` in flax's shapes): within ``CNN_REL`` (1e-5) of the largest
  |value|, as the CNN families (float32 sums in another order);
  ``state_dict_to_flax`` gives back the flax layout; ASPP's dropout acts
  only with ``deterministic=False``;
* ``grad_cam`` against JAX's closed form for a linear head
  (``tests/test_scan_trunk.py:51``, 1e-6) and against JAX's ``grad_cam``
  for a nonlinear head on the same features and weights (``CNN_REL``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acr_wsss_tpu.getam import grad_cam as jax_grad_cam
from acr_wsss_tpu.models import extras as jax_extras
from acr_wsss_tpu_torch.getam import grad_cam
from acr_wsss_tpu_torch.models import extras
from acr_wsss_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from tests.torch_port_helpers import (assert_close_to_max, jit_o0, random_flax_params,
                                      unflatten_params)

CASES = {
    "aspp": (lambda: jax_extras.ASPP(features=64), lambda: extras.ASPP(48, features=64),
             (2, 20, 20, 48)),
    "attention_conv": (lambda: jax_extras.AttentionConv(32, kernel_size=5, groups=4),
                       lambda: extras.AttentionConv(16, 32, kernel_size=5, groups=4),
                       (2, 12, 10, 16)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_extras_match_flax(case):
    make_jax, make_port, shape = CASES[case]
    jm, tm = make_jax(), make_port()
    flat = random_flax_params(jm, jnp.zeros((1,) + shape[1:]), seed=4)
    tm.load_state_dict(flax_to_state_dict(flat, tm.state_dict()))
    assert sorted(state_dict_to_flax(tm)) == sorted(flat)
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    want = jit_o0(jm.apply)(unflatten_params(flat), jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    assert_close_to_max(got.permute(0, 2, 3, 1).numpy(), want)


def test_aspp_dropout_only_when_asked():
    tm = extras.ASPP(48, features=64)
    x = torch.randn(1, 48, 8, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        kept = tm(x)
        torch.manual_seed(1)
        dropped = tm(x, deterministic=False)
    assert torch.equal(tm(x).detach(), kept)
    zeroed = (dropped == 0) & (kept != 0)
    assert 0.3 < zeroed.float().sum() / (kept != 0).sum() < 0.7
    np.testing.assert_allclose(dropped[~zeroed & (kept != 0)].numpy(),
                               2 * kept[~zeroed & (kept != 0)].numpy(), rtol=1e-6)


def test_grad_cam_closed_form():
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(1, 8, 4, 4)).astype(np.float32)
    w = rng.normal(size=(8, 5)).astype(np.float32)
    cam = grad_cam(torch.from_numpy(feats),
                   lambda f: f.mean(dim=(2, 3)) @ torch.from_numpy(w), 2)
    expected = np.maximum(((w[:, 2] / 16)[None, :, None, None] * feats).sum(1), 0)
    np.testing.assert_allclose(cam.numpy(), expected, atol=1e-6)
    jax_cam = jax_grad_cam(jnp.asarray(feats.transpose(0, 2, 3, 1)),
                           lambda f: jnp.mean(f, axis=(1, 2)) @ jnp.asarray(w), 2)
    np.testing.assert_allclose(cam.numpy(), np.asarray(jax_cam), atol=1e-6)


def test_grad_cam_matches_jax_on_a_nonlinear_head():
    """A ReLU, a 1x1 mixing and a tanh before the pooled Dense: the gradient
    differs from pixel to pixel; two images, class 3. The features keep
    their graph: the CAM is differentiable as JAX's is."""
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(2, 6, 5, 7)).astype(np.float32)
    mix = rng.normal(size=(6, 6)).astype(np.float32)
    w = rng.normal(size=(6, 4)).astype(np.float32)

    def head_t(f):
        h = torch.tanh(torch.einsum("bkhw,kj->bjhw", torch.relu(f), torch.from_numpy(mix)))
        return h.mean(dim=(2, 3)) @ torch.from_numpy(w)

    def head_j(f):
        h = jnp.tanh(jnp.einsum("bhwk,kj->bhwj", jax.nn.relu(f), jnp.asarray(mix)))
        return jnp.mean(h, axis=(1, 2)) @ jnp.asarray(w)

    f = torch.from_numpy(feats).requires_grad_(True)
    cam = grad_cam(f, head_t, 3)
    want = jax_grad_cam(jnp.asarray(feats.transpose(0, 2, 3, 1)), head_j, 3)
    assert cam.shape == (2, 5, 7) and float(cam.detach().max()) > 0
    assert_close_to_max(cam.detach().numpy(), want)
    cam.sum().backward()
    assert f.grad is not None and torch.isfinite(f.grad).all()
