"""The port's poly SGD against the JAX package's optax chain.

Same parameters and gradients (numpy, seeded) go through both optimizers;
parameters after the updates agree to rtol 1e-6 (float32, the same
operations in the same order up to fused multiply-adds).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import optax
import torch

from acr_wsss_tpu.utils.schedule import make_optimizer as jax_make_optimizer
from acr_wsss_tpu.utils.schedule import poly_schedule
from acr_wsss_tpu_torch.utils.schedule import make_optimizer, poly_factor

LR, MAX_STEP, UPDATES = 0.05, 8, 5
SHAPES = ((4, 3), (7,), (2, 3, 5))


def test_lr_per_step_matches_the_poly_schedule():
    sched = poly_schedule(LR, MAX_STEP)
    param = torch.nn.Parameter(torch.zeros(3))
    opt = make_optimizer([param], LR, MAX_STEP)
    for k in range(MAX_STEP + 3):
        np.testing.assert_allclose(opt.lr, float(sched(k)), rtol=1e-6)
        np.testing.assert_allclose(LR * poly_factor(k, MAX_STEP), float(sched(k)), rtol=1e-6)
        param.grad = torch.ones(3)
        opt.step()


@pytest.mark.parametrize("quirk,clip,accum", [
    (False, 0.0, 1), (True, 0.0, 1), (False, 0.5, 1), (False, 0.0, 2), (True, 0.5, 2),
])
def test_params_after_updates_match_optax(quirk, clip, accum):
    rng = np.random.default_rng(7)
    init = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) for s in SHAPES]
             for _ in range(UPDATES * accum)]

    tx = jax_make_optimizer(LR, MAX_STEP, weight_decay=5e-4, momentum=0.9,
                            reference_quirk=quirk, clip_grad_norm=clip, accum_steps=accum)
    jparams = [jnp.asarray(p) for p in init]
    state = tx.init(jparams)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = make_optimizer(tparams, LR, MAX_STEP, weight_decay=5e-4, momentum=0.9,
                         reference_quirk=quirk, clip_grad_norm=clip, accum_steps=accum)
    applied = 0
    for g in grads:
        for p, x in zip(tparams, g):
            p.grad = torch.from_numpy(x)
        applied += opt.step()
    assert applied == opt.updates == UPDATES
    for t, j in zip(tparams, jparams):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
