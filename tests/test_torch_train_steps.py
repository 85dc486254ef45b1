"""Five train steps of the port against five of the JAX package, at the
recipe's lr 0.05 (alpha 125, poly SGD with momentum and weight decay), on
the fused branch (JAX: the Pallas pair kernels in interpret mode).

From random weights the recipe's loss jumps within a few steps; this holds
the port's trajectory to JAX's from the same converted weights and the
same five batches, loss part by loss part, at every step. The one-step
scaffolding is that of ``tests/test_torch_train_step.py``: float32 models,
shared numpy weights, 2 images per step.

Tolerances:
* vitb at crop 32: rtol 1e-4 on every part at every step. Step 0 agrees to
  the one-step test's float32 rtol 1e-5; each of the four updates that
  follow carries float32 rounding of another summation order into the
  parameters, and the loss parts are read at those parameters. 1e-4 is
  ten times the step-0 tolerance.
* vitb_hybrid at crop 64 (slow tier): at lr 0.05 the hybrid's trajectory
  amplifies float32 rounding (its weight-standardized stem; see the
  module docstring of ``tests/test_torch_train_step.py``), so no fixed
  tolerance stands for float32 here. The test measures it: JAX runs the
  same five steps a second time from its weights perturbed by one float32
  rounding (relative 2^-24, seeded), and, for each loss part, the port's
  worst relative deviation from JAX over the five steps must be at most
  twice JAX's worst deviation from itself (and at most 1e-5 where that is
  smaller).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from acr_wsss_tpu import train as jax_train
from acr_wsss_tpu.configs import ModelConfig as JaxModelConfig
from acr_wsss_tpu.configs import TrainConfig as JaxTrainConfig
from acr_wsss_tpu_torch import train as port_train
from acr_wsss_tpu_torch.configs import ModelConfig, TrainConfig
from tests.torch_port_helpers import build_acr_pair

LR, STEPS, MAX_STEP = 0.05, 5, 10
VITB_RTOL, FLOOR_RTOL, SPREAD_FACTOR = 1e-4, 1e-5, 2.0


def _trajectories(backbone, crop, perturbed):
    """(JAX parts per step, port parts per step, JAX parts per step from
    perturbed weights or None)."""
    from jax.experimental.pallas import tpu as pltpu

    jcfg = JaxTrainConfig(model=JaxModelConfig(backbone=backbone, attn_impl="pallas",
                                               compute_dtype="float32",
                                               fuse_consistency=True),
                          crop_size=crop, lr=LR, alpha=125.0)
    pcfg = TrainConfig(model=ModelConfig(backbone=backbone, attn_impl="kernel",
                                         compute_dtype="float32", fuse_consistency=True),
                       crop_size=crop, lr=LR, alpha=125.0, device="cpu")
    rng = np.random.default_rng(23)
    batches = [{"image": rng.normal(size=(2, crop, crop, 3)).astype(np.float32),
                "label": (rng.uniform(size=(2, 20)) > 0.7).astype(np.float32)}
               for _ in range(STEPS)]
    grid = (crop // 16, crop // 16)
    jax_model, params, port = build_acr_pair(crop, seed=11, backbone=backbone,
                                             jax_impl="pallas")
    step = jax.jit(jax_train.make_train_step(jax_model, jcfg, grid))

    def run_jax(p):
        tx = jax_train.make_optimizer(jcfg.lr, MAX_STEP, jcfg.weight_decay, jcfg.momentum,
                                      jcfg.poly_power)
        state = jax_train.TrainState.create(apply_fn=jax_model.apply, params=p, tx=tx)
        parts = []
        with pltpu.force_tpu_interpret_mode():
            for b in batches:
                state, out = step(state, {k: jnp.asarray(v) for k, v in b.items()})
                parts.append({k: float(v) for k, v in jax.device_get(out).items()})
        return parts

    jparts = run_jax(params)
    noise = np.random.default_rng(99)
    jpert = run_jax(jax.tree_util.tree_map(
        lambda p: p * (1 + 2.0 ** -24 * noise.uniform(-1, 1, p.shape).astype(np.float32)),
        params)) if perturbed else None

    port.requires_grad_(True).train()
    opt = port_train.make_optimizer(port.parameters(), pcfg.lr, MAX_STEP, pcfg.weight_decay,
                                    pcfg.momentum, pcfg.poly_power)
    pstep = port_train.make_train_step(port, opt, pcfg, grid)
    pparts = [{k: float(v) for k, v in pstep(b).items()} for b in batches]
    return jparts, pparts, jpert


def _worst_rel(a, b, key):
    return max(abs(x[key] - y[key]) / abs(y[key]) for x, y in zip(a, b))


def test_five_steps_match_jax_vitb():
    jparts, pparts, _ = _trajectories("vitb", 32, perturbed=False)
    for step, (p, j) in enumerate(zip(pparts, jparts)):
        assert set(p) == set(j)
        for k in j:
            np.testing.assert_allclose(p[k], j[k], rtol=VITB_RTOL, err_msg=f"step {step} {k}")
    # the recipe's loss rises from random weights in both packages alike
    assert jparts[-1]["loss"] > 10 * jparts[0]["loss"]


@pytest.mark.slow
def test_five_steps_match_jax_hybrid_within_jax_own_spread():
    jparts, pparts, jpert = _trajectories("vitb_hybrid", 64, perturbed=True)
    for k in jparts[0]:
        np.testing.assert_allclose(pparts[0][k], jparts[0][k], rtol=FLOOR_RTOL, err_msg=k)
        port_dev = _worst_rel(pparts, jparts, k)
        own = _worst_rel(jpert, jparts, k)
        assert port_dev <= max(FLOOR_RTOL, SPREAD_FACTOR * own), (k, port_dev, own)
