"""One train step of the port against one of the JAX package, per branch.

From shared numpy weights (``tests/torch_port_helpers.py``) and the same
batch, the port's ``make_train_step`` and the JAX one take one step of
each loss branch: fused (pair-consistency entry; JAX: the Pallas kernels
in interpret mode), per-layer aligned, and legacy unaligned. The step-0
loss parts and the parameters after the poly-SGD update are compared.

Models run in float32: vitb at crop 32 (as the JAX loop tests run it) and
vitb_hybrid at crop 64 for the fused branch. Tolerances are at most those
of ``tests/test_train_parity.py``: loss parts rtol 1e-5 for vitb and rtol
1e-5 / atol 1e-5 for the hybrid (float32 summation order through its deep
stem); parameters after the update rtol 2e-3 / atol 2e-4 for vitb and
5e-2 / 5e-3 for the hybrid. The hybrid steps at lr 0.01, as that test's
hybrid case does: its weight-standardized stem amplifies the float32
rounding differences between PyTorch's and XLA's convolutions in the
gradient (at the recipe's lr 0.05 the stem kernel moves up to 7.8e-3 away
from JAX's in the fused and in the per-layer branch alike, while JAX's own
fused and per-layer steps agree to 1.1e-6), and the update scales with lr.
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
from acr_wsss_tpu_torch.models.convert import state_dict_to_flax
from tests.torch_port_helpers import build_acr_pair, flatten_params

LR = {"vitb": 0.05, "vitb_hybrid": 0.01}
LOSS_TOL = {"vitb": dict(rtol=1e-5), "vitb_hybrid": dict(rtol=1e-5, atol=1e-5)}
PARAM_TOL = {"vitb": dict(rtol=2e-3, atol=2e-4), "vitb_hybrid": dict(rtol=5e-2, atol=5e-3)}


BRANCHES = {
    # name: (JAX attn_impl, fuse_consistency, aligned_mirror)
    "fused": ("pallas", True, True),
    "per_layer_aligned": ("xla", False, True),
    "legacy_unaligned": ("xla", False, False),
}


def _one_step(backbone, crop, branch):
    """(JAX step-0 parts, JAX params after, port parts, port params after)."""
    from jax.experimental.pallas import tpu as pltpu

    jax_impl, fuse, aligned = BRANCHES[branch]
    jcfg = JaxTrainConfig(model=JaxModelConfig(backbone=backbone, attn_impl=jax_impl,
                                               compute_dtype="float32",
                                               fuse_consistency=fuse),
                          crop_size=crop, lr=LR[backbone], alpha=125.0,
                          aligned_mirror=aligned)
    pcfg = TrainConfig(model=ModelConfig(backbone=backbone, attn_impl="kernel",
                                         compute_dtype="float32", fuse_consistency=fuse),
                       crop_size=crop, lr=LR[backbone], alpha=125.0,
                       aligned_mirror=aligned, device="cpu")
    assert port_train.uses_fused_consistency(pcfg) == fuse
    rng = np.random.default_rng(17)
    batch = {"image": rng.normal(size=(2, crop, crop, 3)).astype(np.float32),
             "label": (rng.uniform(size=(2, 20)) > 0.7).astype(np.float32)}
    grid = (crop // 16, crop // 16)
    max_step = 10

    jax_model, params, port = build_acr_pair(crop, seed=11, backbone=backbone,
                                             jax_impl=jax_impl)
    tx = jax_train.make_optimizer(jcfg.lr, max_step, jcfg.weight_decay, jcfg.momentum,
                                  jcfg.poly_power)
    state = jax_train.TrainState.create(apply_fn=jax_model.apply, params=params, tx=tx)
    with pltpu.force_tpu_interpret_mode():
        state, jparts = jax.jit(jax_train.make_train_step(jax_model, jcfg, grid))(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        jparts = jax.device_get(jparts)
    jflat = flatten_params(jax.device_get(state.params))

    port.requires_grad_(True).train()
    opt = port_train.make_optimizer(port.parameters(), pcfg.lr, max_step,
                                    pcfg.weight_decay, pcfg.momentum, pcfg.poly_power)
    pparts = port_train.make_train_step(port, opt, pcfg, grid)(batch)
    pflat = state_dict_to_flax(port)
    return jparts, jflat, {k: float(v) for k, v in pparts.items()}, pflat


@pytest.mark.parametrize("backbone,crop,branch", [
    ("vitb", 32, "fused"),
    ("vitb", 32, "per_layer_aligned"),
    ("vitb", 32, "legacy_unaligned"),
    ("vitb_hybrid", 64, "fused"),
])
def test_train_step_matches_jax(backbone, crop, branch):
    jparts, jflat, pparts, pflat = _one_step(backbone, crop, branch)
    assert set(pparts) == set(jparts)
    for k in jparts:
        np.testing.assert_allclose(pparts[k], float(jparts[k]), err_msg=k, **LOSS_TOL[backbone])
    assert set(pflat) == set(jflat)
    for k in jflat:
        np.testing.assert_allclose(pflat[k], np.asarray(jflat[k]), **PARAM_TOL[backbone],
                                   err_msg=k)


