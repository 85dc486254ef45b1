"""The bfloat16 head-mean export (``ModelConfig.probs_dtype``) against JAX.

K1's entry ``fused_attention_qkv_cols`` takes ``probs_dtype`` as the JAX
entry does (``attn_pallas.py:980``): the float32 head mean, rounded once.
The model carries it to the kernel path only (``models/vit.py``), the
per-layer training branch reads it through ``train.build_model``, and
CAM inference builds its model without it. Held here against the JAX
package on the same numpy inputs and weights, the Pallas kernels in
interpret mode:

* K1's bf16 export and the gradient through a bf16 cotangent;
* a vitb ACR (float32 compute, crop 64, N = 17) with
  ``attn_impl="kernel", probs_dtype=bfloat16`` against JAX's
  ``ACR(attn_impl="pallas", probs_dtype=bfloat16)``: logits, the stacked
  probs, and with GETAM gradient taps on the top two layers, whose float32
  plain exports make the stack float32 as ``jnp.stack`` does;
* one per-layer train step (``fuse_consistency=False``) from the same
  weights and batch: the loss parts, and the class head after the update;
* the port's ``infer_cam.load_model`` ignores ``probs_dtype``.

Tolerances: logits 1e-4 absolute (float32 through 12 blocks, as
``tests/test_torch_model.py``); bf16 probs within one bf16 ulp (both round
a float32 mean once, a last-bit difference may cross a rounding boundary),
plus 1e-6; float32 probs 1e-5 absolute; loss parts 1e-4
relative (their L1 terms average bf16 probs that may differ by one ulp in
a few places); the class head after the update as the vitb case of
``tests/test_torch_train_step.py`` (rtol 2e-3, atol 2e-4). The trunk's
updates are not compared: the L1 terms' gradient is alpha times the sign of
the difference of two views' bf16 probs, and where a one-ulp difference
makes that difference 0 on one side and not on the other, the gradient
jumps by alpha over the count of terms (measured: block 0's proj bias
8.5e-4 apart after one step at lr 0.05). In float32 exact ties are rare
and ``tests/test_torch_train_step.py`` compares every parameter.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from acr_wsss_tpu.models.acr import ACR as JaxACR
from acr_wsss_tpu_torch.models.acr import ACR as TorchACR
from acr_wsss_tpu_torch.models.convert import flax_to_state_dict
from acr_wsss_tpu_torch.models.vit import stack_probs
from acr_wsss_tpu_torch.ops.attn_cuda import (attention_qkv_cols_plain,
                                              fused_attention_qkv_cols)
from tests.torch_port_helpers import (assert_within_one_bf16_ulp, random_flax_params,
                                      unflatten_params)

H, D = 12, 64
SCALE = D ** -0.5
CROP = 64


def _interpret(fn, *args, **kwargs):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return fn(*args, **kwargs)


@pytest.mark.parametrize("n", [17, 37])
def test_k1_bf16_export_and_its_gradient_match_jax(n):
    from acr_wsss_tpu.ops.attn_pallas import fused_attention_qkv_cols as jax_cols

    rng = np.random.default_rng(n)
    qkv = rng.normal(size=(2, n, 3 * H * D)).astype(np.float32)
    w_out = rng.normal(size=(2, n, H * D)).astype(np.float32)
    w_probs = rng.normal(size=(2, n, n)).astype(np.float32)

    def loss_jax(x):
        out, probs = jax_cols(x, SCALE, H, probs_dtype=jnp.bfloat16)
        return jnp.sum(out * w_out) + jnp.sum(probs.astype(jnp.float32) * w_probs), probs

    (_, probs_j), g_j = _interpret(jax.value_and_grad(loss_jax, has_aux=True),
                                   jnp.asarray(qkv))
    x = torch.from_numpy(qkv).requires_grad_(True)
    out, probs = fused_attention_qkv_cols(x, SCALE, H, probs_dtype=torch.bfloat16)
    assert probs.dtype == torch.bfloat16 and probs_j.dtype == jnp.bfloat16
    assert_within_one_bf16_ulp(probs.float().detach().numpy(), np.asarray(probs_j, np.float32))
    ((out * torch.from_numpy(w_out)).sum()
     + (probs.float() * torch.from_numpy(w_probs)).sum()).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), rtol=0, atol=1e-4)


def test_k1_plain_version_rounds_the_float32_mean_once():
    qkv = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 37, 3 * H * D)).astype(np.float32)).bfloat16()
    out32, p32 = attention_qkv_cols_plain(qkv, SCALE, H)
    out16, p16 = attention_qkv_cols_plain(qkv, SCALE, H, probs_dtype=torch.bfloat16)
    assert torch.equal(out16, out32) and torch.equal(p16, p32.to(torch.bfloat16))
    with pytest.raises(ValueError, match="probs_dtype"):
        fused_attention_qkv_cols(qkv, SCALE, H, probs_dtype=torch.float16)


def test_stack_probs_promotes_as_jnp_stack():
    a16 = torch.rand(2, 5, 5).bfloat16()
    a32 = torch.rand(2, 5, 5)
    assert stack_probs([a16, a16]).dtype == torch.bfloat16
    mixed = stack_probs([a16, a32])
    assert mixed.dtype == torch.float32
    assert jnp.stack([jnp.asarray(a16.float().numpy(), jnp.bfloat16),
                      jnp.asarray(a32.numpy())]).dtype == jnp.float32
    assert torch.equal(mixed[:, 0], a16.float()) and torch.equal(mixed[:, 1], a32)
    assert stack_probs([]) is None


@pytest.fixture(scope="module")
def bf16_pair():
    """(JAX ACR, its params, port ACR): vitb, float32 compute, kernel /
    pallas attention with a bf16 export, on shared seeded weights."""
    jax_model = JaxACR(backbone_name="vitb", dtype=jnp.float32, attn_impl="pallas",
                       probs_dtype=jnp.bfloat16)
    flat = random_flax_params(jax_model, jnp.zeros((1, CROP, CROP, 3)), seed=5)
    port = TorchACR(backbone_name="vitb", dtype=torch.float32, attn_impl="kernel",
                    probs_dtype=torch.bfloat16)
    port.load_state_dict(flax_to_state_dict(flat, port.state_dict()))
    port.requires_grad_(False).eval()
    return jax_model, unflatten_params(flat), port


def test_model_with_bf16_export_matches_jax(bf16_pair):
    jax_model, params, port = bf16_pair
    x = np.random.default_rng(6).normal(size=(2, CROP, CROP, 3)).astype(np.float32)
    out_j = _interpret(jax.jit(jax_model.apply), params, jnp.asarray(x))
    with torch.no_grad():
        out_t = port.forward_cls(torch.from_numpy(x))
    n = (CROP // 16) ** 2 + 1
    assert out_t["probs"].shape == (2, 12, n, n)
    assert out_t["probs"].dtype == torch.bfloat16 and out_j["probs"].dtype == jnp.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in out_t["probs_layers"])
    assert_within_one_bf16_ulp(out_t["probs"].float().numpy(),
                               np.asarray(out_j["probs"], np.float32))
    np.testing.assert_allclose(out_t["logits"].numpy(), np.asarray(out_j["logits"]),
                               rtol=0, atol=1e-4)


def test_model_with_bf16_export_and_gradient_taps_stacks_float32(bf16_pair):
    """GETAM taps on the top two layers: blocks 0-9 export bf16 through the
    kernel path, 10-11 float32 through the plain path; the stack is float32
    on both sides, and so are the gradients of the taps."""
    jax_model, params, port = bf16_pair
    x = np.random.default_rng(7).normal(size=(2, CROP, CROP, 3)).astype(np.float32)
    n = (CROP // 16) ** 2 + 1
    offsets = np.zeros((2, 2, H, n, n), np.float32)
    w = np.random.default_rng(8).normal(size=(2, 20)).astype(np.float32)

    def jax_fn(off):
        out = jax_model.apply(params, jnp.asarray(x), probs_offsets=off)
        return jnp.sum(out["logits"] * w), out["probs"]

    (_, probs_j), g_j = _interpret(jax.jit(jax.value_and_grad(jax_fn, has_aux=True)),
                                   jnp.asarray(offsets))
    off = torch.from_numpy(offsets).requires_grad_(True)
    out_t = port.forward_cls(torch.from_numpy(x), probs_offsets=off)
    (g_t,) = torch.autograd.grad((out_t["logits"] * torch.from_numpy(w)).sum(), off)
    assert out_t["probs"].dtype == torch.float32 and probs_j.dtype == jnp.float32
    assert [p.dtype for p in out_t["probs_layers"]] == [torch.bfloat16] * 10 + [torch.float32] * 2
    probs_t, probs_j = out_t["probs"].detach().numpy(), np.asarray(probs_j)
    assert_within_one_bf16_ulp(probs_t[:, :10], probs_j[:, :10])
    np.testing.assert_allclose(probs_t[:, 10:], probs_j[:, 10:], rtol=0, atol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(g_j)).max())


def test_per_layer_train_step_with_bf16_export_matches_jax():
    from acr_wsss_tpu import train as jax_train
    from acr_wsss_tpu.configs import ModelConfig as JaxModelConfig
    from acr_wsss_tpu.configs import TrainConfig as JaxTrainConfig
    from acr_wsss_tpu_torch import train as port_train
    from acr_wsss_tpu_torch.configs import ModelConfig, TrainConfig
    from acr_wsss_tpu_torch.models.convert import state_dict_to_flax
    from tests.torch_port_helpers import flatten_params

    crop, max_step = 32, 10
    jcfg = JaxTrainConfig(model=JaxModelConfig(backbone="vitb", attn_impl="pallas",
                                               compute_dtype="float32",
                                               fuse_consistency=False,
                                               probs_dtype="bfloat16"),
                          crop_size=crop, lr=0.05, alpha=125.0)
    pcfg = TrainConfig(model=ModelConfig(backbone="vitb", attn_impl="kernel",
                                         compute_dtype="float32", fuse_consistency=False,
                                         probs_dtype="bfloat16"),
                       crop_size=crop, lr=0.05, alpha=125.0, device="cpu")
    assert not port_train.uses_fused_consistency(pcfg)
    rng = np.random.default_rng(17)
    batch = {"image": rng.normal(size=(2, crop, crop, 3)).astype(np.float32),
             "label": (rng.uniform(size=(2, 20)) > 0.7).astype(np.float32)}
    grid = (crop // 16, crop // 16)

    jax_model = jax_train.build_model(jcfg.model)
    flat = random_flax_params(jax_model, jnp.zeros((1, crop, crop, 3)), seed=11)
    tx = jax_train.make_optimizer(jcfg.lr, max_step, jcfg.weight_decay, jcfg.momentum,
                                  jcfg.poly_power)
    state = jax_train.TrainState.create(apply_fn=jax_model.apply,
                                        params=unflatten_params(flat), tx=tx)
    state, jparts = _interpret(jax.jit(jax_train.make_train_step(jax_model, jcfg, grid)),
                               state, {k: jnp.asarray(v) for k, v in batch.items()})
    jflat = flatten_params(jax.device_get(state.params))

    port = port_train.build_model(pcfg.model)
    assert all(b.attn.probs_dtype == torch.bfloat16 for b in port.trunk.blocks)
    port.load_state_dict(flax_to_state_dict(flat, port.state_dict()))
    opt = port_train.make_optimizer(port.parameters(), pcfg.lr, max_step,
                                    pcfg.weight_decay, pcfg.momentum, pcfg.poly_power)
    pparts = port_train.make_train_step(port, opt, pcfg, grid)(batch)
    assert set(pparts) == set(jax.device_get(jparts))
    for k, v in jax.device_get(jparts).items():
        np.testing.assert_allclose(float(pparts[k]), float(v), rtol=1e-4, err_msg=k)
    pflat = state_dict_to_flax(port)
    for k in ("params/cls_head/kernel", "params/cls_head/bias"):
        np.testing.assert_allclose(pflat[k], np.asarray(jflat[k]), rtol=2e-3, atol=2e-4,
                                   err_msg=k)


def test_infer_cam_model_ignores_probs_dtype(tmp_path):
    """As JAX's ``infer_cam.run`` builds its ACR without ``probs_dtype``, the
    port's ``load_model`` does: the export stays float32."""
    from acr_wsss_tpu_torch import infer_cam
    from acr_wsss_tpu_torch.configs import InferConfig, ModelConfig
    from acr_wsss_tpu_torch.models.acr import init_random_
    from acr_wsss_tpu_torch.models.convert import state_dict_to_flax
    from acr_wsss_tpu_torch.utils.checkpoint import save_params_npz

    npz = str(tmp_path / "w.npz")
    save_params_npz(npz, state_dict_to_flax(init_random_(TorchACR(backbone_name="vitb"), 0)))
    model_cfg = ModelConfig(backbone="vitb", compute_dtype="float32", probs_dtype="bfloat16")
    model = infer_cam.load_model(InferConfig(model=model_cfg, weights=npz, device="cpu"))
    assert all(b.attn.probs_dtype == torch.float32 for b in model.trunk.blocks)
    with torch.no_grad():
        out = model.forward_cls(torch.zeros((1, 32, 32, 3)))
    assert out["probs"].dtype == torch.float32
