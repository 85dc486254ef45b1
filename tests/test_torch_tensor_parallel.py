"""The port's tensor parallelism (the mesh's ``model`` axis) against the JAX
package's, on the CPU.

* The rules: the parameters that JAX's ``param_shardings`` puts on the
  model axis (``TP_RULES``, on ``jax.eval_shape``'s vitb params over the 8
  virtual CPU devices of ``tests/conftest.py``), mapped through
  ``models/convert.py``, are exactly those of the port's ``TP_RULES``, on
  the same dimension. The one difference is the documented one: the qkv
  cut goes per head within q, k and v (three groups), not in contiguous
  columns.
* One spawned job of 4 gloo ranks, ``data=2,model=2``
  (``torch_parallel_workers.tp_job``), run once per test run
  (``torch_port_helpers.run_once``): vitb at crop 32, float32, lr 0.01,
  alpha 1, batch 8 (JAX's ``_tiny_cfg`` at the crop of
  ``tests/test_torch_parallel.py``), on the numpy weights of
  ``tests/torch_port_helpers.py``. Against JAX's step on a (2, 2)
  ``("data", "model")`` mesh over ``jax.devices()[:4]`` with
  ``param_shardings``, and ``--fsdp`` against JAX's step with
  ``fsdp_shardings`` there: the loss and every updated parameter within
  1e-4, JAX's tolerance. Against the port's one-process per-layer step on
  the 8 images: loss parts within 1e-5, each tensor's update within 1e-3
  (relative L2), for vitb, vitb_hybrid (its replicated weight-standardized
  stem) and vit_small with global-norm clipping and 2 accumulated
  micro-steps, whose clipped norm equals the one process's. The vitb
  job's checkpoint, restored in one process, plus one step, equals two
  JAX single-device steps within 1e-4.

JAX runs its per-layer branch on plain attention; the port's ranks take
the per-layer branch on K1f's entry (its plain version on the CPU), with
6 of vitb's 12 heads each. JAX's side runs while the ranks do; what
the tests read is reduced to the numbers they hold, so that the job's
directory stays small.
"""

import re
import shutil

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from acr_wsss_tpu import train as jax_train
from acr_wsss_tpu.configs import ModelConfig as JaxModelConfig
from acr_wsss_tpu.configs import TrainConfig as JaxTrainConfig
from acr_wsss_tpu.models.acr import ACR as JaxACR
from acr_wsss_tpu.parallel import batch_sharding, fsdp_shardings, param_shardings, replicated
from acr_wsss_tpu.parallel import make_mesh as jax_make_mesh
from acr_wsss_tpu_torch import train as port_train
from acr_wsss_tpu_torch.configs import ModelConfig, TrainConfig
from acr_wsss_tpu_torch.models.convert import _torch_key, state_dict_to_flax
from acr_wsss_tpu_torch.parallel.sharding import TP_RULES
from tests import torch_parallel_workers as workers
from tests.torch_port_helpers import build_acr_pair, flatten_params, run_once

CROP, BATCH, LR, MAX_STEP = 32, 8, 0.01, workers.MAX_STEP
TOL = 1e-4            # JAX's between its sharded and single-device steps
PORT_TOL = 1e-5       # the ranks' loss parts against the one process's
# Each tensor's update on the ranks against the one process's, relative
# L2 (tests/test_torch_parallel.py): float32 sums in another order, 3.4e-4
# at most here (the hybrid stem's GroupNorm biases); an update that missed
# a reduction, or took it twice, reads 0.1 or more.
PORT_UPDATE_REL = 1e-3


def _flax(state_dict, backbone):
    """``state_dict`` in the flat flax layout JAX's params have."""
    with torch.device("meta"):
        model = port_train.build_model(ModelConfig(backbone=backbone, compute_dtype="float32"))
    return state_dict_to_flax(model, state_dict)


def _port_rules(backbone="vitb"):
    """{parameter name: (dimension, groups)} of the port's TP_RULES."""
    with torch.device("meta"):
        model = port_train.build_model(ModelConfig(backbone=backbone, compute_dtype="float32"))
    out = {}
    for name, _ in model.named_parameters():
        for pattern, dim, groups in TP_RULES:
            if re.match(pattern, name):
                out[name] = (dim, groups)
    return out


def _worst(got, ref):
    """(whether the keys agree, the largest |got - ref| over every tensor)."""
    same = got.keys() == ref.keys()
    return same, max(float(np.max(np.abs(np.asarray(got[k]) - np.asarray(ref[k]))))
                     for k in ref if k in got)


def _jax_side(jax_model, params, batches):
    """JAX's vitb steps from ``params``: on the (2, 2) mesh with
    ``param_shardings`` and with ``fsdp_shardings``, and two single-device
    steps (batch 0, then batch 1)."""
    jcfg = JaxTrainConfig(model=JaxModelConfig(backbone="vitb", attn_impl="xla",
                                               compute_dtype="float32"),
                          crop_size=CROP, batch_size=BATCH, lr=LR, alpha=1.0)
    tx = jax_train.make_optimizer(jcfg.lr, MAX_STEP, jcfg.weight_decay, jcfg.momentum,
                                  jcfg.poly_power)
    state0 = jax_train.TrainState.create(apply_fn=jax_model.apply, params=params, tx=tx)
    step_fn = jax.jit(jax_train.make_train_step(jax_model, jcfg, (CROP // 16, CROP // 16)))
    jb = [{"image": jnp.asarray(batches[f"image{k}"]), "label": jnp.asarray(batches[f"label{k}"])}
          for k in range(2)]
    mesh = jax_make_mesh(workers.TP_MESH, workers.TP_AXES, devices=jax.devices()[:4])
    sharded = {k: jax.device_put(v, batch_sharding(mesh)) for k, v in jb[0].items()}
    out = {}
    for name, p_sh, o_sh in (
            ("tp", param_shardings(mesh, state0.params), replicated(mesh)),
            ("tp_fsdp", fsdp_shardings(mesh, state0.params),
             fsdp_shardings(mesh, state0.opt_state))):
        s = state0.replace(params=jax.device_put(state0.params, p_sh),
                           opt_state=jax.device_put(state0.opt_state, o_sh))
        s, parts = step_fn(s, sharded)
        out[name] = (float(parts["loss"]), flatten_params(jax.device_get(s.params)))
    s, _ = step_fn(state0, jb[0])
    s, _ = step_fn(s, jb[1])
    out["two_steps"] = flatten_params(jax.device_get(s.params))
    return out


def _build(tmp):
    """The job and JAX's side; ``summary.pt`` keeps what the tests hold."""
    rng = np.random.default_rng(0)
    batches = {}
    for k in range(2):
        batches[f"image{k}"] = rng.normal(size=(BATCH, CROP, CROP, 3)).astype(np.float32)
        label = np.zeros((BATCH, 20), np.float32)
        label[np.arange(BATCH), rng.integers(0, 20, BATCH)] = 1.0
        batches[f"label{k}"] = label
    np.savez(tmp / "batches.npz", **batches)
    cfg = TrainConfig(model=ModelConfig(backbone="vitb", compute_dtype="float32"),
                      crop_size=CROP, batch_size=BATCH, lr=LR, alpha=1.0, device="cpu")
    jax_model, params, port = build_acr_pair(CROP, seed=3, backbone="vitb")
    torch.save(port.state_dict(), workers.weights_file(str(tmp), "vitb"))
    del port
    ctx = mp.spawn(workers.tp_job, args=(4, str(tmp / "store"), str(tmp), cfg), nprocs=4,
                   join=False)
    jax_out = _jax_side(jax_model, params, batches)
    while not ctx.join(timeout=600):
        pass
    summary = {}
    for name in workers.TP_JAX:
        out = torch.load(tmp / f"{name}.pt", weights_only=True)
        loss, jparams = jax_out[name]
        same, worst = _worst(_flax(out.pop("params"), "vitb"), jparams)
        summary[name] = {**out, "loss_err": abs(out["history"][0]["loss"] - loss),
                         "same_keys": same, "worst": worst}
    for name in workers.TP_ONE:
        summary.setdefault(name, torch.load(tmp / f"{name}.pt", weights_only=True))
        summary[name]["one"] = torch.load(tmp / f"one_{name}.pt", weights_only=True)
    resumed = torch.load(tmp / f"resumed_{workers.TP_RESUMED}.pt", weights_only=True)
    same, worst = _worst(_flax(resumed.pop("params"), "vitb"), jax_out["two_steps"])
    summary["resumed"] = {**resumed, "same_keys": same, "worst": worst}
    for f in list(tmp.iterdir()):
        if f.is_dir():
            shutil.rmtree(f)
        else:
            f.unlink()
    torch.save(summary, tmp / "summary.pt")


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    path = run_once(tmp_path_factory, "tensor_parallel_job", _build)
    return torch.load(path / "summary.pt", weights_only=True)


def test_rules_map_onto_jax_param_shardings():
    """Every flax path that ``param_shardings`` puts on the model axis, and
    no other, is a parameter of the port's TP_RULES, on the transposed
    dimension for a Dense kernel; qkv's cut is in 3 groups (per head
    within q, k and v), every other one contiguous."""
    jax_model = JaxACR(backbone_name="vitb", dtype=jnp.float32, attn_impl="xla")
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.key(0),
                                                   jnp.zeros((1, CROP, CROP, 3))))
    mesh = jax_make_mesh((-1, 2), ("data", "model"))
    flat = jax.tree_util.tree_flatten_with_path(param_shardings(mesh, shapes),
                                                is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    leaves = {"/".join(str(getattr(k, "key", k)) for k in path): s for path, s in flat}
    jax_cut = {}
    for path, sharding in leaves.items():
        spec = tuple(sharding.spec)
        if "model" in spec:
            dim = spec.index("model")
            ndim = len(flatten_params(shapes)[path].shape)
            jax_cut[_torch_key(path)] = ndim - 1 - dim if path.endswith("/kernel") else dim
    port = _port_rules()
    assert len(jax_cut) == 6 * 12
    assert {k: d for k, (d, _) in port.items()} == jax_cut
    assert {k for k, (_, g) in port.items() if g == 3} == {
        k for k in port if re.search(r"\.attn\.qkv\.", k)}
    assert all(g == 1 for k, (_, g) in port.items() if ".attn.qkv." not in k)


def test_the_job_cuts_what_the_rules_name(job):
    """The ranks' vitb carries a cut on exactly the rules' parameters, each
    half its one-device size on its dimension; under --fsdp no parameter
    is cut and the qkv weight is FSDP's half."""
    with torch.device("meta"):
        ref = dict(port_train.build_model(ModelConfig(backbone="vitb")).named_parameters())
    cut = job["tp"]["cut"]
    assert {k: v[:2] for k, v in cut.items()} == _port_rules()
    for name, (dim, _, shape) in cut.items():
        full = list(ref[name].shape)
        full[dim] //= workers.TP_MESH[1]
        assert list(shape) == full, name
    assert job["tp_fsdp"]["cut"] == {}
    assert job["tp_fsdp"]["qkv_local"] * 2 == ref["trunk.blocks.0.attn.qkv.weight"].numel()


@pytest.mark.parametrize("case", workers.TP_JAX)
def test_tp_step_matches_jax(job, case):
    out = job[case]
    assert out["same_keys"]
    assert out["loss_err"] < TOL, out["loss_err"]
    assert out["worst"] < TOL, out["worst"]


@pytest.mark.parametrize("case", workers.TP_ONE)
def test_tp_step_matches_one_process(job, case):
    """Loss parts of each micro-step, and each tensor's update."""
    out = job[case]
    for got, ref in zip(out["history"], out["one"]["history"], strict=True):
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=PORT_TOL, err_msg=k)
    rel = out["one"]["update_rel"]
    worst = max(rel, key=rel.get)
    assert rel[worst] < PORT_UPDATE_REL, (worst, rel[worst])


def test_clipped_norm_is_the_one_process_norm(job):
    """Global-norm clipping on the model mesh takes the one-device model's
    norm (the cut parts summed over the model ranks, the replicated ones
    once), and it clips."""
    out = job["tp_clip_accum"]
    assert len(out["norms"]) == len(out["one"]["norms"]) == 1
    np.testing.assert_allclose(out["norms"], out["one"]["norms"], rtol=PORT_TOL)
    assert out["norms"][0] > 1.0


def test_elastic_resume_matches_two_jax_steps(job):
    """data=2,model=2 -> checkpoint in the one-device layout -> 1 process:
    the restored step continues the schedule and the momentum."""
    out = job["resumed"]
    assert (out["restored_step"], out["updates"]) == (0, 2)
    assert out["same_keys"]
    assert out["worst"] < TOL, out["worst"]
