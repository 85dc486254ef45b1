"""Shared set-up of the parity tests between the JAX package and its port.

Weights are made with numpy from a seed in the flax layout, flattened with
"/"-joined paths as ``save_params_npz`` writes them, and handed to both
sides: to JAX as a param tree, to the port through its converter.
``write_coco`` writes a tiny synthetic COCO layout (images, bbox txts).
``dpt_flax_params`` and ``jax_dpt_apply`` are cached per process, so the
segmentation test files that one worker runs trace and compile JAX's DPT
model once per backbone (and dtype). ``run_once`` builds a directory once
per test run, across pytest-xdist's workers.
"""

import fcntl
import functools
import os
import re
import shutil

import numpy as np
from PIL import Image

import jax
import jax.numpy as jnp
import torch

from acr_wsss_tpu.models.acr import ACR as JaxACR
from acr_wsss_tpu.models.dpt import DPTSegmentationModel as JaxDPT
from acr_wsss_tpu_torch.models.acr import ACR as TorchACR
from acr_wsss_tpu_torch.models.convert import flax_to_state_dict


def flatten_params(tree):
    """{"/".joined flax path: leaf}, as ``save_params_npz`` names them."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in flat}


def unflatten_params(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(value)
    return tree


def random_flax_params(jax_module, example, seed, args=()):
    """Seeded numpy weights in the flax layout of ``jax_module`` (called on
    ``example`` and ``args``): fan-in normal kernels, scales
    1 + N(0, 0.1^2), biases and tokens N(0, 0.1^2) (nonzero, so that a
    mapping mistake shows), pos_embed N(0, 0.02^2); BatchNorm's running
    statistics (``batch_stats``): means N(0, 0.1^2), variances U(0.5, 1.5)."""
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.key(0), example, *args))
    return _draw_flax_params({k: v.shape for k, v in flatten_params(shapes).items()}, seed)


def _draw_flax_params(shapes, seed):
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in shapes.items():
        name = key.rsplit("/", 1)[-1]
        if name == "kernel":
            val = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            val = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "pos_embed":
            val = 0.02 * rng.standard_normal(shape)
        elif name == "var":                       # BatchNorm's running variance
            val = 0.5 + rng.uniform(size=shape)
        else:
            val = 0.1 * rng.standard_normal(shape)
        flat[key] = val.astype(np.float32)
    return flat


@functools.lru_cache(maxsize=None)
def _dpt_param_shapes(backbone, crop):
    model = JaxDPT(backbone_name=backbone)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((1, crop, crop, 3))))
    return {k: v.shape for k, v in flatten_params(shapes).items()}


@functools.lru_cache(maxsize=None)
def dpt_flax_params(backbone, seed, crop=32):
    """``random_flax_params`` of JAX's ``DPTSegmentationModel``; callers
    must not modify the arrays."""
    return _draw_flax_params(_dpt_param_shapes(backbone, crop), seed)


@functools.lru_cache(maxsize=None)
def jax_dpt_apply(backbone, dtype="float32"):
    """The jitted ``apply`` of JAX's ``DPTSegmentationModel``."""
    return jax.jit(JaxDPT(backbone_name=backbone, dtype=getattr(jnp, dtype)).apply)


def assert_within_one_bf16_ulp(actual, desired, atol=1e-6):
    """|actual - desired| <= one bfloat16 ulp of desired (2^(e - 7) for
    |desired| in [2^e, 2^(e + 1))) + atol, elementwise."""
    actual = np.asarray(actual, np.float64)
    desired = np.asarray(desired, np.float64)
    assert actual.shape == desired.shape
    tiny = np.finfo(np.float32).tiny
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(desired), tiny))) - 7)
    err = np.abs(actual - desired)
    bad = err > ulp + atol
    assert not bad.any(), (f"{int(bad.sum())} of {bad.size} elements more than one bf16 ulp "
                           f"apart, max abs err {err.max():.3g}")


def build_acr_pair(crop, seed=0, backbone="vitb_hybrid", jax_impl="xla",
                   torch_impl="kernel"):
    """(jax model, jax params, port model) in float32 on shared weights."""
    jax_model = JaxACR(backbone_name=backbone, dtype=jnp.float32, attn_impl=jax_impl)
    flat = random_flax_params(jax_model, jnp.zeros((1, crop, crop, 3)), seed)
    port = TorchACR(backbone_name=backbone, dtype=torch.float32, attn_impl=torch_impl)
    port.load_state_dict(flax_to_state_dict(flat, port.state_dict()))
    port.requires_grad_(False).eval()
    return jax_model, unflatten_params(flat), port


def write_coco(root, seed=0, n_train=6, n_val=3):
    """Train and val image directories of small JPEGs and one bbox txt per
    image (``x y category_id ...`` lines, some repeated, one short line)."""
    from acr_wsss_tpu_torch.data import coco

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / split).mkdir(parents=True)
        for i in range(n):
            name = f"COCO_{split}2014_{i:012d}"
            h, w = ((48, 64), (64, 40), (40, 40))[i % 3]
            Image.fromarray(rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)).save(
                root / split / f"{name}.jpg")
            cats = rng.choice(coco.COCO_CATEGORY_IDS, size=int(rng.integers(1, 4)))
            lines = [f"{rng.integers(0, w)} {rng.integers(0, h)} {c} 5 5" for c in cats]
            (root / "bbox").mkdir(exist_ok=True)
            (root / "bbox" / f"{name}.txt").write_text("\n".join(lines + ["x"]) + "\n")
    (root / "train" / "notes.txt").write_text("not an image\n")
    return root


# float32 CNN forwards on both sides: each convolution sums in another
# order (a few float32 ulps), through up to a dozen BatchNorm'd layers ->
# 1e-5 of the output's largest |value| (1.3e-6 seen at layers (1, 1, 1, 1)).
CNN_REL = 1e-5
# Gradients through train-mode BatchNorm: its backward subtracts the batch
# means of the upstream gradient and of its product with the normalized
# input, float32 sums over every pixel that cancel to a small difference
# (2.2e-5 of the largest |gradient| seen) -> 1e-4 of the largest.
CNN_GRAD_REL = 1e-4


def run_once(tmp_path_factory, name, build):
    """``build(directory)`` once per test run, and the directory. Under
    pytest-xdist every worker that runs a test of a module runs its
    module-scoped fixtures, so a costly one (a spawned job of ranks)
    would run once per such worker: here the first worker builds under
    a file lock, in a directory that the run's workers share, and the
    others wait for it and read what it left. A failed build leaves no
    mark, and the next worker builds again."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / name
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (path / ".built").exists():
                shutil.rmtree(path, ignore_errors=True)
                path.mkdir()
                build(path)
                (path / ".built").touch()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def jit_o0(fn):
    """``jax.jit(fn)`` compiled with XLA's backend optimizations off: the
    same float32 operations (2e-6 apart from the optimized build on a
    hybrid's logits), in about half the compile time of the CNN parity
    tests' models."""
    def call(*args):
        return jax.jit(fn).lower(*args).compile(
            {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
        )(*args)
    return call


def assert_close_to_max(got, want, rel=CNN_REL, err_msg=""):
    """|got - want| <= rel * max|want|, elementwise."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=err_msg)


def assert_same_flat(got, want_tree):
    """The flat dict ``got`` holds exactly the leaves of the flax tree
    ``want_tree``, bit for bit (the checkpoint mappers)."""
    want = flatten_params(want_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def cnn_pair(jax_model, port_model, crop, seed=0):
    """``random_flax_params`` of ``jax_model`` (params and batch_stats),
    loaded into ``port_model``, which is put in eval mode (JAX's default
    ``train=False``). Returns the flat dict."""
    flat = random_flax_params(jax_model, jnp.zeros((1, crop, crop, 3)), seed)
    port_model.load_state_dict(flax_to_state_dict(flat, port_model.state_dict()))
    port_model.eval()
    return flat


def assert_cnn_matches_jax(jax_model, flat, port_model, x):
    """Logits, features and every tap of the port's eval forward (NCHW)
    against JAX's jitted apply (NHWC) on the NHWC image ``x``."""
    want = jit_o0(jax_model.apply)(unflatten_params(flat), jnp.asarray(x))
    with torch.no_grad():
        got = port_model(torch.from_numpy(x))
    assert_close_to_max(got["logits"].numpy(), want["logits"], err_msg="logits")
    assert_close_to_max(got["features"].permute(0, 2, 3, 1).numpy(), want["features"],
                        err_msg="features")
    assert sorted(got["taps"]) == sorted(want["taps"])
    for k in want["taps"]:
        assert_close_to_max(got["taps"][k].permute(0, 2, 3, 1).numpy(), want["taps"][k],
                            err_msg=f"tap {k}")


def cnn_train_step_matches_jax(jax_model, port_model, crop=32, seed=0, num_classes=6,
                               zero_grad=None):
    """One train-mode step as ``tests/test_cnn_models.py:359-388``: softmax
    cross entropy on two images, batch statistics on. The loss, every
    parameter's gradient and every updated running statistic of the port
    against ``jax.value_and_grad`` of JAX's; the statistics must move.
    ``zero_grad``: a regex of the parameters whose gradient is 0 in exact
    arithmetic (a BatchNorm's bias whose output reaches the loss only
    through a conv into another train-mode BatchNorm, which takes the mean
    out): both sides' are float32 rounding noise, held within
    CNN_GRAD_REL of the model's largest |gradient| instead of their own."""
    import optax

    from acr_wsss_tpu_torch.models.convert import state_dict_to_flax

    flat = cnn_pair(jax_model, port_model, crop, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(2, crop, crop, 3)).astype(np.float32)
    labels = np.asarray([1, 4])
    variables = unflatten_params(flat)

    def loss_fn(p, bs):
        out, upd = jax_model.apply({"params": p, "batch_stats": bs}, jnp.asarray(x),
                                   train=True, mutable=["batch_stats"])
        y = jax.nn.one_hot(jnp.asarray(labels), num_classes)
        return optax.softmax_cross_entropy(out["logits"], y).mean(), upd["batch_stats"]

    (loss, new_bs), grads = jit_o0(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    port_model.train()
    logits = port_model(torch.from_numpy(x))["logits"]
    loss_t = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss), rtol=1e-5)
    got = state_dict_to_flax(port_model, {k: p.grad for k, p in port_model.named_parameters()})
    want = flatten_params({"params": grads})
    assert sorted(got) == sorted(want)
    largest = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for k in want:
        if zero_grad is not None and re.search(zero_grad, k):
            for side in (got[k], want[k]):
                assert float(np.abs(np.asarray(side)).max()) <= CNN_GRAD_REL * largest, k
            continue
        assert_close_to_max(got[k], want[k], CNN_GRAD_REL, err_msg=k)
    stats = {k: v for k, v in state_dict_to_flax(port_model).items()
             if k.startswith("batch_stats/")}
    want_stats = flatten_params({"batch_stats": new_bs})
    assert sorted(stats) == sorted(want_stats)
    moved = False
    for k in want_stats:
        assert_close_to_max(stats[k], want_stats[k], err_msg=k)
        moved |= not np.allclose(stats[k], flat[k])
    assert moved
