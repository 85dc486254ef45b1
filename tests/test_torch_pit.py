"""The port's PiT and the standalone-model zoo against the JAX package's,
on the CPU.

* ``models/pit.py``: ``ConvPool`` on an input whose channels all differ
  (the depthwise kernel's channel order), and the forward (logits, every
  block's probabilities, the grid; the head and distillation logits) of a
  small PiT with head dim 16, plain and distilled, through either
  ``attn_impl`` (on CPU tensors "kernel" takes K1's plain version);
* ``models/convert.py``: the timm PiT mapper against JAX's, plain and
  distilled, on hand-built timm state dicts; the convert CLI on a
  full-width ``pit_ti_224`` checkpoint;
* ``models/zoo.py``: ``graft_standalone`` against JAX's on a head of
  another class count and on a position embedding resized up and down
  (JAX's bilinear resize antialiases when it shrinks);
* the registry: every PiT name takes the kernel; the full-width ``pit_b``
  and ``pit_b_distilled_224``'s parameter names and shapes against
  ``jax.eval_shape`` of the flax init.

Float32 on both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acr_wsss_tpu.models import pit as jax_pit
from acr_wsss_tpu.models import zoo as jax_zoo
from acr_wsss_tpu.models.convert import pit_state_dict_to_flax as jax_pit_to_flax
from acr_wsss_tpu.models.registry import model_entrypoint as jax_entrypoint
from acr_wsss_tpu_torch.models import convert, pit, registry, zoo
from acr_wsss_tpu_torch.models.convert import (flax_to_state_dict, pit_state_dict_to_flax,
                                               state_dict_to_flax)
from acr_wsss_tpu_torch.utils.checkpoint import load_params_npz
from tests.torch_port_helpers import flatten_params, random_flax_params, unflatten_params

SMALL = dict(num_classes=20, patch_size=8, stride=4, base_dims=(16, 16, 16), depths=(1, 2, 1),
             heads=(2, 4, 8))
CROP = 40                                  # grid 9 -> 5 -> 3
# float32 on both sides, the same products in another order
ATOL = 1e-5


def _image(batch, crop, seed=1):
    x = np.random.default_rng(seed).normal(size=(batch, crop, crop, 3)).astype(np.float32)
    return x * np.asarray([1.0, 0.5, 2.0], np.float32) + np.asarray([0.3, -0.2, 0.1],
                                                                    np.float32)


def test_conv_pool_matches_jax():
    """4 -> 8 channels on a 5x7 grid, every channel of the input its own
    scale and offset: output channel o reads input channel o // 2."""
    jm = jax_pit.ConvPool(8, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 35, 4)) * [1, 2, 3, 4] + [0, 5, -5, 10]).astype(np.float32)
    cls = rng.normal(size=(2, 1, 4)).astype(np.float32)
    flat = random_flax_params(jm, jnp.asarray(x), 0, args=(jnp.asarray(cls), (5, 7)))
    want = jm.apply(unflatten_params(flat), jnp.asarray(x), jnp.asarray(cls), (5, 7))
    pm = pit.ConvPool(4, 8)
    pm.load_state_dict(flax_to_state_dict(flat, pm.state_dict()))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(cls), (5, 7))
    assert got[2] == tuple(want[2]) == (3, 4)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=ATOL)


@pytest.fixture(scope="module")
def pit_case():
    cache = {}

    def get(distilled):
        if distilled not in cache:
            jm = jax_pit.PoolingVisionTransformer(distilled=distilled, dtype=jnp.float32,
                                                  **SMALL)
            flat = random_flax_params(jm, jnp.zeros((1, CROP, CROP, 3)), int(distilled))
            x = _image(2, CROP)
            out = jax.jit(jm.apply)(unflatten_params(flat), jnp.asarray(x))
            cache[distilled] = (flat, x, jax.tree.map(np.asarray, out))
        return cache[distilled]

    return get


@pytest.mark.parametrize("attn_impl", ["plain", "kernel"])
@pytest.mark.parametrize("distilled", [False, True], ids=["plain", "distilled"])
def test_pit_forward_matches_jax(pit_case, distilled, attn_impl):
    flat, x, ref = pit_case(distilled)
    pm = pit.PoolingVisionTransformer(distilled=distilled, img_size=CROP, dtype=torch.float32,
                                      attn_impl=attn_impl, **SMALL)
    pm.load_state_dict(flax_to_state_dict(flat, pm.state_dict()))
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    assert set(out) == set(ref)
    assert tuple(out["grid"]) == tuple(int(g) for g in ref["grid"]) == (3, 3)
    keys = ("logits", "head_logits", "dist_logits") if distilled else ("logits",)
    for k in keys:
        np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=0, atol=ATOL, err_msg=k)
    assert len(out["probs_per_block"]) == len(ref["probs_per_block"]) == sum(SMALL["depths"])
    for got, want in zip(out["probs_per_block"], ref["probs_per_block"]):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_pit_registry_takes_the_kernel_where_the_head_dim_is_64():
    """Every PiT name takes the kernel: the forward kernel takes head dims
    64 (pit_b), 48 (pit_s, pit_xs) and 32 (pit_ti); one outside its range
    raises at construction and never falls back to plain."""
    with torch.device("meta"):
        for name in ("pit_b", "pit_b_distilled_224", "pit_s", "pit_xs_224",
                     "pit_ti_distilled_224", "pit_ti_224"):
            model = registry.create_model(name)
            assert {m.attn_impl for n, m in model.named_modules()
                    if n.endswith(".attn")} == {"kernel"}, name
        assert registry.create_model("pit_s", attn_impl="plain").stage1_block0.attn.attn_impl \
            == "plain"
        with pytest.raises(ValueError, match="head dim .*got 40"):
            registry.create_model("pit_xs_224", base_dims=(40, 40, 40))


# --- the timm mapper, the convert CLI, the graft -----------------------------

def _timm_pit_state_dict(patch, base_dims, depths, heads, num_classes, grid, distilled,
                         seed=0):
    """A timm-named PiT state dict with seeded values (NCHW pos_embed)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, *shape):
        sd[name] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    dims = [b * h for b, h in zip(base_dims, heads)]
    put("pos_embed", 1, dims[0], grid, grid)
    put("cls_token", 1, 2 if distilled else 1, dims[0])
    put("patch_embed.conv.weight", dims[0], 3, patch, patch)
    put("patch_embed.conv.bias", dims[0])
    for s, (dim, depth) in enumerate(zip(dims, depths)):
        for b in range(depth):
            pre = f"transformers.{s}.blocks.{b}."
            for n in ("norm1", "norm2"):
                put(pre + n + ".weight", dim)
                put(pre + n + ".bias", dim)
            put(pre + "attn.qkv.weight", 3 * dim, dim)
            put(pre + "attn.qkv.bias", 3 * dim)
            put(pre + "attn.proj.weight", dim, dim)
            put(pre + "attn.proj.bias", dim)
            put(pre + "mlp.fc1.weight", 4 * dim, dim)
            put(pre + "mlp.fc1.bias", 4 * dim)
            put(pre + "mlp.fc2.weight", dim, 4 * dim)
            put(pre + "mlp.fc2.bias", dim)
        if s < len(dims) - 1:
            put(f"transformers.{s}.pool.conv.weight", dims[s + 1], 1, 3, 3)
            put(f"transformers.{s}.pool.conv.bias", dims[s + 1])
            put(f"transformers.{s}.pool.fc.weight", dims[s + 1], dim)
            put(f"transformers.{s}.pool.fc.bias", dims[s + 1])
    put("norm.weight", dims[-1])
    put("norm.bias", dims[-1])
    heads_out = ("head", "head_dist") if distilled else ("head",)
    for h in heads_out:
        put(f"{h}.weight", num_classes, dims[-1])
        put(f"{h}.bias", num_classes)
    return sd


@pytest.mark.parametrize("distilled", [False, True], ids=["plain", "distilled"])
def test_pit_mapper_matches_jax(distilled):
    sd = _timm_pit_state_dict(8, (16, 16, 16), (1, 2, 1), (2, 4, 8), 1000, 9, distilled)
    got = pit_state_dict_to_flax(sd)
    want = flatten_params(jax_pit_to_flax(sd))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    pm = pit.PoolingVisionTransformer(**{**SMALL, "num_classes": 1000}, distilled=distilled,
                                      img_size=CROP)
    pm.load_state_dict(flax_to_state_dict(got, pm.state_dict()))


def test_convert_cli_writes_a_full_width_pit_npz(tmp_path):
    """pit_ti_224's timm checkpoint (1000 classes, grid 27) through the CLI:
    the npz is the mapper's dict and fills the registry's model; ``--scan``
    is refused."""
    sd = _timm_pit_state_dict(16, (32, 32, 32), (2, 6, 4), (2, 4, 8), 1000, 27, False)
    torch.save({"model": sd}, tmp_path / "pit.pth")
    convert.main([str(tmp_path / "pit.pth"), str(tmp_path / "pit.npz"),
                  "--backbone", "pit_ti_224"])
    flat = load_params_npz(str(tmp_path / "pit.npz"))
    want = pit_state_dict_to_flax(sd)
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)
    model = registry.create_model("pit_ti_224", attn_impl="plain")
    model.load_state_dict(flax_to_state_dict(flat, model.state_dict()))
    with pytest.raises(SystemExit):
        convert.main([str(tmp_path / "pit.pth"), str(tmp_path / "x.npz"), "--backbone",
                      "pit_ti_224", "--scan"])


def _jax_pit_params(distilled, crop, num_classes, seed):
    jm = jax_pit.PoolingVisionTransformer(**{**SMALL, "num_classes": num_classes},
                                          distilled=distilled, dtype=jnp.float32)
    return random_flax_params(jm, jnp.zeros((1, crop, crop, 3)), seed)


@pytest.mark.parametrize("case", ["head", "pos_up", "pos_down"])
def test_graft_standalone_matches_jax(case):
    """The target model at crop 40 (grid 9, 20 classes); the zoo entry at
    1000 classes (``head``) or at crop 24 (grid 5) / crop 64 (grid 15) with
    the target's classes: pos_embed resized up or down."""
    src_crop, src_classes = {"head": (CROP, 1000), "pos_up": (24, 20),
                             "pos_down": (64, 20)}[case]
    target = _jax_pit_params(False, CROP, 20, 0)
    source = _jax_pit_params(False, src_crop, src_classes, 1)
    source["params/not_in_the_model/bias"] = np.zeros(3, np.float32)
    want = flatten_params(jax_zoo.graft_standalone(unflatten_params(target),
                                                   unflatten_params(source), verbose=False))
    model = pit.PoolingVisionTransformer(img_size=CROP, dtype=torch.float32, **SMALL)
    model.load_state_dict(flax_to_state_dict(target, model.state_dict()))
    got = state_dict_to_flax(zoo.graft_standalone(model, source, verbose=False))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    resized = case != "head"
    assert np.array_equal(got["params/pos_embed"], source["params/pos_embed"]) != resized
    assert np.array_equal(got["params/head/kernel"], target["params/head/kernel"]) != resized


@pytest.mark.parametrize("name", ["pit_b", "pit_b_distilled_224"])
def test_full_width_pit_b_matches_the_flax_init_shapes(name):
    jm = jax_entrypoint(name)(num_classes=20)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 224, 224, 3))))
    want = {k: tuple(v.shape) for k, v in flatten_params(shapes).items()}
    got = {k: v.shape for k, v in state_dict_to_flax(
        registry.create_model(name, num_classes=20)).items()}
    assert got == want
