"""The port's Swin slice against the JAX package's, on the CPU.

* ``models/swin.py``: window partition and reverse, the relative-position
  index and the shift mask, and the forward (logits, every block's window
  probabilities, the stage features, the grid) of a small Swin on shared
  numpy weights at three inputs: crop 32 (window 4, shifted blocks the
  consistency un-mirrors), crop 20 (window padding, an odd grid at the
  merge, a later stage whose window is its grid) and crop 36 with window
  3 (an odd window's shifted block, which the step skips);
* ``losses.py``: ``hflip_window_permutations`` (and where it raises) and
  ``swin_window_consistency_loss``;
* ``train_swin.py``: ``swin_block_layout`` (swin_base_384 at crop 384
  included), one train step at lr 0.01 against JAX's
  ``make_swin_train_step`` (loss parts and every parameter after the
  update), and the CLI: 2 steps, the npz applied by the JAX model, a
  SIGTERM that leaves the snapshot and no final npz;
* ``models/convert.py``: the timm Swin mapper against JAX's on a
  hand-built timm state dict; ``models/registry.py``: every Swin and PiT
  name with the JAX builder's defaults; the full-width ``swin_base_384``'s
  parameter names and shapes against ``jax.eval_shape`` of the flax init.

Float32 on both sides. JAX's jitted ``apply`` and its outputs are shared
across a case's tests (module fixtures).
"""

import os
import signal

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp
import torch

from acr_wsss_tpu import losses as jax_losses
from acr_wsss_tpu import train_swin as jax_train_swin
from acr_wsss_tpu.configs import ModelConfig as JaxModelConfig
from acr_wsss_tpu.configs import TrainConfig as JaxTrainConfig
from acr_wsss_tpu.models import pit as jax_pit
from acr_wsss_tpu.models import swin as jax_swin
from acr_wsss_tpu.models.convert import swin_state_dict_to_flax as jax_swin_to_flax
from acr_wsss_tpu.models.registry import model_entrypoint as jax_entrypoint
from acr_wsss_tpu.train import TrainState as JaxTrainState
from acr_wsss_tpu.utils.schedule import make_optimizer as jax_make_optimizer
from acr_wsss_tpu_torch import losses, train_swin
from acr_wsss_tpu_torch.configs import TrainConfig
from acr_wsss_tpu_torch.models import registry, swin
from acr_wsss_tpu_torch.models.convert import (flax_to_state_dict, state_dict_to_flax,
                                               swin_state_dict_to_flax)
from acr_wsss_tpu_torch.utils.schedule import make_optimizer
from tests.torch_port_helpers import flatten_params, random_flax_params, unflatten_params

SMALL = dict(num_classes=20, embed_dim=16, depths=(2, 2), num_heads=(2, 4))
# crop, window size
CASES = {"crop32": (32, 4), "crop20": (20, 4), "crop36_ws3": (36, 3)}
# float32 on both sides, the same products in another order: measured
# 4.8e-7 (logits), 2.7e-7 (probs), 3.2e-6 (stage features, values up to ~10)
ATOL, FEAT_ATOL, FEAT_RTOL = 1e-5, 2e-5, 1e-5


def _pair(crop, ws, seed=0):
    """(JAX module, flat weights, port model) in float32 on shared weights."""
    jm = jax_swin.SwinTransformer(window_size=ws, dtype=jnp.float32, **SMALL)
    flat = random_flax_params(jm, jnp.zeros((1, crop, crop, 3)), seed)
    pm = swin.SwinTransformer(window_size=ws, img_size=crop, dtype=torch.float32, **SMALL)
    pm.load_state_dict(flax_to_state_dict(flat, pm.state_dict()))
    return jm, flat, pm


def _image(batch, crop, seed=1):
    x = np.random.default_rng(seed).normal(size=(batch, crop, crop, 3)).astype(np.float32)
    return x + np.asarray([0.3, -0.2, 0.1], np.float32)     # channels not alike


@pytest.fixture(scope="module")
def forward_case():
    cache = {}

    def get(name):
        if name not in cache:
            crop, ws = CASES[name]
            jm, flat, pm = _pair(crop, ws)
            x = _image(2, crop)
            out = jax.jit(jm.apply)(unflatten_params(flat), jnp.asarray(x))
            cache[name] = (pm, x, jax.tree.map(np.asarray, out))
        return cache[name]

    return get


def test_window_partition_and_reverse_match_jax():
    x = np.random.default_rng(0).normal(size=(2, 8, 12, 3)).astype(np.float32)
    windows = swin.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(windows.numpy(),
                                  np.asarray(jax_swin.window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(swin.window_reverse(windows, 4, 8, 12).numpy(), x)


@pytest.mark.parametrize("ws,shift,grid", [(4, 2, (8, 8)), (3, 1, (6, 9)), (12, 6, (24, 24))])
def test_relative_position_index_and_shift_mask_match_jax(ws, shift, grid):
    np.testing.assert_array_equal(swin.relative_position_index(ws),
                                  jax_swin.relative_position_index(ws))
    np.testing.assert_array_equal(swin.shift_mask(*grid, ws, shift),
                                  np.asarray(jax_swin._shift_mask(*grid, ws, shift)))


@pytest.mark.parametrize("case", list(CASES))
def test_swin_forward_matches_jax(forward_case, case):
    pm, x, ref = forward_case(case)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    assert tuple(out["grid"]) == tuple(int(g) for g in ref["grid"])
    np.testing.assert_allclose(out["logits"].numpy(), ref["logits"], rtol=0, atol=ATOL)
    assert len(out["window_probs"]) == len(ref["window_probs"]) == sum(SMALL["depths"])
    for got, want in zip(out["window_probs"], ref["window_probs"]):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    for got, want in zip(out["stage_features"], ref["stage_features"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=FEAT_RTOL, atol=FEAT_ATOL)


def test_swin_export_modes(forward_case):
    """"none" exports nothing; "full" the per-head probs (B, nW, heads, N,
    N), whose head mean is "mean"'s. JAX's block reshapes the full export
    to the head mean's shape and raises, so "full" is held to "mean"."""
    pm, x, ref = forward_case("crop32")
    with torch.no_grad():
        none = pm(torch.from_numpy(x), export="none")
        full = pm(torch.from_numpy(x), export="full")
    assert none["window_probs"] == []
    np.testing.assert_allclose(none["logits"].numpy(), ref["logits"], rtol=0, atol=ATOL)
    for got, want, heads in zip(full["window_probs"], ref["window_probs"], (2, 2, 4, 4)):
        assert got.shape[2] == heads
        np.testing.assert_allclose(got.mean(2).numpy(), want, rtol=0, atol=ATOL)


def test_table_gather_backward_matches_index_backward():
    """The bias gather's backward (fixed-order sums) against autograd's
    scatter-add of ``table[index]``, window 5 (each row used 1-25 times)."""
    attn = swin.WindowAttention(8, 2, 5)
    table = torch.randn(81, 2, dtype=torch.float64, requires_grad=True)
    g = torch.randn(625, 2, dtype=torch.float64)
    got, = torch.autograd.grad(swin._TableGather.apply(
        table, attn.relative_position_index, attn.table_groups), table, g)
    want, = torch.autograd.grad(table[attn.relative_position_index], table, g)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_cols,ws,shift", [(2, 4, 0), (2, 4, 2), (3, 4, 2), (4, 12, 6),
                                             (3, 3, 0), (2, 3, 1), (4, 7, 3)])
def test_hflip_window_permutations_match_jax(n_cols, ws, shift):
    if shift and (2 * shift) % ws:
        with pytest.raises(ValueError, match="2\\*shift % ws == 0"):
            losses.hflip_window_permutations(n_cols, ws, shift)
        with pytest.raises(ValueError):
            jax_losses.hflip_window_permutations(n_cols, ws, shift)
        return
    for got, want in zip(losses.hflip_window_permutations(n_cols, ws, shift),
                         jax_losses.hflip_window_permutations(n_cols, ws, shift)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_rows,n_cols,ws,shift", [(2, 2, 4, 0), (2, 3, 4, 2), (1, 2, 12, 6),
                                                    (2, 2, 3, 0)])
def test_swin_window_consistency_loss_matches_jax(n_rows, n_cols, ws, shift):
    rng = np.random.default_rng(n_cols * 10 + shift)
    shape = (2, n_rows * n_cols, ws * ws, ws * ws)
    p1, p2 = (rng.random(shape, dtype=np.float32) for _ in range(2))
    got = losses.swin_window_consistency_loss(torch.from_numpy(p1), torch.from_numpy(p2),
                                              n_rows, n_cols, ws, shift)
    want = jax_losses.swin_window_consistency_loss(jnp.asarray(p1), jnp.asarray(p2), n_rows,
                                                   n_cols, ws, shift=shift)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_swin_window_consistency_loss_raises_on_an_odd_shifted_window():
    p = torch.zeros(1, 4, 9, 9)
    with pytest.raises(ValueError, match="2\\*shift % ws == 0"):
        losses.swin_window_consistency_loss(p, p, 2, 2, 3, shift=1)


@pytest.mark.parametrize("name,crop", [("swin_base_384", 384), ("swin_tiny", 224),
                                       ("small_ws4", 32), ("small_ws4", 20),
                                       ("small_ws3", 36)])
def test_swin_block_layout_matches_jax(name, crop):
    if name.startswith("small"):
        ws = int(name[-1])
        jm = jax_swin.SwinTransformer(window_size=ws, **SMALL)
        with torch.device("meta"):
            pm = swin.SwinTransformer(window_size=ws, img_size=crop, **SMALL)
    else:
        jm = jax_entrypoint(name)()
        with torch.device("meta"):
            pm = registry.create_model(name, img_size=crop)
    layout = train_swin.swin_block_layout(pm, crop)
    assert layout == jax_train_swin.swin_block_layout(jm, crop)
    if name == "swin_base_384":
        # the last stage's grid is its window: unshifted; every block covered
        assert layout[-2:] == [(1, 1, 12, 0), (1, 1, 12, 0)]
        assert train_swin.consistency_blocks(layout) == list(range(24))
    if name == "small_ws3":
        assert train_swin.consistency_blocks(layout) == [0, 2]


def test_swin_train_step_matches_jax():
    """One step at lr 0.01 (crop 32, window 4, batch 2): loss parts and every
    parameter after the update against JAX's ``make_swin_train_step``."""
    crop, lr = 32, 0.01
    jm, flat, pm = _pair(crop, 4, seed=3)
    image = _image(2, crop, seed=5)
    label = np.zeros((2, 20), np.float32)
    label[0, [3, 7]] = label[1, 11] = 1.0

    jcfg = JaxTrainConfig(model=JaxModelConfig(backbone="swin"), crop_size=crop,
                          batch_size=2, lr=lr)
    state = JaxTrainState.create(
        apply_fn=jm.apply, params=unflatten_params(flat),
        tx=jax_make_optimizer(lr, 10, jcfg.weight_decay, jcfg.momentum, jcfg.poly_power))
    step = jax.jit(jax_train_swin.make_swin_train_step(jm, jcfg, crop))
    state, jparts = step(state, {"image": jnp.asarray(image), "label": jnp.asarray(label)})

    cfg = TrainConfig(crop_size=crop, batch_size=2, lr=lr, device="cpu")
    opt = make_optimizer(pm.parameters(), lr, 10, cfg.weight_decay, cfg.momentum,
                         cfg.poly_power)
    port_step = train_swin.make_swin_train_step(pm, opt, cfg, crop, torch.device("cpu"))
    assert port_step.blocks == [0, 1, 2, 3]
    parts = port_step({"image": image, "label": label})
    for k, v in parts.items():
        np.testing.assert_allclose(v.item(), float(jparts[k]), rtol=2e-5, err_msg=k)
    assert float(jparts["window_consistency"]) > 0
    want = flatten_params(state.params)
    got = state_dict_to_flax(pm)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4, atol=2e-6,
                                   err_msg=k)


# --- the timm mapper and the registry ---------------------------------------

def _timm_swin_state_dict(embed_dim, depths, num_heads, ws, num_classes, grid, seed=0):
    """A timm-named Swin state dict with seeded values, buffers included."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, *shape):
        sd[name] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    put("patch_embed.proj.weight", embed_dim, 3, 4, 4)
    put("patch_embed.proj.bias", embed_dim)
    put("patch_embed.norm.weight", embed_dim)
    put("patch_embed.norm.bias", embed_dim)
    dim = embed_dim
    for s, (depth, heads) in enumerate(zip(depths, num_heads)):
        w = min(ws, grid)
        for b in range(depth):
            pre = f"layers.{s}.blocks.{b}."
            for n in ("norm1", "norm2"):
                put(pre + n + ".weight", dim)
                put(pre + n + ".bias", dim)
            put(pre + "attn.qkv.weight", 3 * dim, dim)
            put(pre + "attn.qkv.bias", 3 * dim)
            put(pre + "attn.proj.weight", dim, dim)
            put(pre + "attn.proj.bias", dim)
            put(pre + "attn.relative_position_bias_table", (2 * w - 1) ** 2, heads)
            sd[pre + "attn.relative_position_index"] = torch.zeros(w * w, w * w,
                                                                   dtype=torch.long)
            if b % 2:
                sd[pre + "attn_mask"] = torch.zeros(4, w * w, w * w)
            put(pre + "mlp.fc1.weight", 4 * dim, dim)
            put(pre + "mlp.fc1.bias", 4 * dim)
            put(pre + "mlp.fc2.weight", dim, 4 * dim)
            put(pre + "mlp.fc2.bias", dim)
        if s < len(depths) - 1:
            put(f"layers.{s}.downsample.norm.weight", 4 * dim)
            put(f"layers.{s}.downsample.norm.bias", 4 * dim)
            put(f"layers.{s}.downsample.reduction.weight", 2 * dim, 4 * dim)
            dim, grid = 2 * dim, (grid + 1) // 2
    put("norm.weight", dim)
    put("norm.bias", dim)
    put("head.weight", num_classes, dim)
    put("head.bias", num_classes)
    return sd


def test_swin_mapper_matches_jax():
    sd = _timm_swin_state_dict(16, (2, 2), (2, 4), 4, 1000, grid=8)
    got = swin_state_dict_to_flax(sd)
    want = flatten_params(jax_swin_to_flax(sd))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and the port's model takes every entry, in its shape
    pm = swin.SwinTransformer(**{**SMALL, "num_classes": 1000}, window_size=4, img_size=32)
    pm.load_state_dict(flax_to_state_dict(got, pm.state_dict()))


@pytest.mark.parametrize("name", registry.list_models(module="swin")
                         + registry.list_models(module="pit"))
def test_registry_names_build_with_the_jax_defaults(name):
    want = jax_entrypoint(name)()
    with torch.device("meta"):
        got = registry.create_model(name)
    assert got.head.out_features == want.num_classes
    if name.startswith("swin"):
        assert (got.embed_dim, got.depths, got.num_heads, got.window_size, got.patch_size) == (
            want.embed_dim, tuple(want.depths), tuple(want.num_heads), want.window_size,
            want.patch_size)
    else:
        assert isinstance(want, jax_pit.PoolingVisionTransformer)
        assert got.distilled == want.distilled and got.depths == tuple(want.depths)
        assert got.patch_embed.stride[0] == want.stride
        assert got.patch_embed.kernel_size[0] == want.patch_size
        heads = [getattr(got, f"stage{s}_block0").attn.num_heads for s in range(3)]
        assert heads == list(want.heads)
        assert got.pos_embed.shape[-1] == want.base_dims[0] * want.heads[0]


def test_registry_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="Known: .*swin_base_384"):
        registry.create_model("swin_huge")


def test_full_width_swin_base_384_matches_the_flax_init_shapes():
    jm = jax_entrypoint("swin_base_384")(num_classes=20)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 384, 384, 3))))
    want = {k: tuple(v.shape) for k, v in flatten_params(shapes).items()}
    got = {k: v.shape for k, v in state_dict_to_flax(
        registry.create_model("swin_base_384", num_classes=20)).items()}
    assert got == want


# --- the CLI -----------------------------------------------------------------

TINY = "swin_test_tiny"


@pytest.fixture
def tiny_swin(monkeypatch):
    """A small Swin under a registry name, for the CLI."""
    def builder(**kwargs):
        return swin.SwinTransformer(**{**SMALL, "window_size": 4, **kwargs})

    monkeypatch.setitem(registry._MODELS, TINY, builder)
    return TINY


@pytest.fixture(scope="module")
def voc_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("swin_voc")
    rng = np.random.default_rng(0)
    (root / "img").mkdir()
    labels = {}
    for i, (h, w) in enumerate(((40, 52), (36, 36), (50, 44), (44, 60))):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "img" / f"s{i}.jpg")
        labels[f"s{i}"] = np.eye(20, dtype=np.float32)[[i, 2 * i + 5]].sum(0)
    np.save(root / "cls_labels.npy", labels)
    (root / "train.txt").write_text("s0\ns1\n")
    return root


def _argv(root, weight_dir, *extra):
    return ["--model", TINY, "--batch_size", "2", "--max_epoches", "1", "--crop_size", "32",
            "--IMpath", str(root / "img"), "--train_list", str(root / "train.txt"),
            "--cls_labels", str(root / "cls_labels.npy"), "--weight_dir", str(weight_dir),
            "--session_name", "sw", "--device", "cpu", *extra]


@pytest.mark.parametrize("device_aug", [False, True], ids=["host", "device_aug"])
def test_train_swin_cli_writes_an_npz_the_jax_model_applies(tiny_swin, voc_dir, tmp_path,
                                                            device_aug):
    extra = ["--device_aug", "--aug_pad", "64"] if device_aug else []
    state = train_swin.main(_argv(voc_dir, tmp_path, *extra))
    assert state.steps == 2                    # 2 images, batch 2: 1 update, 2 steps
    for parts in state.history:
        assert all(np.isfinite(v) for v in parts.values())
        assert parts["window_consistency"] > 0
    path = tmp_path / "sw_last.npz"
    assert path.exists() and not (tmp_path / "sw_snapshot.npz").exists()
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    x = _image(1, 32, seed=9)
    jm = jax_swin.SwinTransformer(window_size=4, dtype=jnp.float32, **SMALL)
    want = jm.apply(unflatten_params(flat), jnp.asarray(x))["logits"]
    pm = swin.SwinTransformer(window_size=4, img_size=32, dtype=torch.float32, **SMALL)
    pm.load_state_dict(flax_to_state_dict(flat, pm.state_dict()))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_train_swin_sigterm_leaves_the_snapshot_and_no_final_npz(tiny_swin, voc_dir, tmp_path,
                                                                 monkeypatch):
    orig_add = train_swin.AverageMeter.add
    calls = []

    def add_then_sigterm(self, values):
        orig_add(self, values)
        calls.append(1)
        if len(calls) == 1:
            signal.raise_signal(signal.SIGTERM)

    monkeypatch.setattr(train_swin.AverageMeter, "add", add_then_sigterm)
    before = signal.getsignal(signal.SIGTERM)
    state = train_swin.main(_argv(voc_dir, tmp_path, "--save_every", "0"))
    assert state.steps == 1
    assert (tmp_path / "sw_snapshot.npz").exists()
    assert not (tmp_path / "sw_last.npz").exists()
    assert signal.getsignal(signal.SIGTERM) == before
    with np.load(tmp_path / "sw_snapshot.npz") as f:
        saved = {k: f[k] for k in f.files}
    for k, v in state_dict_to_flax(state.model).items():
        np.testing.assert_array_equal(saved[k], v, err_msg=k)


def test_pretrained_grafts_the_zoo_npz_but_the_head(tiny_swin, tmp_path, monkeypatch):
    """``--pretrained``: the zoo npz of the model (1000 classes) over the
    seeded init; the 20-class head keeps the init."""
    src = swin.SwinTransformer(**{**SMALL, "num_classes": 1000}, window_size=4, img_size=32)
    zoo_flat = state_dict_to_flax(src)
    np.savez(tmp_path / f"{TINY}_in21k.npz", **zoo_flat)
    monkeypatch.setenv("ACR_WSSS_ZOO", str(tmp_path))
    cfg = TrainConfig(crop_size=32, device="cpu", seed=2)
    model, _ = train_swin.create_swin_train_state(cfg, 10, TINY, pretrained=True)
    fresh, _ = train_swin.create_swin_train_state(cfg, 10, TINY)
    got, init = state_dict_to_flax(model), state_dict_to_flax(fresh)
    for k, v in got.items():
        np.testing.assert_array_equal(v, init[k] if "/head/" in k else zoo_flat[k], err_msg=k)


def test_train_swin_module_runs_on_the_cpu(voc_dir, tmp_path):
    """``python -m acr_wsss_tpu_torch.train_swin --device cpu`` as a user runs
    it (swin_tiny at crop 32, 2 images, batch 2: 2 steps): it exits 0, and
    its ``_last.npz`` has the names and shapes of the JAX ``swin_tiny``'s
    init at crop 32 (the tests above apply the JAX model to the CLI's npz
    of a smaller Swin)."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = _argv(voc_dir, tmp_path)
    argv[argv.index(TINY)] = "swin_tiny"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "acr_wsss_tpu_torch.train_swin", *argv],
                          cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "model saved" in proc.stdout
    with np.load(tmp_path / "sw_last.npz") as f:
        got = {k: f[k].shape for k in f.files}
    jm = jax_entrypoint("swin_tiny")(num_classes=20)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
    assert got == {k: tuple(v.shape) for k, v in flatten_params(shapes).items()}
