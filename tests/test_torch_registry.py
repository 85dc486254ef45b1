"""The port's model registry, data configurations, ResNetV2 and BiT
classifiers, feature extractor, timm mappers and zoo against the JAX
package's, on the CPU.

* ``models/registry.py``: the query helpers and ``models/cfg.py``'s
  ``default_cfg`` against JAX's for every name the port registers (262:
  41 ViT/DeiT, 14 ResNetV2/BiT, 24 Swin and PiT, 47 ResNet/VGG/DenseNet,
  66 timm ResNets, 32 EfficientNet/MobileNetV3/RegNet, 33 SENet/SKNet/
  Res2Net/ResNeSt, 5 ACR); ``create_model`` builds every ViT/DeiT and
  ResNetV2/BiT name, their parameters against ``jax.eval_shape`` of the
  flax init for one name of each layout; a JAX name the port lacks and
  the ``hf_hub:`` source refuse;
* ``models/hybrid.py``: ``ResNetV2`` and ``BiTResNetV2`` at two stages
  against JAX's (logits, features, taps);
* ``models/features.py``: ``FeatureExtractor`` as a list, a dict, with
  ``out_indices`` and ``out_map``, against JAX's, its ``feature_info``;
  the ViT refusal;
* ``models/convert.py``: the ViT/DeiT and BiT mappers against JAX's on
  the same synthetic timm state dicts, leaf for leaf; the convert CLI;
* ``checkpoint_path`` (``.npz`` and timm ``.pth``), ``zoo.fetch`` from a
  ``file://`` URL and ``pretrained=True`` from a zoo directory holding the
  upstream file (a BiT ``.npz`` in TF's layout).

Float32 on both sides.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acr_wsss_tpu.models import convert as jax_convert
from acr_wsss_tpu.models import hybrid as jax_hybrid
from acr_wsss_tpu.models import registry as jax_registry
from acr_wsss_tpu_torch.models import convert, hybrid, registry, zoo
from acr_wsss_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from acr_wsss_tpu_torch.models.acr import init_random_
from acr_wsss_tpu_torch.utils.checkpoint import load_params_npz, save_params_npz
from chip_smoke import timm_vit_state_dict
from tests.torch_port_helpers import flatten_params, random_flax_params, unflatten_params

# float32: the frameworks sum in other orders. Logits: 1e-4 absolute (as
# tests/test_torch_vit_classifier.py). Stage maps: each convolution sums
# up to 4.6k products in another order, and a pre-activation network's
# residual stream grows from stage to stage (|values| up to about 25 at
# four stages): 5e-5 of the map's largest |value|.
ATOL, MAP_REL = 1e-4, 5e-5


def _assert_map_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=MAP_REL * np.abs(want).max())


def _jax_names():
    import acr_wsss_tpu.models.acr  # noqa: F401  (they register)
    import acr_wsss_tpu.models.cnn  # noqa: F401
    import acr_wsss_tpu.models.cnn_attn  # noqa: F401
    import acr_wsss_tpu.models.cnn_mobile  # noqa: F401
    import acr_wsss_tpu.models.hybrid  # noqa: F401
    import acr_wsss_tpu.models.pit  # noqa: F401
    import acr_wsss_tpu.models.resnet_timm  # noqa: F401
    import acr_wsss_tpu.models.swin  # noqa: F401
    import acr_wsss_tpu.models.vit_classifier  # noqa: F401
    return set(jax_registry._model_entrypoints)


PORTED = registry.list_models()
CLASSIFIERS = registry.list_models(module="vit_classifier") + registry.list_models(
    module="hybrid")


def test_the_registry_holds_the_ported_names():
    assert len(registry.list_models(module="vit_classifier")) == 41
    assert len(registry.list_models(module="hybrid")) == 14
    assert len(PORTED) == 262 and set(PORTED) <= _jax_names()
    for module in ("vit_classifier", "hybrid", "cnn", "resnet_timm", "cnn_mobile", "cnn_attn",
                   "acr"):
        assert registry.list_models(module=module) == jax_registry.list_models(module=module)


def test_query_helpers_match_jax():
    _jax_names()
    for name in PORTED:
        assert registry.is_model(name) and jax_registry.is_model(name)
        assert registry.is_model_pretrained(name) == jax_registry.is_model_pretrained(name), name
        module = jax_registry._model_to_module[name]
        assert registry.is_model_in_modules(name, [module])
        assert not registry.is_model_in_modules(name, ("cnn_misc",))
        for key in ("url", "num_classes", "crop_pct", "mean", "first_conv"):
            assert registry.has_model_default_key(name, key) == \
                jax_registry.has_model_default_key(name, key)
            assert registry.is_model_default_key(name, key) == \
                jax_registry.is_model_default_key(name, key)
            assert registry.get_model_default_value(name, key) == \
                jax_registry.get_model_default_value(name, key), (name, key)
    for kw in (dict(filter="vit_*"), dict(filter="*deit*", pretrained=True),
               dict(module="pit"), dict(module="swin", exclude_filters="*in22k"),
               dict(filter="resnetv2_*", exclude_filters=["*x3*", "*x4*"]),
               dict(pretrained=True)):
        assert registry.list_models(**kw) == [n for n in jax_registry.list_models(**kw)
                                              if n in PORTED], kw
    assert set(registry.list_modules()) == {"acr", "cnn", "cnn_attn", "cnn_mobile", "hybrid", "pit",
                                            "resnet_timm", "swin", "vit_classifier"}
    assert not registry.is_model("cspresnet50") and registry.get_default_cfg("cspresnet50") is None
    for name in ("hf_hub:timm/vit_huge_patch14_224_in21k", "timm:vit_small_patch16_224",
                 "vit_base_patch16_224_in21k", "org/Model-v1.5"):
        assert registry.split_model_name(name) == jax_registry.split_model_name(name)
        for remove in (True, False):
            assert registry.safe_model_name(name, remove) == \
                jax_registry.safe_model_name(name, remove)


def test_default_cfg_matches_jax_for_every_ported_name():
    from acr_wsss_tpu.models.cfg import default_cfg as jax_cfg
    from acr_wsss_tpu_torch.models.cfg import default_cfg

    for name in PORTED:
        assert default_cfg(name) == jax_cfg(name), name
        assert registry.get_default_cfg(name) == jax_registry.get_default_cfg(name), name


def test_create_model_builds_every_classifier_name():
    """Every ViT/DeiT and ResNetV2/BiT name at its registered defaults (on
    the meta device): its head's class count is its default cfg's, every
    ViT block on the kernel at a head dim the kernel takes."""
    with torch.device("meta"):
        for name in CLASSIFIERS:
            model = registry.create_model(name)
            assert model.head.out_features == registry.get_default_cfg(name)["num_classes"]
            if name.startswith("vit_"):
                assert {b.attn.attn_impl for b in model.trunk.blocks} == {"kernel"}


@pytest.mark.parametrize("name", ["vit_small_patch16_224", "vit_deit_base_distilled_patch16_384",
                                  "vit_base_r50_s16_224_in21k", "resnetv2_50x1_bitm_in21k",
                                  "vit_small_resnet50d_s16_224"])
def test_full_size_parameters_match_the_flax_init(name):
    """One name of each layout: no qkv bias and head dim 96; the dist token
    and ``head_dist``; the R50 stem and ``pre_logits``; BiT; the ResNet-D
    stem (its BatchNorm statistics, its unused last stage and head)."""
    jm = jax_registry.create_model(name)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3))))
    want = {k: tuple(v.shape) for k, v in flatten_params(shapes).items()}
    with torch.device("meta"):
        model = registry.create_model(name)
    got = {k: tuple(v.shape) for k, v in state_dict_to_flax(
        model, {k: torch.empty(v.shape) for k, v in model.state_dict().items()}).items()}
    assert got == want


def test_unported_names_and_sources_refuse():
    import acr_wsss_tpu.models.cnn_misc  # noqa: F401  (registers cspresnet50)

    assert jax_registry.is_model("cspresnet50") and not registry.is_model("cspresnet50")
    with pytest.raises(ValueError, match="Unknown model"):
        registry.create_model("cspresnet50")
    with pytest.raises(NotImplementedError, match="hf_hub"):
        registry.create_model("hf_hub:timm/vit_huge_patch14_224_in21k")


# --- ResNetV2 and BiT -------------------------------------------------------

def _image(crop=64, seed=1):
    return np.random.default_rng(seed).normal(size=(2, crop, crop, 3)).astype(np.float32)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


CNN_CASES = {
    "resnetv2": (jax_hybrid.ResNetV2, hybrid.ResNetV2,
                 dict(layers=(1, 2), channels=(128, 256), stem_chs=32, num_classes=10)),
    "bit": (jax_hybrid.BiTResNetV2, hybrid.BiTResNetV2,
            dict(layers=(2, 1), channels=(64, 128), width_factor=2, num_classes=10)),
}


@pytest.mark.parametrize("case", list(CNN_CASES))
def test_resnetv2_and_bit_match_jax(case):
    jax_cls, port_cls, kw = CNN_CASES[case]
    jm = jax_cls(dtype=jnp.float32, **kw)
    x = _image()
    flat = random_flax_params(jm, jnp.asarray(x), seed=3)
    want = jax.jit(jm.apply)(unflatten_params(flat), jnp.asarray(x))
    model = port_cls(dtype=torch.float32, **kw)
    model.load_state_dict(flax_to_state_dict(flat, model.state_dict()))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), rtol=0,
                               atol=ATOL)
    _assert_map_close(got["features"], want["features"])
    assert list(got["taps"]) == list(want["taps"])
    for k in want["taps"]:
        _assert_map_close(got["taps"][k], want["taps"][k])


# --- features_only ----------------------------------------------------------

FX_ARCH = dict(layers=(1, 1, 1, 1), channels=(128, 128, 256, 256), num_classes=10)


@functools.lru_cache(maxsize=None)
def _bit_pyramid():
    """(flat weights, image, JAX's model output) of the small BiT that every
    ``features_only`` case wraps: one jitted apply shared by the cases."""
    jm = jax_registry.create_model("resnetv2_50x1_bitm_in21k", dtype=jnp.float32,
                                   features_only=True, **FX_ARCH).model
    x = _image()
    flat = random_flax_params(jm, jnp.asarray(x), seed=4)
    return flat, x, jax.jit(jm.apply)(unflatten_params(flat), jnp.asarray(x))


@pytest.mark.parametrize("kw", [dict(), dict(out_indices=(1, 3)),
                                dict(out_indices=(0, 2), feature_cls="dict"),
                                dict(out_indices=(0, 3), out_map=("low", "high"))],
                         ids=["list", "out_indices", "dict", "out_map"])
def test_feature_extractor_matches_jax(kw):
    """The port's extractor against JAX's: JAX's ``FeatureExtractor.apply``
    is the wrapped model's apply and then its ``_select``, here on the
    shared output."""
    flat, x, jax_out = _bit_pyramid()
    jfx = jax_registry.create_model("resnetv2_50x1_bitm_in21k", dtype=jnp.float32,
                                    features_only=True, **FX_ARCH, **kw)
    want = jfx._select(jax_out)
    fx = registry.create_model("resnetv2_50x1_bitm_in21k", dtype=torch.float32,
                               features_only=True, **FX_ARCH, **kw)
    fx.model.load_state_dict(flax_to_state_dict(flat, fx.model.state_dict()))
    with torch.no_grad():
        got = fx(torch.from_numpy(x))
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want) == list(kw.get("out_map", kw["out_indices"]))
        got, want = list(got.values()), list(want.values())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_map_close(g, w)
    info = fx.feature_info(input_size=64)
    assert info == [{"reduction": 64 // w.shape[1], "num_chs": w.shape[-1]} for w in want]


def test_feature_extractor_refuses_vit():
    fx = registry.create_model("vit_deit_tiny_patch16_224", depth=1, features_only=True)
    with pytest.raises(RuntimeError, match="features_only"):
        fx(torch.zeros((1, 64, 64, 3)))
    with pytest.raises(RuntimeError, match="features_only"):
        fx.feature_info(64)


# --- the timm mappers, the CLI, checkpoint_path and the zoo -----------------

def _vit_state(name, seed, **kw):
    """(model, timm-layout state dict) of a seeded ViT classifier."""
    model = init_random_(registry.create_model(name, dtype=torch.float32, **kw), seed=seed)
    state = timm_vit_state_dict(state_dict_to_flax(model))
    state["bkg_token"] = torch.zeros(1, 1, 8)            # a name off the classifier: dropped
    return model, state


def _bit_state(model):
    """``model``'s (a ``BiTResNetV2``) weights under timm's names."""
    out = {}
    for k, v in model.state_dict().items():
        if k.startswith("head."):
            v = v[:, :, None, None] if k.endswith("weight") else v
            out[k.replace("head.", "head.fc.")] = v
            continue
        k = k.replace("stem_conv.", "stem.conv.").replace("downsample_conv", "downsample.conv")
        if k[0] == "s" and k[1].isdigit():
            stage, rest = k.split(".", 1)
            s, b = stage[1:].split("_b")
            k = f"stages.{s}.blocks.{b}.{rest}"
        out[k] = v.clone()
    return out


def _bit_tf_npz(state):
    """timm's BiT names as the official release's TF ``.npz`` keys (HWIO)."""
    top = {"stem.conv.weight": "root_block/standardized_conv2d/kernel",
           "norm.weight": "group_norm/gamma", "norm.bias": "group_norm/beta",
           "head.fc.weight": "head/conv2d/kernel", "head.fc.bias": "head/conv2d/bias"}
    sub = {"1": "a", "2": "b", "3": "c"}
    out = {}
    for k, v in state.items():
        v = v.numpy()
        v = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v
        if k in top:
            name = top[k]
        else:
            _, s, _, b, rest = k.split(".", 4)
            unit = f"block{int(s) + 1}/unit{int(b) + 1:02d}"
            if rest == "downsample.conv.weight":
                name = f"{unit}/a/proj/standardized_conv2d/kernel"
            elif rest.startswith("conv"):
                name = f"{unit}/{sub[rest[4]]}/standardized_conv2d/kernel"
            else:
                name = f"{unit}/{sub[rest[4]]}/group_norm/" + (
                    "gamma" if rest.endswith("weight") else "beta")
        out["resnet/" + name] = v
    return out


def _assert_same_leaves(got, want_tree):
    want = {"params/" + k if not k.startswith("params/") else k: np.asarray(v)
            for k, v in flatten_params(want_tree).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("name,kw", [
    ("vit_deit_small_distilled_patch16_224", dict(depth=2)),
    ("vit_base_r50_s16_224_in21k", dict(depth=1, num_classes=10)),
    ("vit_base_patch16_224_miil", dict(depth=1))], ids=["distilled", "hybrid_in21k", "miil"])
def test_vit_mapper_matches_jax(name, kw):
    model, state = _vit_state(name, seed=5, **kw)
    got = convert.vit_timm_state_dict_to_flax(state)
    _assert_same_leaves(got, jax_convert.vit_timm_state_dict_to_flax(
        {k: v.numpy() for k, v in state.items()}))
    fresh = registry.create_model(name, dtype=torch.float32, **kw)
    fresh.load_state_dict(flax_to_state_dict(got, fresh.state_dict()))
    for k, v in model.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k


def test_bit_mappers_match_jax():
    model = init_random_(registry.create_model("resnetv2_50x1_bitm_in21k", dtype=torch.float32,
                                               layers=(2, 1), num_classes=10), seed=6)
    state = _bit_state(model)
    got = convert.resnetv2_bit_state_dict_to_flax(state)
    _assert_same_leaves(got, jax_convert.resnetv2_bit_state_dict_to_flax(
        {k: v.numpy() for k, v in state.items()}))
    npz = _bit_tf_npz(state)
    renamed = convert.bit_npz_to_torch_names(npz)
    want = jax_convert.bit_npz_to_torch_names(npz)
    assert set(renamed) == set(want) == set(state)
    for k in want:
        assert np.array_equal(renamed[k], want[k]) and np.array_equal(renamed[k],
                                                                      state[k].numpy()), k


def _assert_same_weights(a, b):
    sb = b.state_dict()
    for k, v in a.state_dict().items():
        assert torch.equal(v, sb[k]), k


@pytest.mark.parametrize("suffix", [".npz", ".pth"])
def test_checkpoint_path_loads_the_weights(tmp_path, suffix):
    name, kw = "vit_deit_tiny_distilled_patch16_224", dict(depth=1)
    model, state = _vit_state(name, seed=7, **kw)
    path = str(tmp_path / f"ckpt{suffix}")
    if suffix == ".npz":
        save_params_npz(path, state_dict_to_flax(model))
    else:
        torch.save({"state_dict": state}, path)
    loaded = registry.create_model(name, checkpoint_path=path, dtype=torch.float32, **kw)
    _assert_same_weights(model, loaded)


def test_checkpoint_path_and_features_only_load_the_wrapped_model(tmp_path):
    model = init_random_(registry.create_model("resnetv2_50x1_bitm_in21k", layers=(1, 1),
                                               num_classes=10), seed=8)
    path = str(tmp_path / "bit.pth")
    torch.save({"model": _bit_state(model)}, path)
    fx = registry.create_model("resnetv2_50x1_bitm_in21k", layers=(1, 1), num_classes=10,
                               features_only=True, checkpoint_path=path, out_indices=(1,))
    _assert_same_weights(model, fx.model)
    with torch.no_grad():
        (feat,) = fx(torch.from_numpy(_image()))
        assert torch.equal(feat, model(torch.from_numpy(_image()))["taps"][1])
    with pytest.raises(ValueError, match="no timm checkpoint mapper"):
        registry.create_model("resnetv2_50", checkpoint_path=path)


def test_zoo_fetch_from_a_file_url_and_pretrained_from_the_zoo(tmp_path, monkeypatch):
    name, kw = "vit_deit_tiny_patch16_224", dict(depth=1)
    model, state = _vit_state(name, seed=9, **kw)
    src = tmp_path / "upstream" / "deit_tiny.pth"
    src.parent.mkdir()
    torch.save({"model": state}, src)
    zoo_dir = tmp_path / "zoo"
    out = zoo.fetch(name, str(zoo_dir), url=f"file://{src}")
    assert out == zoo.npz_path(name, str(zoo_dir)) and (zoo_dir / "deit_tiny.pth").exists()
    _assert_same_leaves(load_params_npz(out), jax_convert.vit_timm_state_dict_to_flax(
        {k: v.numpy() for k, v in state.items()}))
    assert zoo.fetch(name, str(zoo_dir)) == out                  # the cached npz
    monkeypatch.setenv("ACR_WSSS_ZOO", str(zoo_dir))
    loaded = registry.create_model(name, pretrained=True, dtype=torch.float32, **kw)
    _assert_same_weights(model, loaded)
    with pytest.raises(RuntimeError, match="downloads nothing"):
        zoo.fetch("vit_deit_small_patch16_224", str(zoo_dir))
    with pytest.raises(NotImplementedError, match="hf_hub"):
        zoo.fetch("vit_huge_patch14_224_in21k", str(zoo_dir))
    small = tmp_path / "small.pth"
    torch.save({"x": torch.zeros(4)}, small)
    with pytest.raises(RuntimeError, match="only"):
        zoo.fetch(name, str(tmp_path / "zoo2"), url=f"file://{small}")


def test_pretrained_bit_from_a_mirror_of_the_tf_release(tmp_path, monkeypatch):
    """A zoo directory holding the release's file under its upstream name
    (``BiT-M-R50x1.npz``, TF's layout) serves
    ``pretrained=True``; a head of another class count keeps the model's."""
    name, kw = "resnetv2_50x1_bitm_in21k", dict(layers=(1, 1, 1, 1), channels=(128, 256, 512, 1024))
    model = init_random_(registry.create_model(name, dtype=torch.float32, **kw), seed=10)
    upstream = os.path.basename(zoo.ZOO_URLS[name])
    np.savez(tmp_path / upstream, **_bit_tf_npz(_bit_state(model)))
    monkeypatch.setenv("ACR_WSSS_ZOO", str(tmp_path))
    loaded = registry.create_model(name, pretrained=True, dtype=torch.float32, **kw)
    _assert_same_weights(model, loaded)
    other = registry.create_model(name, pretrained=True, num_classes=7, **kw)
    assert other.head.out_features == 7
    assert torch.equal(other.stem_conv.weight, model.stem_conv.weight)


@pytest.mark.parametrize("name", ["vit_deit_tiny_distilled_patch16_224", "resnetv2_50x1_bitm"])
def test_convert_cli_writes_a_classifier_npz(tmp_path, name, capsys):
    """The CLI at the name's full width and depth: the npz loads into the
    registry's model and gives its weights back."""
    model = init_random_(registry.create_model(name, dtype=torch.float32), seed=11)
    state = (timm_vit_state_dict(state_dict_to_flax(model)) if name.startswith("vit_")
             else _bit_state(model))
    torch.save({"model": state}, tmp_path / "timm.pth")
    convert.main([str(tmp_path / "timm.pth"), str(tmp_path / "out.npz"), "--backbone", name])
    assert "standalone layout" in capsys.readouterr().out
    fresh = registry.create_model(name, dtype=torch.float32)
    fresh.load_state_dict(flax_to_state_dict(load_params_npz(str(tmp_path / "out.npz")),
                                             fresh.state_dict()))
    _assert_same_weights(model, fresh)
