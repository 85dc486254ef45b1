"""The port's timm ResNet families and the ViT hybrids on their ResNet-D
stem against the JAX package's, on the CPU.

* ``models/resnet_timm.py``: ``TimmResNet`` at one block per stage and a
  32x32 input, every structural variant of the constructor in six cases
  (basic blocks with blur pooling; grouped bottlenecks with the deep stem,
  average-pool downsampling and SE by reduction; the tiered stem with ECA;
  ResNet-RS's stem-pool conv with SE by ratio; SENet's
  ``block_reduce_first=2`` and 3x3 downsample kernels with blur; a pruned
  width table), eval forwards in float32 (logits, features, the four
  taps) with weights and BatchNorm statistics crossing by
  ``flax_to_state_dict`` (the train-mode step is ``test_torch_cnn``'s); the
  registry's 66 names built on the meta device and their configuration
  table equal to JAX's ``_TIMM_RESNET_CFGS``;
* ``models/convert.timm_resnet_state_dict_to_flax`` against JAX's on a
  synthetic timm state dict (numpy), key by key, and ``zoo``'s routing;
* ``models/hybrid.TimmResNetStem`` under the ViT names on it: the two
  small ones (both stems, both taps) at two blocks and a 32x32 input
  against JAX's forward, all four against JAX's configuration; its
  BatchNorms stay on their running statistics in training mode.

Tolerances: ``tests/torch_port_helpers.CNN_REL`` (1e-5 of the largest
|value|) for the CNNs; the ViT classifiers' (``test_torch_vit_classifier``)
for the hybrids, whose 16-block stem sums in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acr_wsss_tpu.models import convert as jax_convert
from acr_wsss_tpu.models import registry as jax_registry
from acr_wsss_tpu.models import resnet_timm as jax_resnet_timm
from acr_wsss_tpu_torch.models import registry, resnet_timm, zoo
from acr_wsss_tpu_torch.models.convert import (flax_to_state_dict, state_dict_to_flax,
                                               timm_resnet_state_dict_to_flax)
from tests.torch_port_helpers import (_draw_flax_params, assert_cnn_matches_jax,
                                      assert_same_flat, cnn_pair, jit_o0, unflatten_params)
from tests.test_torch_vit_classifier import F32_ATOL, STEM_ATOL

L1 = (1, 1, 1, 1)
_D = dict(stem_width=32, stem_type="deep", avg_down=True)
_T = dict(stem_width=32, stem_type="deep_tiered", avg_down=True)
VARIANTS = {
    "basic_blur": dict(bottleneck=False, blur=True),
    "resnext_d_se": dict(cardinality=2, base_width=32, attn="se", **_D),
    "t_eca": dict(attn="eca", **_T),
    "rs_se_ratio": dict(attn="se", se_ratio=0.25, replace_stem_pool=True, **_D),
    "senet_blur": dict(cardinality=2, base_width=32, stem_type="deep", down_kernel_size=3,
                       block_reduce_first=2, attn="se", blur=True),
    "pruned_eca": dict(attn="eca", block_overrides=((20, 12, 40), (30, 20, 90), (40, 30, 100),
                                                    (50, 40, 120)), **_D),
}


def _models(kw, num_classes=10):
    kw = dict(layers=L1, num_classes=num_classes, **kw)
    return (jax_resnet_timm.TimmResNet(dtype=jnp.float32, **kw),
            resnet_timm.TimmResNet(dtype=torch.float32, **kw))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_timm_resnet_matches_jax(variant):
    jm, tm = _models(VARIANTS[variant])
    flat = cnn_pair(jm, tm, 32)
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    assert_cnn_matches_jax(jm, flat, tm, x)


def test_registry_holds_the_66_names_and_jax_cfgs():
    names = registry.list_models(module="resnet_timm")
    assert len(names) == 66
    assert set(names) == set(jax_registry.list_models(module="resnet_timm"))
    assert resnet_timm._TIMM_RESNET_CFGS == jax_resnet_timm._TIMM_RESNET_CFGS
    assert resnet_timm._ECARESNET50D_PRUNED == jax_resnet_timm._ECARESNET50D_PRUNED
    assert resnet_timm._ECARESNET101D_PRUNED == jax_resnet_timm._ECARESNET101D_PRUNED
    with torch.device("meta"):
        for name in names:
            model = registry.create_model(name)
            cfg = resnet_timm._TIMM_RESNET_CFGS.get(name, {})
            layers = cfg.get("layers", (3, 4, 23, 3) if "101" in name else (3, 4, 6, 3))
            assert sum(map(len, model.stage_blocks)) == sum(layers), name
            assert model.fc.out_features == 1000
    with pytest.raises(NotImplementedError, match="bn_axis_name"):
        registry.create_model("resnet26d", bn_axis_name="data")


def _timm_state_dict(rng):
    """A timm ResNet state dict with every name layout the mapper reads:
    the deep stem, the ResNet-RS stem pool, a conv and an average-pool
    downsample, SE and ECA, BatchNorm with ``num_batches_tracked``."""
    def bn(prefix, n=4):
        return {f"{prefix}.weight": rng.normal(size=n), f"{prefix}.bias": rng.normal(size=n),
                f"{prefix}.running_mean": rng.normal(size=n),
                f"{prefix}.running_var": rng.uniform(size=n),
                f"{prefix}.num_batches_tracked": np.asarray(3)}

    def conv(name, k=3):
        return {name: rng.normal(size=(4, 3, k, k))}

    sd = {**conv("conv1.0.weight"), **bn("conv1.1"), **conv("conv1.3.weight"), **bn("conv1.4"),
          **conv("conv1.6.weight"), **bn("bn1"), **conv("maxpool.0.weight"), **bn("maxpool.1"),
          "fc.weight": rng.normal(size=(5, 4)), "fc.bias": rng.normal(size=5)}
    for block, ds in (("layer1.0", ("0", "1")), ("layer2.0", ("1", "2"))):
        for i in (1, 2, 3):
            sd.update(conv(f"{block}.conv{i}.weight", 1 + 2 * (i == 2)))
            sd.update(bn(f"{block}.bn{i}"))
        sd.update(conv(f"{block}.downsample.{ds[0]}.weight", 1))
        sd.update(bn(f"{block}.downsample.{ds[1]}"))
    sd.update({"layer1.0.se.fc1.weight": rng.normal(size=(2, 4, 1, 1)),
               "layer1.0.se.fc1.bias": rng.normal(size=2),
               "layer1.0.se.fc2.weight": rng.normal(size=(4, 2, 1, 1)),
               "layer1.0.se.fc2.bias": rng.normal(size=4),
               "layer2.0.se.conv.weight": rng.normal(size=(1, 1, 5))})
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def test_timm_resnet_mapper_matches_jax():
    sd = _timm_state_dict(np.random.default_rng(0))
    assert_same_flat(timm_resnet_state_dict_to_flax(sd),
                      jax_convert.timm_resnet_state_dict_to_flax(sd))


def test_zoo_routes_as_jax():
    """Each name to the mapper JAX's ``convert_state_dict`` picks: a timm
    ResNet constructor name before the torchvision prefix rule."""
    from acr_wsss_tpu.models import zoo as jax_zoo

    sd = _timm_state_dict(np.random.default_rng(1))
    for name in ("resnet50d", "seresnext26d_32x4d", "gluon_resnet50_v1c", "resnetblur50"):
        assert_same_flat(zoo.convert_state_dict(name, sd), jax_zoo.convert_state_dict(name, sd))
    tv = {"conv1.weight": np.ones((4, 3, 7, 7), np.float32), "fc.weight": np.ones((2, 4)),
          "fc.bias": np.ones(2), "layer1.0.downsample.0.weight": np.ones((4, 4, 1, 1))}
    for name in ("resnet50", "tv_resnext50_32x4d", "wide_resnet50_2", "ig_resnext101_32x8d"):
        assert_same_flat(zoo.convert_state_dict(name, tv), jax_zoo.convert_state_dict(name, tv))
    with pytest.raises(ValueError, match="no timm checkpoint mapper"):
        zoo.convert_state_dict("acr_vitb", tv)


HYBRIDS = {
    "vit_small_resnet26d_224": 96,
    "vit_small_resnet50d_s16_224": 96,
    "vit_base_resnet26d_224": 64,
    "vit_base_resnet50d_224": 64,
}


def test_resnet_d_hybrid_names_are_jax_configurations():
    """All four names: the JAX builder's width, depth, heads, MLP ratio,
    stem variant, patch size and grid are the port's model's. The two
    base names run the small names' code (the 26d stem tapped at stage 3,
    the 50d stem) at ViT-B's widths, which the classifier tests hold
    against JAX."""
    for name, head_dim in HYBRIDS.items():
        jm = jax_registry.model_entrypoint(name)()
        with torch.device("meta"):
            trunk = registry.create_model(name).trunk
        block, stem = trunk.blocks[0], trunk.backbone
        assert (len(trunk.blocks), block.attn.num_heads, block.attn.qkv.in_features,
                block.mlp.fc1.out_features) == (jm.depth, jm.num_heads, jm.embed_dim,
                                                int(jm.embed_dim * jm.mlp_ratio)), name
        assert block.attn.scale == head_dim ** -0.5 and trunk.patch_size == jm.patch_size
        assert trunk.pos_embed.shape[1] == jm.pretrain_grid ** 2 + 1
        assert stem.out_index == (2 if jm.stem_variant == "resnet50d_s16" else 3)
        assert [len(b) for b in stem.backbone.stage_blocks] == (
            [2, 2, 2, 2] if jm.stem_variant == "resnet26d" else [3, 4, 6, 3])


@pytest.mark.parametrize("name", ["vit_small_resnet26d_224", "vit_small_resnet50d_s16_224"])
def test_resnet_d_hybrids_match_jax(name):
    """Two blocks over the ResNet-D stem, 32x32: logits and the tokens (both
    stems, both taps, head dim 96). The stem's BatchNorms use their running
    statistics in training mode too (JAX calls the stem with
    ``train=False``). The weights are drawn in the port's flax layout
    (JAX's apply reads every one of them; the full-size layout is held to
    JAX's init in ``test_torch_registry``)."""
    kw = dict(depth=2, num_classes=10)
    tm = registry.create_model(name, dtype=torch.float32, **kw)
    flat = _draw_flax_params({k: v.shape for k, v in state_dict_to_flax(tm).items()}, 0)
    tm.load_state_dict(flax_to_state_dict(flat, tm.state_dict()))
    jm = jax_registry.model_entrypoint(name)(dtype=jnp.float32, attn_impl="xla", **kw)
    assert tm.trunk.blocks[0].attn.scale == HYBRIDS[name] ** -0.5
    assert any(k.startswith("batch_stats/trunk/backbone/backbone/") for k in flat)
    tm.train()
    assert not tm.trunk.backbone.backbone.training
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = jit_o0(jm.apply)(unflatten_params(flat), jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for k in ("logits", "features"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=STEM_ATOL if "50d" in name else F32_ATOL, err_msg=k)
    assert tuple(got["grid"]) == tuple(want["grid"])
