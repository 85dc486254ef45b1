"""The port's classic CNN families (ResNet v1, VGG, DenseNet), its flax
BatchNorm, their mappers and the registry's ``acr_*`` names against the
JAX package's, on the CPU.

* ``models/layers.BatchNorm`` against flax's ``nn.BatchNorm`` in both
  modes: the batch's biased variance, momentum 0.9, float32 statistics on
  a bfloat16 input;
* ``models/cnn.py`` at one block per stage and a 32x32 input in float32:
  basic and bottleneck ResNets (ResNeXt cardinality and the wide base
  width in one),
  VGG with and without BatchNorm, a small DenseNet with the plain stem and
  one with the deep stem and the blurred stem pool (logits, features,
  taps), weights and statistics crossing by ``flax_to_state_dict``; one
  train-mode step against ``jax.value_and_grad``; the 47 names built on
  the meta device; ``features_only`` taps and ``feature_info``;
* the ResNet, DenseNet and VGG mappers against JAX's on synthetic
  torchvision state dicts (numpy), key by key, and ``state_dict_to_flax``
  giving back what ``flax_to_state_dict`` took;
* the five ``acr_*`` names.
"""

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acr_wsss_tpu.models import cnn as jax_cnn
from acr_wsss_tpu.models import convert as jax_convert
from acr_wsss_tpu.models import registry as jax_registry
from acr_wsss_tpu_torch.models import cnn, convert, registry
from acr_wsss_tpu_torch.models.layers import BatchNorm
from tests.torch_port_helpers import (assert_close_to_max, assert_cnn_matches_jax,
                                      assert_same_flat, cnn_pair, cnn_train_step_matches_jax,
                                      flatten_params)

L1 = (1, 1, 1, 1)
VGG_CFG = (16, "M", 32, "M", 32, 32, "M", 64, "M", 64, "M")
VARIANTS = {
    "resnet_basic": ("ResNet", dict(layers=L1, bottleneck=False)),
    # ResNeXt's groups and a base width other than 64 (the wide names') in
    # one model: mid width floor(64 * 32 / 64) * 4 = 128 over 4 groups in
    # stage 1, twice the plain bottleneck's, as wide_resnet50_2's
    "resnext_wide": ("ResNet", dict(layers=L1, cardinality=4, base_width=32)),
    "vgg": ("VGG", dict(cfg=VGG_CFG)),
    "vgg_bn": ("VGG", dict(cfg=VGG_CFG, batch_norm=True)),
    "densenet": ("DenseNet", dict(growth_rate=8, block_config=(1, 2, 1, 1))),
    "densenet_deep_blur": ("DenseNet", dict(growth_rate=8, block_config=L1, deep_stem=True,
                                            blur=True)),
}


def _models(cls, kw, num_classes=10):
    kw = dict(num_classes=num_classes, **kw)
    return (getattr(jax_cnn, cls)(dtype=jnp.float32, **kw),
            getattr(cnn, cls)(dtype=torch.float32, **kw))


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_flax(train):
    """Two train-mode calls (the running statistics move twice) or one eval
    call, on a bfloat16 NCHW input; the output is float32."""
    rng = np.random.default_rng(0)
    x = rng.normal(loc=0.5, size=(3, 5, 4, 6)).astype(np.float32)
    scale, bias = 1 + 0.1 * rng.normal(size=5), 0.1 * rng.normal(size=5)
    mean, var = 0.1 * rng.normal(size=5), 0.5 + rng.uniform(size=5)
    variables = {"params": {"scale": jnp.asarray(scale, jnp.float32),
                            "bias": jnp.asarray(bias, jnp.float32)},
                 "batch_stats": {"mean": jnp.asarray(mean, jnp.float32),
                                 "var": jnp.asarray(var, jnp.float32)}}
    bn_j = fnn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                         dtype=jnp.float32)
    bn_t = BatchNorm(5)
    for name, value in (("weight", scale), ("bias", bias), ("mean", mean), ("var", var)):
        getattr(bn_t, name).data.copy_(torch.from_numpy(value.astype(np.float32)))
    bn_t.train(train)
    x_j = jnp.asarray(x.transpose(0, 2, 3, 1), jnp.bfloat16)
    x_t = torch.from_numpy(x).bfloat16()
    for _ in range(2 if train else 1):
        want, upd = bn_j.apply(variables, x_j, mutable=["batch_stats"])
        variables = {**variables, **upd}
        got = bn_t(x_t)
        assert got.dtype == torch.float32
        assert_close_to_max(got.detach().permute(0, 2, 3, 1).numpy(), want)
    for name in ("mean", "var"):
        assert_close_to_max(getattr(bn_t, name).numpy(), variables["batch_stats"][name])
    if train:
        n = x.shape[0] * x.shape[2] * x.shape[3]
        assert not np.allclose(bn_t.var.numpy(), var * 0.81 + 0.19 * x.var(axis=(0, 2, 3)) *
                               n / (n - 1), rtol=1e-4)   # not PyTorch's unbiased update


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cnn_matches_jax(variant):
    jm, tm = _models(*VARIANTS[variant])
    flat = cnn_pair(jm, tm, 32)
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    assert_cnn_matches_jax(jm, flat, tm, x)


def test_cnn_train_step_matches_jax():
    """A basic-block ResNet: batch statistics, the running-statistic update
    and every gradient (JAX's "swap into a trainer" step on resnet50; the
    bottleneck's forward is ``test_cnn_matches_jax``'s)."""
    cnn_train_step_matches_jax(*_models("ResNet", dict(layers=L1, bottleneck=False),
                                        num_classes=6), crop=64)


def test_registry_holds_the_47_names_and_the_acr_names():
    import acr_wsss_tpu.models.acr  # noqa: F401  (they register)

    names = registry.list_models(module="cnn")
    assert len(names) == 47 and set(names) == set(jax_registry.list_models(module="cnn"))
    with torch.device("meta"):
        for name in names:
            model = registry.create_model(name, num_classes=7)
            head = {"VGG": "fc3", "DenseNet": "classifier"}.get(type(model).__name__, "fc")
            assert getattr(model, head).out_features == 7, name
        vgg = registry.create_model("vgg13_bn")
        assert vgg.batch_norm and hasattr(vgg, "bn9") and not hasattr(vgg, "bn10")
    acr_names = registry.list_models(module="acr")
    assert acr_names == jax_registry.list_models(module="acr") and len(acr_names) == 5
    with torch.device("meta"):
        model = registry.create_model("acr_deit_distilled", num_classes=3)
    assert model.trunk.num_prefix_tokens == 2 and model.cls_head.out_features == 3
    for cls in ("ResNet", "VGG", "DenseNet"):
        with pytest.raises(NotImplementedError, match="bn_axis_name"):
            getattr(cnn, cls)(bn_axis_name="data")


def test_features_only_gives_the_four_taps():
    """``create_model(..., features_only=True)``: the stage maps of the
    model in order, ``out_indices``, a dict, ``feature_info``."""
    fx = registry.create_model("resnet18", features_only=True, layers=L1,
                               dtype=torch.float32).eval()
    x = torch.randn(1, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        taps = fx.model(x)["taps"]
        feats = fx(x)
    assert [f.shape[1] for f in feats] == [64, 128, 256, 512]
    assert all(torch.equal(f, taps[i]) for i, f in enumerate(feats))
    fx.out_indices, fx.as_dict = (1, 3), True
    with torch.no_grad():
        picked = fx(x)
    assert list(picked) == [1, 3] and torch.equal(picked[3], taps[3])
    assert fx.feature_info(32) == [{"reduction": 8, "num_chs": 128},
                                   {"reduction": 32, "num_chs": 512}]


def _bn(rng, prefix, n=4):
    return {f"{prefix}.weight": rng.normal(size=n), f"{prefix}.bias": rng.normal(size=n),
            f"{prefix}.running_mean": rng.normal(size=n),
            f"{prefix}.running_var": rng.uniform(size=n),
            f"{prefix}.num_batches_tracked": np.asarray(5)}


def _conv(rng, name, k=3):
    return {name: rng.normal(size=(4, 3, k, k))}


def _as_f32(sd):
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def test_resnet_mapper_matches_jax():
    rng = np.random.default_rng(0)
    sd = {**_conv(rng, "conv1.weight", 7), **_bn(rng, "bn1"),
          "fc.weight": rng.normal(size=(5, 4)), "fc.bias": rng.normal(size=5)}
    for i in (1, 2, 3):
        sd.update(_conv(rng, f"layer1.0.conv{i}.weight", 1 + 2 * (i == 2)))
        sd.update(_bn(rng, f"layer1.0.bn{i}"))
    sd.update({**_conv(rng, "layer1.0.downsample.0.weight", 1),
               **_bn(rng, "layer1.0.downsample.1")})
    sd = _as_f32(sd)
    assert_same_flat(convert.resnet_state_dict_to_flax(sd),
                      jax_convert.resnet_state_dict_to_flax(sd))


@pytest.mark.parametrize("deep_stem", [False, True])
def test_densenet_mapper_matches_jax(deep_stem):
    """The legacy ``denselayer<i>.norm.1`` names, 1-based block and layer
    indices, the deep stem's ``conv0-2`` and ``norm0-2``."""
    rng = np.random.default_rng(1)
    sd = {"classifier.weight": rng.normal(size=(5, 4)), "classifier.bias": rng.normal(size=5),
          **_bn(rng, "features.norm5"), **_conv(rng, "features.transition1.conv.weight", 1),
          **_bn(rng, "features.transition1.norm")}
    for i in (range(3) if deep_stem else range(1)):
        sd.update({**_conv(rng, f"features.conv{i}.weight"), **_bn(rng, f"features.norm{i}")})
    for b, layer in ((1, 1), (1, 2), (2, 1)):
        base = f"features.denseblock{b}.denselayer{layer}"
        sd.update({**_bn(rng, f"{base}.norm.1"), **_conv(rng, f"{base}.conv.1.weight", 1),
                   **_bn(rng, f"{base}.norm2"), **_conv(rng, f"{base}.conv2.weight")})
    sd = _as_f32(sd)
    assert_same_flat(convert.densenet_state_dict_to_flax(sd),
                      jax_convert.densenet_state_dict_to_flax(sd))


@pytest.mark.parametrize("batch_norm", [False, True])
def test_vgg_mapper_matches_jax(batch_norm):
    """Convs by rank among ``features.<i>`` (pools between them), the
    ``_bn`` BatchNorms after them; the classifier left out."""
    rng = np.random.default_rng(2)
    sd, idx = {"classifier.0.weight": rng.normal(size=(6, 4))}, 0
    for item in (16, "M", 32, 32, "M"):
        if item == "M":
            idx += 1
            continue
        sd.update({**_conv(rng, f"features.{idx}.weight"),
                   f"features.{idx}.bias": rng.normal(size=4)})
        if batch_norm:
            sd.update(_bn(rng, f"features.{idx + 1}"))
        idx += 3 if batch_norm else 2
    sd = _as_f32(sd)
    assert_same_flat(convert.vgg_state_dict_to_flax(sd), jax_convert.vgg_state_dict_to_flax(sd))


def test_state_dict_to_flax_inverts_flax_to_state_dict():
    """The flax layout out of a model with BatchNorm, a 1-D conv (ECA) and
    SE: ``batch_stats`` and ``params`` as JAX's init names them."""
    from acr_wsss_tpu.models.resnet_timm import TimmResNet as JaxTimmResNet
    from acr_wsss_tpu_torch.models.resnet_timm import TimmResNet

    kw = dict(layers=L1, attn="eca", num_classes=4)
    with torch.device("meta"):
        model = TimmResNet(**kw)
    flat = convert.state_dict_to_flax(
        model, {k: torch.zeros(v.shape) for k, v in model.state_dict().items()})
    shapes = jax.eval_shape(lambda: JaxTimmResNet(**kw).init(jax.random.key(0),
                                                            jnp.zeros((1, 32, 32, 3))))
    assert {k: v.shape for k, v in flat.items()} == {
        k: tuple(v.shape) for k, v in flatten_params(shapes).items()}
    back = convert.flax_to_state_dict(flat, model.state_dict())
    assert sorted(back) == sorted(model.state_dict())
