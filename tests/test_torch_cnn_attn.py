"""The port's attention-ResNet families (``models/cnn_attn.py``: SENet, SKNet,
Res2Net, ResNeSt, the SK-ResNets and the legacy SENets), their mappers
and zoo routing against the JAX package's, on the CPU.

* one small model per trunk (a block per stage, a 32x32 input, float32):
  the SE-ResNet (four stages), skresnet50d (the deep stem, split-input SK
  bottlenecks, the average-pool downsample) and senet154 (its 3x3 stem,
  three-conv block and 3x3 downsample; three stages): logits, features
  and taps of the eval forward within ``CNN_REL``; the other blocks alone
  on an 8x8 map within ``CNN_REL``: SKNet's selective kernel, Res2NeXt's
  grouped cascade (a first block and one that sums), ResNeSt at radix 4
  over 2 groups with the pool first and at radix 1 (a sigmoid), the SK
  basic block, the grouped SK bottleneck on the whole input, the legacy
  basic and ResNeXt blocks; one train-mode step of a three-stage
  SE-ResNet (its last stage's BatchNorms see 2 x 2 x 2 values; at 1 x 1
  the 2 values of a batch of 2 normalize to +-1 and amplify rounding)
  against ``jax.value_and_grad`` within ``CNN_GRAD_REL``;
* the 33 registry names built on the meta device, ``bn_axis_name``
  refused; full-size parameter and statistic shapes of one name per trunk
  (ResNeSt's, SKNet's grouped bottlenecks, the legacy SE-ResNeXt) against
  ``jax.eval_shape`` of the flax init;
* the SEResNet/Res2Net/ResNeSt, SK-ResNet and legacy SENet mappers
  against JAX's on synthetic timm state dicts (7x7 and deep stems, conv
  and average-pool downsamples), leaf for leaf; each name to the mapper
  JAX's ``zoo.convert_state_dict`` picks.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acr_wsss_tpu.models import cnn_attn as jax_attn
from acr_wsss_tpu.models import convert as jax_convert
from acr_wsss_tpu.models import registry as jax_registry
from acr_wsss_tpu_torch.models import cnn_attn, convert, registry
from acr_wsss_tpu_torch.models.convert import state_dict_to_flax
from tests.test_torch_cnn_mobile import _as_f32, _bn, _conv, routes
from tests.torch_port_helpers import (assert_close_to_max, assert_cnn_matches_jax,
                                      assert_same_flat, cnn_pair, cnn_train_step_matches_jax,
                                      flatten_params, jit_o0, random_flax_params,
                                      unflatten_params)

L1, L3 = (1, 1, 1, 1), (1, 1, 1)      # L3: three stages, the last at 2x2 of a 32x32 input


def _attn(block, **kw):
    """AttnResNet of ``block`` (a class name, or (name, partial kwargs))."""
    name, bkw = (block, {}) if isinstance(block, str) else block
    return ("AttnResNet", dict(kw, block=(name, bkw)))


# One whole model per trunk: the SE-ResNet at four stages (every tap; the
# 7x7 stem), skresnet50d's (the deep stem, split-input SK bottlenecks, the
# average-pool downsample) and senet154's (the 3x3 stem, the ceil-mode
# pool, its three-conv block and 3x3 downsample) at three stages.
VARIANTS = {
    "seresnet": _attn("SEBottleneck", layers=L1),
    "skresnet50d": ("SKResNet", dict(layers=L3, bottleneck=True, deep_stem=True,
                                     avg_down=True)),
    "legacy_senet154": ("LegacySENet", dict(layers=L3, block_kind="senet154", groups=64,
                                            inplanes=128, input_3x3=True, ds_kernel=3)),
}
# The other blocks alone, on a (2, 8, 8, in) map: (class, JAX's kwargs, the
# port's, in channels). Strided and widening, or (res2next) not: the
# cascade's sums.
BLOCKS = {
    "sk_bottleneck": ("SKBottleneck", dict(out_chs=256, stride=2), 128),
    "res2next_first": ("Res2NetBottleneck", dict(out_chs=256, stride=2, base_width=4,
                                                 cardinality=8, scale=4), 128),
    "res2next": ("Res2NetBottleneck", dict(out_chs=256, base_width=4, cardinality=8,
                                           scale=4), 256),
    "resnest_4s2x40d": ("ResNeStBottleneck", dict(out_chs=256, stride=2, radix=4,
                                                  cardinality=2, base_width=40,
                                                  avd_first=True), 128),
    "resnest_radix1": ("ResNeStBottleneck", dict(out_chs=256, stride=2, radix=1,
                                                 cardinality=4, base_width=24), 128),
    "sk_basic": ("SelectiveKernelBasicBlock", dict(planes=64, stride=2), 64),
    "sk_bottleneck_whole_input": ("SelectiveKernelBottleneckBlock",
                                  dict(planes=64, stride=2, cardinality=32, base_width=4,
                                       split_input=False), 128),
    "legacy_basic": ("LegacySENetBlock", dict(planes=64, kind="basic", stride=2), 32),
    "legacy_resnext": ("LegacySENetBlock", dict(planes=64, kind="resnext", groups=32,
                                                stride=2), 64),
}


def _models(cls, kw, num_classes=10):
    kw = dict(num_classes=num_classes, **kw)
    pair = []
    for module, dtype in ((jax_attn, jnp.float32), (cnn_attn, torch.float32)):
        mkw = dict(kw)
        if "block" in mkw:
            name, bkw = mkw["block"]
            mkw["block"] = functools.partial(getattr(module, name), **bkw)
        pair.append(getattr(module, cls)(dtype=dtype, **mkw))
    return pair


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cnn_attn_matches_jax(variant):
    jm, tm = _models(*VARIANTS[variant])
    flat = cnn_pair(jm, tm, 32)
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    assert_cnn_matches_jax(jm, flat, tm, x)


@pytest.mark.parametrize("block", list(BLOCKS))
def test_attention_blocks_match_jax(block):
    """Each block's eval forward against flax's, within CNN_REL."""
    cls, kw, in_chs = BLOCKS[block]
    jm = getattr(jax_attn, cls)(dtype=jnp.float32, **kw)
    port_kw = dict(kw)
    out = port_kw.pop("out_chs", None) or port_kw.pop("planes")
    tm = getattr(cnn_attn, cls)(in_chs, out, dtype=torch.float32, **port_kw)
    flat = random_flax_params(jm, jnp.zeros((1, 8, 8, in_chs)), seed=len(block))
    tm.load_state_dict(convert.flax_to_state_dict(flat, tm.state_dict()))
    tm.eval()
    x = np.random.default_rng(2).normal(size=(2, 8, 8, in_chs)).astype(np.float32)
    want = jit_o0(jm.apply)(unflatten_params(flat), jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert_close_to_max(got.permute(0, 2, 3, 1).numpy(), want)


def test_seresnet_train_step_matches_jax():
    cnn_train_step_matches_jax(*_models(*_attn("SEBottleneck", layers=L3), num_classes=6),
                               crop=32)


def test_registry_holds_the_33_names():
    names = registry.list_models(module="cnn_attn")
    assert len(names) == 33 and names == jax_registry.list_models(module="cnn_attn")
    with torch.device("meta"):
        for name in names:
            model = registry.create_model(name)
            head = getattr(model, "last_linear", None) or model.fc
            assert head.out_features == registry.get_default_cfg(name)["num_classes"], name
    for name in ("seresnet50", "skresnet18", "legacy_senet154"):
        with pytest.raises(NotImplementedError, match="bn_axis_name"):
            registry.create_model(name, bn_axis_name="data")


@pytest.mark.parametrize("name", ["resnest50d_4s2x40d", "skresnext50_32x4d",
                                  "legacy_seresnext26_32x4d"])
def test_full_size_shapes_match_the_flax_init(name):
    jm = jax_registry.create_model(name)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
    with torch.device("meta"):
        model = registry.create_model(name)
    got = state_dict_to_flax(model, {k: torch.empty(v.shape)
                                     for k, v in model.state_dict().items()})
    assert {k: v.shape for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in flatten_params(shapes).items()}


# --- the mappers --------------------------------------------------------------

def _linear(rng, name):
    return {f"{name}.weight": rng.normal(size=(5, 4)), f"{name}.bias": rng.normal(size=5)}


def _downsample(rng, block, avg_down):
    if avg_down:   # .0 the parameter-free pool, .1 the conv, .2 the BatchNorm
        return {**_conv(rng, f"{block}.downsample.1", 1), **_bn(rng, f"{block}.downsample.2")}
    return {**_conv(rng, f"{block}.downsample.0", 1), **_bn(rng, f"{block}.downsample.1")}


def _stem(rng, deep):
    if deep:
        return {**_conv(rng, "conv1.0"), **_bn(rng, "conv1.1"), **_conv(rng, "conv1.3"),
                **_bn(rng, "conv1.4"), **_conv(rng, "conv1.6"), **_bn(rng, "bn1")}
    return {**_conv(rng, "conv1", 7), **_bn(rng, "bn1")}


def _attn_resnet_sd(rng, deep):
    """SE and Res2Net blocks on the 7x7 stem with conv downsamples, or
    ResNeSt's split attention on the deep stem with average-pool ones."""
    sd = {**_stem(rng, deep), **_linear(rng, "fc")}
    for b in ("layer1.0", "layer3.1"):
        for i in (1, 2, 3):
            sd.update({**_conv(rng, f"{b}.conv{i}", 1), **_bn(rng, f"{b}.bn{i}")})
        if deep:
            del sd[f"{b}.conv2.weight"]
            sd.update({**_conv(rng, f"{b}.conv2.conv"), **_bn(rng, f"{b}.conv2.bn0"),
                       **_conv(rng, f"{b}.conv2.fc1", 1, bias=True),
                       **_bn(rng, f"{b}.conv2.bn1"),
                       **_conv(rng, f"{b}.conv2.fc2", 1, bias=True)})
        else:
            sd.update({**_conv(rng, f"{b}.se.fc1", 1, bias=True),
                       **_conv(rng, f"{b}.se.fc2", 1, bias=True)})
            for i in range(3):
                sd.update({**_conv(rng, f"{b}.convs.{i}"), **_bn(rng, f"{b}.bns.{i}")})
    sd.update(_downsample(rng, "layer1.0", deep))
    return _as_f32(sd)


def _sknet_sd(rng, bottleneck):
    """skresnet18's basic blocks (the SK conv at conv1) on the 7x7 stem, or
    skresnet50d's bottlenecks (at conv2) on the deep stem."""
    sd = {**_stem(rng, bottleneck), **_linear(rng, "fc")}
    sk = "conv2" if bottleneck else "conv1"
    plain = ("conv1", "conv3") if bottleneck else ("conv2",)
    for b in ("layer1.0", "layer2.1"):
        for p in (0, 1):
            sd.update({**_conv(rng, f"{b}.{sk}.paths.{p}.conv"),
                       **_bn(rng, f"{b}.{sk}.paths.{p}.bn")})
        sd.update({**_conv(rng, f"{b}.{sk}.attn.fc_reduce", 1), **_bn(rng, f"{b}.{sk}.attn.bn"),
                   **_conv(rng, f"{b}.{sk}.attn.fc_select", 1)})
        for c in plain:
            sd.update({**_conv(rng, f"{b}.{c}.conv"), **_bn(rng, f"{b}.{c}.bn")})
    sd.update(_downsample(rng, "layer1.0", bottleneck))
    return _as_f32(sd)


def _legacy_sd(rng):
    sd = _linear(rng, "last_linear")
    for i in (1, 2, 3):
        sd.update({**_conv(rng, f"layer0.conv{i}"), **_bn(rng, f"layer0.bn{i}")})
    for b in ("layer1.0", "layer4.2"):
        for i in (1, 2, 3):
            sd.update({**_conv(rng, f"{b}.conv{i}", 1), **_bn(rng, f"{b}.bn{i}")})
        sd.update({**_conv(rng, f"{b}.se_module.fc1", 1, bias=True),
                   **_conv(rng, f"{b}.se_module.fc2", 1, bias=True)})
    sd.update({**_conv(rng, "layer1.0.downsample.0"), **_bn(rng, "layer1.0.downsample.1")})
    return _as_f32(sd)


MAPPERS = {"attn_resnet": (_attn_resnet_sd, (False, True)), "sknet": (_sknet_sd, (False, True)),
           "legacy_senet": (lambda rng, _: _legacy_sd(rng), (False,))}


@pytest.mark.parametrize("family,variant", [(f, v) for f, (_, vs) in MAPPERS.items()
                                            for v in vs])
def test_mapper_matches_jax(family, variant):
    sd = MAPPERS[family][0](np.random.default_rng(len(family) + variant), variant)
    fn = f"{family}_state_dict_to_flax"
    assert_same_flat(getattr(convert, fn)(sd), getattr(jax_convert, fn)(sd))


def test_zoo_routes_as_jax(monkeypatch):
    """sknet50 and res2next50 match no rule in JAX's routing, nor the port's."""
    from acr_wsss_tpu.models import zoo as jax_zoo
    from acr_wsss_tpu_torch.models import zoo

    got = routes(zoo, jax_zoo, registry.list_models(module="cnn_attn"), monkeypatch)
    assert {name: port for name, (_, port) in got.items()} == {
        name: jax_fn for name, (jax_fn, _) in got.items()}
    assert got["sknet50"] == got["res2next50"] == ("none", "none")
    assert got["legacy_senet154"][1] == "legacy_senet_state_dict_to_flax"
