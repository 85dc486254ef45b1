"""The port's mobile CNN families (``models/cnn_mobile.py``: EfficientNet,
MobileNetV3, RegNet), their mappers and zoo routing against the JAX
package's, on the CPU.

* each family at a small size (EfficientNet at half width, a block a stage,
  the full MobileNetV3-Large, a RegNetY of two blocks in one stage) on a
  32x32 input in float32: logits, features and taps of the eval forward
  within ``CNN_REL`` of the largest |value|, weights and BatchNorm
  statistics crossing by ``flax_to_state_dict``; one train-mode step of
  the EfficientNet (depthwise convs, SiLU and sigmoid SE) against
  ``jax.value_and_grad``, every gradient within ``CNN_GRAD_REL``;
* ``SqueezeExcite`` with the hard gate against flax's;
* the 32 registry names built on the meta device with JAX's class
  counts; full-size parameter and statistic shapes of efficientnet_b3,
  mobilenetv3_large_100 and regnety_032 against ``jax.eval_shape`` of the
  flax init;
* the EfficientNet, MobileNetV3 and RegNet mappers against JAX's on
  synthetic timm state dicts, leaf for leaf; each name to the mapper JAX's
  ``zoo.convert_state_dict`` picks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acr_wsss_tpu.models import cnn_mobile as jax_mobile
from acr_wsss_tpu.models import convert as jax_convert
from acr_wsss_tpu.models import registry as jax_registry
from acr_wsss_tpu_torch.models import cnn_mobile, convert, registry
from acr_wsss_tpu_torch.models.convert import state_dict_to_flax
from tests.torch_port_helpers import (assert_close_to_max, assert_cnn_matches_jax,
                                      assert_same_flat, cnn_pair, cnn_train_step_matches_jax,
                                      flatten_params, jit_o0, random_flax_params,
                                      unflatten_params)

VARIANTS = {
    # a block per stage (the residual: MobileNetV3's blocks, the same MBConv)
    "efficientnet": ("EfficientNet", dict(width_mult=0.5, depth_mult=0.25)),
    "mobilenetv3": ("MobileNetV3", {}),
    "regnety": ("RegNet", dict(depths=(1, 2), widths=(16, 32), group_width=8,
                               se_ratio=0.25)),
}


def _models(cls, kw, num_classes=10):
    kw = dict(num_classes=num_classes, **kw)
    return (getattr(jax_mobile, cls)(dtype=jnp.float32, **kw),
            getattr(cnn_mobile, cls)(dtype=torch.float32, **kw))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cnn_mobile_matches_jax(variant):
    jm, tm = _models(*VARIANTS[variant])
    flat = cnn_pair(jm, tm, 32)
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    assert_cnn_matches_jax(jm, flat, tm, x)


def test_efficientnet_train_step_matches_jax():
    """Every block's ``project`` BatchNorm feeds the next 1x1 conv and its
    train-mode BatchNorm: the gradient of its bias is 0 but for rounding."""
    cnn_train_step_matches_jax(*_models("EfficientNet", dict(width_mult=0.25, depth_mult=0.25),
                                        num_classes=6), crop=64,
                               zero_grad=r"/project/bn/bias$")


def test_hard_squeeze_excite_matches_flax():
    x = np.random.default_rng(2).normal(size=(2, 5, 6, 16)).astype(np.float32)
    jm = jax_mobile.SqueezeExcite(8, gate="hard", act="relu", dtype=jnp.float32)
    flat = random_flax_params(jm, jnp.zeros((1, 5, 6, 16)), seed=3)
    tm = cnn_mobile.SqueezeExcite(16, 8, gate="hard", act="relu")
    tm.load_state_dict(convert.flax_to_state_dict(flat, tm.state_dict()))
    want = jit_o0(jm.apply)(unflatten_params(flat), jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert_close_to_max(got.permute(0, 2, 3, 1).numpy(), want)


def test_registry_holds_the_32_names():
    names = registry.list_models(module="cnn_mobile")
    assert len(names) == 32 and names == jax_registry.list_models(module="cnn_mobile")
    assert cnn_mobile._REGNET_CFGS.items() >= jax_mobile._REGNET_CFGS.items()
    with torch.device("meta"):
        for name in names:
            model = registry.create_model(name)
            head = model.head if isinstance(model, cnn_mobile.RegNet) else model.classifier
            assert head.out_features == registry.get_default_cfg(name)["num_classes"], name
    with pytest.raises(NotImplementedError, match="bn_axis_name"):
        registry.create_model("efficientnet_b0", bn_axis_name="data")


@pytest.mark.parametrize("name", ["efficientnet_b3", "mobilenetv3_large_100", "regnety_032"])
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

def _bn(rng, prefix, n=4):
    return {f"{prefix}.weight": rng.normal(size=n), f"{prefix}.bias": rng.normal(size=n),
            f"{prefix}.running_mean": rng.normal(size=n),
            f"{prefix}.running_var": rng.uniform(size=n),
            f"{prefix}.num_batches_tracked": np.asarray(5)}


def _conv(rng, name, k=3, bias=False):
    out = {f"{name}.weight": rng.normal(size=(4, 3, k, k))}
    if bias:
        out[f"{name}.bias"] = rng.normal(size=4)
    return out


def _as_f32(sd):
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _mbconv_blocks(rng, stages):
    """timm blocks ``blocks.<s>.<j>`` for (stage, index, SE) triples: stage
    0 depthwise-separable, the others inverted residuals."""
    sd = {}
    for s, j, se in stages:
        b = f"blocks.{s}.{j}"
        if s == 0:
            sd.update({**_conv(rng, f"{b}.conv_dw"), **_bn(rng, f"{b}.bn1"),
                       **_conv(rng, f"{b}.conv_pw", 1), **_bn(rng, f"{b}.bn2")})
        else:
            sd.update({**_conv(rng, f"{b}.conv_pw", 1), **_bn(rng, f"{b}.bn1"),
                       **_conv(rng, f"{b}.conv_dw", 5), **_bn(rng, f"{b}.bn2"),
                       **_conv(rng, f"{b}.conv_pwl", 1), **_bn(rng, f"{b}.bn3")})
        if se:
            sd.update({**_conv(rng, f"{b}.se.conv_reduce", 1, bias=True),
                       **_conv(rng, f"{b}.se.conv_expand", 1, bias=True)})
    return sd


def _efficientnet_sd(rng):
    sd = {**_conv(rng, "conv_stem"), **_bn(rng, "bn1"), **_conv(rng, "conv_head", 1),
          **_bn(rng, "bn2"), "classifier.weight": rng.normal(size=(5, 4)),
          "classifier.bias": rng.normal(size=5)}
    sd.update(_mbconv_blocks(rng, [(0, 0, True), (1, 0, True), (1, 1, True), (6, 0, True)]))
    return _as_f32(sd)


def _mobilenetv3_sd(rng):
    sd = {**_conv(rng, "conv_stem"), **_bn(rng, "bn1"), **_conv(rng, "blocks.6.0.conv", 1),
          **_bn(rng, "blocks.6.0.bn1"), **_conv(rng, "conv_head", 1, bias=True),
          "classifier.weight": rng.normal(size=(5, 4)), "classifier.bias": rng.normal(size=5)}
    sd.update(_mbconv_blocks(rng, [(0, 0, False), (1, 1, False), (2, 0, True), (3, 3, False),
                                   (5, 2, True)]))
    return _as_f32(sd)


def _regnet_sd(rng):
    sd = {**_conv(rng, "stem.conv"), **_bn(rng, "stem.bn"),
          "head.fc.weight": rng.normal(size=(5, 4)), "head.fc.bias": rng.normal(size=5)}
    for b in ("s1.b1", "s1.b2", "s3.b1"):
        for i in (1, 2, 3):
            sd.update({**_conv(rng, f"{b}.conv{i}.conv", 1 + 2 * (i == 2)),
                       **_bn(rng, f"{b}.conv{i}.bn")})
        sd.update({**_conv(rng, f"{b}.se.fc1", 1, bias=True),
                   **_conv(rng, f"{b}.se.fc2", 1, bias=True)})
    sd.update({**_conv(rng, "s1.b1.downsample.conv", 1), **_bn(rng, "s1.b1.downsample.bn")})
    return _as_f32(sd)


MAPPERS = {"efficientnet": _efficientnet_sd, "mobilenetv3": _mobilenetv3_sd,
           "regnet": _regnet_sd}


@pytest.mark.parametrize("family", list(MAPPERS))
def test_mapper_matches_jax(family):
    sd = MAPPERS[family](np.random.default_rng(len(family)))
    fn = f"{family}_state_dict_to_flax"
    assert_same_flat(getattr(convert, fn)(sd), getattr(jax_convert, fn)(sd))


def routes(port_zoo, jax_zoo, names, monkeypatch):
    """name -> (the mapper JAX's ``convert_state_dict`` calls, the port's),
    "none" where a name matches no rule (JAX then fails in its ACR
    fallback, the port raises)."""
    import acr_wsss_tpu.models.convert as jc

    def recorder(fn_name):
        return lambda *args, **kwargs: fn_name

    for fn_name in [n for n in dir(jc) if n.endswith("state_dict_to_flax")]:
        monkeypatch.setattr(jc, fn_name, recorder(fn_name))
    for fn_name in [n for n in vars(port_zoo) if n.endswith("state_dict_to_flax")]:
        monkeypatch.setattr(port_zoo, fn_name, recorder(fn_name))
    out = {}
    for name in names:
        picked = []
        for zoo_mod, fallback in ((jax_zoo, Exception), (port_zoo, ValueError)):
            try:
                fn = zoo_mod.convert_state_dict(name, {})
            except fallback:
                fn = "none"
            picked.append("none" if fn == "torch_state_dict_to_flax" else fn)
        out[name] = tuple(picked)
    return out


def test_zoo_routes_as_jax(monkeypatch):
    from acr_wsss_tpu.models import zoo as jax_zoo
    from acr_wsss_tpu_torch.models import zoo

    names = registry.list_models(module="cnn_mobile") + [
        "efficientnet_b5", "mobilenetv3_small_100", "tf_efficientnet_b0"]
    got = routes(zoo, jax_zoo, names, monkeypatch)
    for name, (jax_fn, port_fn) in got.items():
        if jax_fn in ("generic_effnet_state_dict_to_flax",):
            assert port_fn == "none", name        # the generic mapper is not ported
        else:
            assert port_fn == jax_fn, name
    assert got["regnety_032"][1] == "regnet_state_dict_to_flax"
    assert got["mobilenetv3_large_100_miil"][1] == "mobilenetv3_state_dict_to_flax"
