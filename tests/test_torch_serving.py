"""The serving export (``acr_wsss_tpu_torch/serving.py``): a ``torch.export``
artifact of the CAM-inference program against the live path.

After ``tests/test_serving.py``, small enough for tier 1: vit_small, crop
64, batch 2, 4 class slots, float32 on the CPU, weights shared with JAX.
The artifact is traced with zero images and class ids 0-3 and called on
seeded images and other ids. Against the live plain ``build_infer_fn`` it
runs the same ATen operations, held to 1e-5 (the CLI's artifact in its
model's bfloat16 against the live bfloat16 path); against JAX's live
``build_infer_fn`` (``xla``, float32) the tolerances of
``tests/test_torch_infer.py``: logits and CAMs 1e-4 of their largest value.
A child process whose import system refuses ``acr_wsss_tpu_torch`` (and
JAX) loads and calls the artifacts that the CLI and ``export_infer`` wrote.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from acr_wsss_tpu.infer_cam import build_infer_fn as jax_build_infer_fn
from acr_wsss_tpu.models.acr import ACR as JaxACR
from acr_wsss_tpu_torch import serving
from acr_wsss_tpu_torch.infer_cam import build_infer_fn
from acr_wsss_tpu_torch.models.acr import ACR
from acr_wsss_tpu_torch.models.convert import flax_to_state_dict
from acr_wsss_tpu_torch.utils.checkpoint import save_params_npz
from tests.torch_port_helpers import random_flax_params, unflatten_params

CROP, SLOTS = 64, 4
IDS = [5, 0, 17, 9]


def _close(actual, expected, rel):
    actual, expected = np.asarray(actual, np.float64), np.asarray(expected, np.float64)
    assert actual.shape == expected.shape
    err, bound = np.abs(actual - expected).max(), rel * np.abs(expected).max()
    assert err <= bound, f"max abs err {err:.3g} > {bound:.3g}"


def _model(flat, dtype):
    model = ACR(backbone_name="vit_small", dtype=dtype, attn_impl="plain")
    model.load_state_dict(flax_to_state_dict(flat, model.state_dict()))
    return model


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(flat weights, float32 plain port model, inputs, live outputs, the
    live outputs of the bfloat16 model, and a directory holding the
    float32 artifact (cam.pt2, its params cam_params.pt), its embedded
    variant (cam_embedded.pt2), the CLI's (cli.pt2, cli_params.pt) and
    the inputs)."""
    flat = random_flax_params(JaxACR(backbone_name="vit_small", dtype=jnp.float32),
                              jnp.zeros((1, CROP, CROP, 3)), seed=12)
    model = _model(flat, torch.float32)
    x = torch.from_numpy(np.random.default_rng(13).normal(size=(2, CROP, CROP, 3))
                         .astype(np.float32))
    ids = torch.tensor(IDS)
    live = build_infer_fn(model, CROP, 10, "grad", True, 20, class_slots=SLOTS)(x, ids)
    live_bf16 = build_infer_fn(_model(flat, torch.bfloat16), CROP, 10, "grad", True, 20,
                               class_slots=SLOTS)(x, ids)

    tmp = tmp_path_factory.mktemp("serving")
    for name, embed in (("cam", False), ("cam_embedded", True)):
        serving.save_exported(str(tmp / f"{name}.pt2"),
                              serving.export_infer(model, CROP, 2, class_slots=SLOTS,
                                                   embed_weights=embed))
    torch.save(dict(model.state_dict()), tmp / "cam_params.pt")
    save_params_npz(str(tmp / "w.npz"), flat)
    serving.main(["--weights", str(tmp / "w.npz"), "--backbone", "vit_small", "--crop",
                  str(CROP), "--class_slots", str(SLOTS), "--device", "cpu",
                  "--out", str(tmp / "cli.pt2")])
    torch.save({"x": x, "ids": ids}, tmp / "inputs.pt")
    return flat, model, x, ids, live, live_bf16, tmp


def test_export_round_trip_matches_the_live_plain_path(setup):
    _, model, x, ids, live, _, tmp = setup
    params = dict(model.state_dict())
    out = serving.load_exported(str(tmp / "cam.pt2"))(params, x, ids)
    assert set(out) == {"cams", "patch_cam", "logits"}
    assert out["cams"].shape == (SLOTS, 2, (CROP // 16) ** 2)
    for k in live:
        torch.testing.assert_close(out[k], live[k], rtol=0, atol=1e-5)
    # The parameters are an input: other weights give the live path's
    # outputs for those weights.
    other = {k: v * 1.5 if k.endswith("bias") else v for k, v in params.items()}
    out2 = serving.load_exported(str(tmp / "cam.pt2"))(other, x, ids)
    ref_model = ACR(backbone_name="vit_small", dtype=torch.float32, attn_impl="plain")
    ref_model.load_state_dict(other)
    ref2 = build_infer_fn(ref_model, CROP, 10, "grad", True, 20, class_slots=SLOTS)(x, ids)
    assert not torch.allclose(out2["logits"], out["logits"])
    torch.testing.assert_close(out2["cams"], ref2["cams"], rtol=0, atol=1e-5)
    # The params file holds weights only; the artifact holds none of them.
    assert os.path.getsize(tmp / "cam.pt2") < 0.2 * os.path.getsize(tmp / "cam_embedded.pt2")


def test_embedded_weights_artifact_matches_the_live_plain_path(setup):
    _, _, x, ids, live, _, tmp = setup
    out = serving.load_exported(str(tmp / "cam_embedded.pt2"))(x, ids)
    for k in live:
        torch.testing.assert_close(out[k], live[k], rtol=0, atol=1e-5)


def test_cli_writes_the_artifact_and_its_params(setup):
    """The CLI builds JAX's serving model (the default bfloat16 compute,
    plain attention) and writes the params beside the artifact."""
    _, model, x, ids, _, live_bf16, tmp = setup
    params = torch.load(tmp / "cli_params.pt", weights_only=True)
    assert set(params) == set(model.state_dict())
    out = serving.load_exported(str(tmp / "cli.pt2"))(params, x, ids)
    for k in live_bf16:
        torch.testing.assert_close(out[k], live_bf16[k], rtol=0, atol=1e-5)


def test_export_matches_jax_live_inference(setup):
    flat, _, x, ids, _, _, tmp = setup
    jax_model = JaxACR(backbone_name="vit_small", dtype=jnp.float32, attn_impl="xla")
    ref = jax_build_infer_fn(jax_model, unflatten_params(flat), CROP, 10, "grad", True, 20,
                             class_slots=SLOTS)(jnp.asarray(x.numpy()),
                                                jnp.asarray(IDS, jnp.int32))
    params = torch.load(tmp / "cam_params.pt", weights_only=True)
    out = serving.load_exported(str(tmp / "cam.pt2"))(params, x, ids)
    assert np.abs(np.asarray(ref["cams"])).max() > 0
    for k in ("cams", "patch_cam", "logits"):
        _close(out[k].numpy(), jax.device_get(ref[k]), rel=1e-4)


CHILD = textwrap.dedent("""
    import importlib.abc, sys

    REFUSED = ("acr_wsss_tpu_torch", "acr_wsss_tpu", "jax", "jaxlib", "flax")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == r or name.startswith(r + ".") for r in REFUSED):
                raise ImportError(f"refused import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import torch

    tmp = sys.argv[1]
    inputs = torch.load(f"{tmp}/inputs.pt", weights_only=True)
    params = torch.load(f"{tmp}/cam_params.pt", weights_only=True)
    out = torch.export.load(f"{tmp}/cam.pt2").module()(params, inputs["x"], inputs["ids"])
    embedded = torch.export.load(f"{tmp}/cam_embedded.pt2").module()(inputs["x"], inputs["ids"])
    cli = torch.export.load(f"{tmp}/cli.pt2").module()(
        torch.load(f"{tmp}/cli_params.pt", weights_only=True), inputs["x"], inputs["ids"])
    torch.save({"out": dict(out), "embedded": dict(embedded), "cli": dict(cli)},
               f"{tmp}/child_out.pt")
    assert not [m for m in sys.modules if m.split(".")[0] in REFUSED]
    print("child ok")
""")


def test_artifacts_run_where_the_package_cannot_be_imported(setup):
    _, _, _, _, live, live_bf16, tmp = setup
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", CHILD, str(tmp)], cwd=str(tmp), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "child ok" in proc.stdout, proc.stdout + proc.stderr
    got = torch.load(tmp / "child_out.pt", weights_only=True)
    for variant, ref in (("out", live), ("embedded", live), ("cli", live_bf16)):
        for k in ref:
            torch.testing.assert_close(got[variant][k], ref[k], rtol=0, atol=1e-5)


def test_export_refuses_kernel_attention():
    model = ACR(backbone_name="vit_small", dtype=torch.float32, attn_impl="kernel")
    with pytest.raises(ValueError, match="plain attention only"):
        serving.export_infer(model, CROP, 2, class_slots=SLOTS)
    plain = ACR(backbone_name="vit_small", dtype=torch.float32, attn_impl="plain")
    with pytest.raises(ValueError, match="getam_func"):
        serving.export_infer(plain, CROP, 2, getam_func="gradcam")
