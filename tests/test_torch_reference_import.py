"""The reference-checkpoint import of the port
(``models/convert.py:44-225,1049-1160``) against the JAX package:
``torch_state_dict_to_flax`` against JAX's on a seeded reference-layout
state dict, ``flax_params_to_torch_state_dict`` both ways and against
JAX's, and the CLI. All exact: the conversions are transposes.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from acr_wsss_tpu.models import convert as jax_convert
from acr_wsss_tpu.models.acr import ACR as JaxACR
from acr_wsss_tpu_torch import infer_cam
from acr_wsss_tpu_torch.configs import InferConfig, ModelConfig
from acr_wsss_tpu_torch.models import convert
from tests.torch_port_helpers import flatten_params, random_flax_params, unflatten_params


@pytest.fixture(scope="module", params=["vitb_hybrid", "deit_distilled"])
def reference_state(request):
    """(flat flax params, a seeded reference-layout state dict of tensors
    holding the same values, the backbone)."""
    backbone = request.param
    flat = random_flax_params(JaxACR(backbone_name=backbone, dtype=jnp.float32),
                              jnp.zeros((1, 32, 32, 3)), seed=11)
    ref = convert.flax_params_to_torch_state_dict(flat)
    return flat, {k: torch.from_numpy(v) for k, v in ref.items()}, backbone


def test_reference_import_matches_jax(reference_state):
    flat, ref, _ = reference_state
    extra = {"scratch.refinenet1.out_conv.weight": torch.ones(3),
             "pretrained.model.head.weight": torch.ones(2, 2),
             "pretrained.model.bkg_token": torch.full((1, 1, 3), 0.5),
             "pretrained.model.blocks.0.attn.fc1.weight": torch.ones(2, 2)}
    got = convert.torch_state_dict_to_flax({**ref, **extra})
    want = flatten_params(jax_convert.torch_state_dict_to_flax({**ref, **extra}))
    assert set(got) == set(want) == set(flat)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(got[k], flat[k], err_msg=k)


def test_reference_export_round_trips(reference_state):
    """flax -> reference -> flax and reference -> flax -> reference are the
    identity, with the reference dict as the template or none; JAX's
    exporter gives the same reference dict, and a scanned dict exports as
    its unrolled one."""
    flat, ref, _ = reference_state
    assert all(k.startswith(("pretrained.model.", "cls_head.")) for k in ref)
    again = convert.flax_params_to_torch_state_dict(convert.torch_state_dict_to_flax(ref),
                                                    ref)
    want = jax_convert.flax_params_to_torch_state_dict(unflatten_params(flat), ref)
    scanned = convert.flax_params_to_torch_state_dict(convert.unrolled_to_scanned(flat))
    assert set(again) == set(want) == set(scanned) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(again[k], ref[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(want[k], ref[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(scanned[k], ref[k].numpy(), err_msg=k)
    with pytest.raises(KeyError, match="missing"):
        convert.flax_params_to_torch_state_dict(
            {k: v for k, v in flat.items() if "cls_head" not in k}, ref)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scanned"])
def test_convert_cli_writes_what_infer_cam_loads(reference_state, tmp_path, scan, capsys):
    """The CLI on a ``torch.save``d checkpoint in the reference's
    ``{"model": ...}`` format with DDP's ``module.`` prefixes: the npz
    holds the layout asked for, and ``infer_cam.load_model`` reads the
    original weights from it."""
    flat, ref, backbone = reference_state
    path = tmp_path / "ref.pth"
    torch.save({"model": {"module." + k: v for k, v in ref.items()}}, path)
    out = tmp_path / "out.npz"
    convert.main([str(path), str(out), "--backbone", backbone] + (["--scan"] if scan else []))
    assert "wrote" in capsys.readouterr().out
    with np.load(out) as f:
        keys = set(f.files)
    assert any("blocks_scan" in k for k in keys) == scan
    model = infer_cam.load_model(InferConfig(
        model=ModelConfig(backbone=backbone, compute_dtype="float32"), weights=str(out),
        device="cpu"))
    want = convert.flax_to_state_dict(flat, model.state_dict())
    assert all(torch.equal(model.state_dict()[k], v) for k, v in want.items())


def test_convert_cli_reads_tensors_only(tmp_path):
    """``weights_only``: a checkpoint that pickles an object is refused."""
    path = tmp_path / "evil.pth"
    torch.save({"model": {"x": torch.zeros(1)}, "extra": os.stat_result((0,) * 10)}, path)
    with pytest.raises(Exception, match="[Ww]eights only"):
        convert.main([str(path), str(tmp_path / "out.npz")])
