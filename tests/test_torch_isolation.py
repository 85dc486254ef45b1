"""The port imports nothing of JAX and nothing of the JAX package.

The card's machine has no JAX, flax, optax or orbax. In a fresh interpreter
whose import system refuses those packages and ``acr_wsss_tpu`` (the exact
name and its submodules, not ``acr_wsss_tpu_torch``), every module of the
port and ``chip_smoke`` must import: the inference modules, the
training ones (``train``, ``losses``, ``data/voc``, ``ops/attn_pair``,
``utils/{schedule,meters}``), ``ops/pamr`` and ``pipeline``, and those of
resumable training: ``train_coco``, ``data/{coco,lists,device_aug}``,
``models/zoo`` and ``utils/{checkpoint,logging,preemption,watchdog,
supervisor}``; those from CAMs to pseudo masks: ``ops/{crf,bilateral}``,
``pseudo_label`` and ``utils/visualization``; and those of the
segmentation stage: ``models/dpt``, ``train_seg`` and ``utils/metrics``;
and those of serving and the reference import: ``serving`` and
``models/convert``, whose CLIs also run there; and those of data
parallelism: ``parallel/{distributed,mesh,sharding}``; and those of the
Swin and PiT slice: ``models/{registry,swin,pit}`` and ``train_swin``; and
those of the classifier zoo: ``models/{vit_classifier,cfg,features}``. The
CLIs run there too: the reference-checkpoint import on a ``torch.save``d
checkpoint, then the serving export of the npz it wrote, and the
artifact's call.
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    REFUSED = ("jax", "jaxlib", "flax", "optax", "orbax", "acr_wsss_tpu")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == r or name.startswith(r + ".") for r in REFUSED):
                raise ImportError(f"refused import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, ROOT)
    import acr_wsss_tpu_torch
    names = ["acr_wsss_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(acr_wsss_tpu_torch.__path__,
                                              "acr_wsss_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    loaded = [m for m in sys.modules
              if any(m == r or m.startswith(r + ".") for r in REFUSED)]
    assert not loaded, loaded
    print(" ".join(names))
    print(len(names), "modules")
""")


def test_port_and_chip_smoke_import_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\n" + SCRIPT],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count = int(proc.stdout.split()[-2])
    assert count >= 46, proc.stdout
    for name in ("train", "losses", "data.voc", "ops.attn_pair", "utils.schedule",
                 "utils.meters", "ops.pamr", "pipeline", "train_coco", "data.coco",
                 "data.lists", "data.device_aug", "models.zoo", "utils.checkpoint",
                 "utils.logging", "utils.preemption", "utils.watchdog", "utils.supervisor",
                 "ops.crf", "ops.bilateral", "pseudo_label", "utils.visualization",
                 "models.dpt", "train_seg", "utils.metrics", "serving", "models.convert",
                 "parallel", "parallel.distributed", "parallel.mesh", "parallel.sharding",
                 "models.registry", "models.swin", "models.pit", "train_swin",
                 "models.vit_classifier", "models.cfg", "models.features"):
        assert f"acr_wsss_tpu_torch.{name}" in proc.stdout, name


CLIS = textwrap.dedent("""
    import torch
    from acr_wsss_tpu_torch import serving
    from acr_wsss_tpu_torch.models import convert
    from acr_wsss_tpu_torch.models.acr import ACR, init_random_

    flat = convert.state_dict_to_flax(init_random_(ACR(backbone_name="vit_small"), seed=0))
    ref = convert.flax_params_to_torch_state_dict(flat)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in ref.items()}}, f"{TMP}/ref.pth")
    convert.main([f"{TMP}/ref.pth", f"{TMP}/w.npz", "--backbone", "vit_small"])
    serving.main(["--weights", f"{TMP}/w.npz", "--backbone", "vit_small", "--crop", "32",
                  "--class_slots", "2", "--device", "cpu", "--out", f"{TMP}/cam.pt2"])
    params = torch.load(f"{TMP}/cam_params.pt", weights_only=True)
    out = serving.load_exported(f"{TMP}/cam.pt2")(params, torch.zeros(2, 32, 32, 3),
                                                  torch.tensor([1, 4]))
    assert out["cams"].shape == (2, 2, 4) and bool(torch.isfinite(out["cams"]).all())
    loaded = [m for m in sys.modules
              if any(m == r or m.startswith(r + ".") for r in REFUSED)]
    assert not loaded, loaded
""")


def test_convert_and_serving_clis_run_without_jax(tmp_path):
    script = SCRIPT.split("import acr_wsss_tpu_torch\n")[0] + CLIS
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\nTMP = {str(tmp_path)!r}\n" + script],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "wrote" in proc.stdout and "exported" in proc.stdout
