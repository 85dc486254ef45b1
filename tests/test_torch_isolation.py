"""The port imports nothing of JAX and nothing of the JAX package.

The card's machine has no JAX, flax, optax or orbax. In a fresh interpreter
whose import system refuses those packages and ``acr_wsss_tpu`` (the exact
name and its submodules, not ``acr_wsss_tpu_torch``), every module of the
port and ``chip_smoke`` must import: the inference modules, the
training ones (``train``, ``losses``, ``data/voc``, ``ops/attn_pair``,
``utils/{schedule,meters}``), ``ops/pamr`` and ``pipeline``.
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
    assert count >= 26, proc.stdout
    for name in ("train", "losses", "data.voc", "ops.attn_pair", "utils.schedule",
                 "utils.meters", "ops.pamr", "pipeline"):
        assert f"acr_wsss_tpu_torch.{name}" in proc.stdout, name
