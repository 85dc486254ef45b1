"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and includes
no PyTorch header, so one ``nvcc`` call takes seconds. Libraries go to
``build/torch_kernels/`` at the repository root (listed in ``.gitignore``)
under a name that carries the hash of the source, the shared headers
(``csrc/*.cuh``) and the flags: a library is rebuilt only when one of them
changes. All sources that need a build are compiled in parallel, one
``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Sequence

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the port's CUDA kernels are built on the card's "
                           "machine")
    return nvcc


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every source in ``names`` that has no up-to-date library,
    all ``nvcc`` processes at once. Returns {name: ptxas report} for the
    sources built now; raises with ``nvcc``'s output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    reports, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        reports[name] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built at first use."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
