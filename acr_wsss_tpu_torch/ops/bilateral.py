"""ctypes bindings of the repository's native permutohedral engine (``cpp/``).

Own copy of ``acr_wsss_tpu/ops/bilateral.py``: the host C++ library behind
the dense CRF's host route (``ops/crf.py``) and the RRM dense-energy loss
(``pseudo_label.dense_energy_loss``). ``cpp/permutohedral.cc`` and
``cpp/bilateral.cc`` are compiled with ``g++ -O3 -march=native -fopenmp``
at first use into ``build/torch_native/`` at the repository root (listed in
``.gitignore``), under a name that carries the hash of the sources, the
header, the flags and the host's target (what ``-march=native`` resolves
to), so that a library built for another CPU is never loaded. Unlike the
JAX wrapper, a failed build raises with the compiler's output: nothing
falls back to the O(n^2) brute force, which stays here only as the tests'
oracle.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
from typing import Optional

import numpy as np

CPP_DIR = pathlib.Path(__file__).resolve().parents[2] / "cpp"
SOURCES = ("permutohedral.cc", "bilateral.cc")
HEADERS = ("permutohedral.h",)
BUILD_DIR = CPP_DIR.parent / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; the native CRF engine (cpp/) is "
                           "built with it at first use")
    return cxx


def host_key() -> bytes:
    """The machine and the target options g++ enables for ``-march=native``
    on this host (the instruction sets the library may use)."""
    proc = subprocess.run([_cxx(), "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True, check=True)
    return (platform.machine() + "\n" + proc.stdout).encode()


def library_path(host: Optional[bytes] = None) -> pathlib.Path:
    """Where the library for ``host`` (default: this host's
    :func:`host_key`) is built."""
    host = host_key() if host is None else host
    text = b"".join((CPP_DIR / f).read_bytes() for f in SOURCES + HEADERS)
    digest = hashlib.sha256(text + " ".join(CXX_FLAGS).encode() + host).hexdigest()
    return BUILD_DIR / f"libacrnative-{digest[:16]}.so"


def _build(lib: pathlib.Path) -> None:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), *(str(CPP_DIR / f) for f in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on the native CRF engine (exit "
                           f"{proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib)


def load_library() -> ctypes.CDLL:
    """The native library, built at first use; raises when it cannot be."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    cint, cfloat = ctypes.c_int, ctypes.c_float
    lib.bilateral_filter.argtypes = [f32p, f32p, f32p, cint, cint, cint, cfloat, cfloat]
    lib.bilateral_filter.restype = None
    lib.bilateral_filter_batch.argtypes = [f32p, f32p, f32p, cint, cint, cint, cint,
                                           cfloat, cfloat]
    lib.bilateral_filter_batch.restype = None
    lib.densecrf_inference.argtypes = [f32p, f32p, f32p, cint, cint, cint, cint,
                                       cfloat, cfloat, cfloat, cfloat, cfloat]
    lib.densecrf_inference.restype = None
    lib.bilateral_num_threads.argtypes = []
    lib.bilateral_num_threads.restype = cint
    _lib = lib
    return lib


def check_guide(image: np.ndarray, values: np.ndarray) -> None:
    """The (..., H, W, 3) guide must match the (..., C, H, W) values."""
    if image.shape[-1] != 3 or image.shape[:-3] != values.shape[:-3] \
            or image.shape[-3:-1] != values.shape[-2:]:
        raise ValueError(f"guide {image.shape} does not match values {values.shape}")


def bilateral_filter(image: np.ndarray, values: np.ndarray,
                     sigma_xy: float, sigma_rgb: float) -> np.ndarray:
    """Edge-aware filter of (C, H, W) ``values`` guided by (H, W, 3) RGB."""
    lib = load_library()
    image = np.ascontiguousarray(image, np.float32)
    values = np.ascontiguousarray(values, np.float32)
    check_guide(image, values)
    C, H, W = values.shape
    out = np.empty_like(values)
    lib.bilateral_filter(image, values, out, H, W, C, float(sigma_xy), float(sigma_rgb))
    return out


def bilateral_filter_batch(images: np.ndarray, values: np.ndarray,
                           sigma_xy: float, sigma_rgb: float) -> np.ndarray:
    """(N, H, W, 3) guides and (N, C, H, W) values, OpenMP over N."""
    lib = load_library()
    images = np.ascontiguousarray(images, np.float32)
    values = np.ascontiguousarray(values, np.float32)
    check_guide(images, values)
    N, C, H, W = values.shape
    out = np.empty_like(values)
    lib.bilateral_filter_batch(images, values, out, N, C, H, W,
                               float(sigma_xy), float(sigma_rgb))
    return out


def bilateral_filter_bruteforce(image: np.ndarray, values: np.ndarray,
                                sigma_xy: float, sigma_rgb: float) -> np.ndarray:
    """O(n^2) exact Gaussian bilateral filter: the tests' oracle (tiny
    images only)."""
    C, H, W = values.shape
    ys, xs = np.mgrid[0:H, 0:W]
    feat = np.concatenate([
        (xs / sigma_xy)[..., None], (ys / sigma_xy)[..., None],
        image.astype(np.float32) / sigma_rgb,
    ], axis=-1).reshape(-1, 5)
    d2 = ((feat[:, None, :] - feat[None, :, :]) ** 2).sum(-1)
    w = np.exp(-0.5 * d2)
    vflat = values.reshape(C, -1)
    out = (vflat @ w.T) / w.sum(axis=1)[None, :]
    return out.reshape(C, H, W).astype(np.float32)
