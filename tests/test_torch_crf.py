"""The port's dense CRF (``ops/crf.py``, ``ops/bilateral.py``) against the
JAX package's, on the CPU.

``crf_inference_torch`` against ``crf_inference_jax`` (jit-compiled, its
``scatter`` splat, the one JAX takes off a TPU and the only one the port
has) on seeded uniform images and normalized uniform probabilities. Both
sides in float32, the same nearest-cell assignment and the same band
matrices, sums in another order: 1e-5 and the same argmax at t=3. At t=10
the mean-field carries float32 rounding through ten softmaxes of
near-uniform scores: JAX's own result is 2.9e-5 from a float64 run of the
same algorithm (the port's 1.2e-5), so the bound is 5e-5 (measured
2.6e-5), with the same argmax.
The host recipes run the same C++ engine on both sides, built by each
package's own wrapper (JAX's into a private directory, so that no other
test process's build races it): 1e-6.
"""

import numpy as np
import pytest
import torch

import jax

from acr_wsss_tpu.ops import bilateral as jax_bilateral
from acr_wsss_tpu.ops import crf as jax_crf
from acr_wsss_tpu_torch.ops import bilateral, crf

# (name, H, W, labels, iterations, keyword arguments, atol)
CASES = [("37x53", 37, 53, 3, 3, {}, 1e-5),           # measured 2.2e-6
         ("64x96", 64, 96, 5, 10, {"sxy_b": 20.0}, 5e-5)]  # measured 2.6e-5


def _inputs(h, w, labels, seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    p = rng.uniform(0.01, 1, (labels, h, w)).astype(np.float32)
    return img, p / p.sum(0, keepdims=True)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX wrapper's library, built by its own build function into a
    directory of this module's."""
    path = str(tmp_path_factory.mktemp("jax_native") / "libacrnative.so")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bilateral, "_LIB_PATH", path)
        lib = jax_bilateral.load_library(rebuild=True)
    assert lib is not None, "the JAX package's native library did not build"
    return lib


@pytest.mark.parametrize("name,h,w,labels,t,kw,atol", CASES, ids=[c[0] for c in CASES])
def test_crf_inference_torch_matches_jax(name, h, w, labels, t, kw, atol):
    img, probs = _inputs(h, w, labels, seed=h)
    ref = np.asarray(jax.jit(lambda i, p: jax_crf.crf_inference_jax(
        i, p, t=t, splat_impl="scatter", **kw))(img, probs))
    got = crf.crf_inference_torch(img, probs, t=t, device="cpu", **kw)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got.sum(0), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    np.testing.assert_array_equal(got.argmax(0), ref.argmax(0))


def test_the_image_must_match_the_probabilities():
    img, probs = _inputs(37, 53, 3, seed=1)
    with pytest.raises(ValueError, match="does not match"):
        crf.crf_inference_torch(img[:36], probs, t=2, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        crf.crf_inference_torch(img[..., :2], probs, t=2, device="cpu")


@pytest.mark.parametrize("h,w", [(12, 40), (40, 12), (13, 13)])
def test_gaussian_message_needs_lines_of_2r_plus_1(h, w):
    """13 taps at sxy_g=3 (radius int(2 * 3)): jnp.convolve(mode="same")
    returns max(M, N) samples, so JAX cannot run a shorter line either."""
    assert len(crf._gaussian_taps(3.0)) == 13
    assert len(crf._gaussian_taps(0.2)) == 3
    img, probs = _inputs(h, w, 2, seed=2)
    if min(h, w) < 13:
        with pytest.raises(ValueError, match="13 taps"):
            crf.crf_inference_torch(img, probs, t=1, device="cpu")
    else:
        out = crf.crf_inference_torch(img, probs, t=1, device="cpu")
        ref = np.asarray(jax_crf.crf_inference_jax(img, probs, t=1))
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,passes", [(2, 1), (8, 2), (18, 1), (18, 5), (9, 32)])
def test_band_power_bit_for_bit(n, passes):
    got, ref = crf._band_power(n, passes), jax_crf._band_power(n, passes)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def _two_region_image(rng, h, w):
    img = np.zeros((h, w, 3), np.float32)
    img[:, : w // 2] = [200, 30, 30]
    img[:, w // 2:] = [30, 30, 200]
    return np.clip(img + rng.normal(0, 5, size=img.shape), 0, 255).astype(np.float32)


@pytest.mark.parametrize("recipe", ["crf_inference", "crf_inference_inf"])
def test_host_recipes_match_jax(jax_native, recipe):
    rng = np.random.default_rng(3)
    img = _two_region_image(rng, 40, 52)
    probs = rng.uniform(0.05, 1, (4, 40, 52)).astype(np.float32)
    probs /= probs.sum(0, keepdims=True)
    got = getattr(crf, recipe)(img, probs, t=5)
    ref = getattr(jax_crf, recipe)(img, probs, t=5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(0), 1.0, atol=1e-4)
    half = getattr(crf, recipe)(img, probs, t=5, scale_factor=0.5)
    np.testing.assert_allclose(half, getattr(jax_crf, recipe)(img, probs, t=5, scale_factor=0.5),
                               rtol=0, atol=1e-6)


def test_host_label_recipe_matches_jax(jax_native):
    rng = np.random.default_rng(4)
    img = _two_region_image(rng, 24, 30)
    labels = np.zeros((24, 30), np.uint8)
    labels[:, 15:] = 1
    labels[rng.uniform(size=labels.shape) < 0.1] = 2
    got = crf.crf_inference_label(img, labels, t=3, n_labels=3)
    np.testing.assert_array_equal(got, jax_crf.crf_inference_label(img, labels, t=3, n_labels=3))
    assert (got[:, :13] == 0).mean() > 0.9


def test_bilateral_filters_match_jax_and_the_oracle(jax_native):
    rng = np.random.default_rng(5)
    imgs = np.stack([_two_region_image(rng, 16, 16) for _ in range(3)])
    vals = rng.uniform(size=(3, 2, 16, 16)).astype(np.float32)
    one = bilateral.bilateral_filter(imgs[0], vals[0], 5.0, 30.0)
    np.testing.assert_allclose(one, jax_bilateral.bilateral_filter(imgs[0], vals[0], 5.0, 30.0),
                               rtol=0, atol=1e-6)
    batch = bilateral.bilateral_filter_batch(imgs, vals, 5.0, 25.0)
    np.testing.assert_allclose(batch, jax_bilateral.bilateral_filter_batch(imgs, vals, 5.0, 25.0),
                               rtol=0, atol=1e-6)
    # The lattice approximates the exact filter (JAX's test's bounds).
    exact = bilateral.bilateral_filter_bruteforce(imgs[0], vals[0], 5.0, 30.0)
    np.testing.assert_array_equal(
        exact, jax_bilateral.bilateral_filter_bruteforce(imgs[0], vals[0], 5.0, 30.0))
    assert np.corrcoef(one.ravel(), exact.ravel())[0, 1] > 0.95
    assert np.abs(one - exact).mean() / np.abs(exact).mean() < 0.02
    with pytest.raises(ValueError, match="does not match"):
        bilateral.bilateral_filter(imgs[0][:15], vals[0], 5.0, 30.0)


def test_native_library_is_built_into_the_ports_directory():
    lib = bilateral.load_library()
    path = bilateral.library_path()
    assert path.exists() and path.parent == bilateral.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "torch_native")
    assert lib.bilateral_num_threads() >= 1


def test_the_library_name_carries_the_host():
    """``-march=native``: a library built on a host with other instruction
    sets gets another name, so it is never loaded here."""
    key = bilateral.host_key()
    assert key == bilateral.host_key() and b"-march=" in key
    assert bilateral.library_path() == bilateral.library_path(key)
    other = key.replace(b"-march=", b"-march=other-cpu ", 1)
    assert bilateral.library_path(other) != bilateral.library_path(key)
    assert bilateral.library_path(other).parent == bilateral.BUILD_DIR


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """No fallback: the JAX wrapper drops to the O(n^2) filter when its
    library is missing; the port raises."""
    cpp = tmp_path / "cpp"
    cpp.mkdir()
    for name in bilateral.SOURCES + bilateral.HEADERS:
        (cpp / name).write_text("this is not C++;\n")
    monkeypatch.setattr(bilateral, "CPP_DIR", cpp)
    monkeypatch.setattr(bilateral, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(bilateral, "_lib", None)
    img = np.zeros((4, 4, 3), np.float32)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*error"):
        bilateral.bilateral_filter(img, np.zeros((1, 4, 4), np.float32), 5.0, 30.0)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        crf.crf_inference(img, np.full((2, 4, 4), 0.5, np.float32))
    assert not list((tmp_path / "build").glob("*.so"))
