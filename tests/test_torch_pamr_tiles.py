"""K3's tile route (``csrc/pamr.cu::pamr_affinity_tile_kernel``), its order
of arithmetic emulated on the CPU and held to the gate that
``chip_smoke.py`` holds the kernel to.

A block owns a tile of kTileRows x kTileCols output pixels. It stages the
guidance one channel at a time as a halo tile: the output tile plus
R = max |d| on every side, each source index clamped into the image,
which replicates the edges. Each thread then reads its taps from the halo
tile: the sum and the sum of squared deviations over the 9n window taps
in window order, mean = s1 / 9n, std = sqrt(s2 / (9n - 1)),
inv = 1 / (1e-8 + 0.1 std) rounded once, and logit_p += -|tap_p - x| * inv
in channel order. Then logit_p * (1 / K), the softmax's exponentials
summed in p order, and each one times 1 / sum.

Here those steps run in float32 torch on seeded numpy inputs, on every
tile at once, with the tile sizes and the halo limit read from the
kernel's source. The emulation is held against the port's plain version
and against the JAX package's affinity (``_local_std`` and ``_neighbors``
of ``acr_wsss_tpu/ops/pamr.py``): at 384x384 with the recipe's dilations
(a partial last tile where 8 or 32 does not divide the side), 65x131
(partial tiles in both axes), 17x13 with dilation 24 (an image smaller
than its halo) and one channel at 5x300 with dilations 1..8.
"""

import functools
import pathlib
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from acr_wsss_tpu.ops import pamr as jax_pamr
from acr_wsss_tpu_torch.ops.pamr import pamr_affinity_plain, window_offsets

SOURCE = (pathlib.Path(__file__).resolve().parent.parent
          / "acr_wsss_tpu_torch" / "csrc" / "pamr.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


TILE_ROWS, TILE_COLS, MAX_HALO = (_constant(n) for n in ("kTileRows", "kTileCols", "kMaxHalo"))
# The gate of chip_smoke.py, with the reasons given there.
RTOL, ATOL = 2e-5, 2e-6
PRODUCTION = (1, 2, 4, 8, 12, 24)
SHAPES = [((1, 3, 384, 384), PRODUCTION), ((2, 3, 65, 131), PRODUCTION),
          ((1, 3, 17, 13), (1, 24)), ((1, 1, 5, 300), tuple(range(1, 9)))]


def tile_origins(h, w):
    """(y0, x0) of each block's tile, in the kernel's order of blockIdx.x."""
    tiles_x = -(-w // TILE_COLS)
    return [(bid // tiles_x * TILE_ROWS, bid % tiles_x * TILE_COLS)
            for bid in range(tiles_x * -(-h // TILE_ROWS))]


def halo_tiles(plane, origins, r):
    """(tiles, kTileRows + 2R, kTileCols + 2R): each tile's halo, source
    indices clamped into the (H, W) plane."""
    h, w = plane.shape
    y0 = torch.tensor([o[0] for o in origins])
    x0 = torch.tensor([o[1] for o in origins])
    rows = (y0[:, None] - r + torch.arange(TILE_ROWS + 2 * r)).clamp(0, h - 1)
    cols = (x0[:, None] - r + torch.arange(TILE_COLS + 2 * r)).clamp(0, w - 1)
    return plane[rows[:, :, None], cols[:, None, :]]


def emulated_affinity(x, dilations):
    """(B, K, H, W) float32 -> (B, P, H, W): the tile kernel's steps."""
    b_, k_, h, w = x.shape
    r = max(abs(d) for d in dilations)
    assert r <= MAX_HALO
    origins = tile_origins(h, w)
    taps = window_offsets(dilations)
    t_ = len(taps)
    neighbours = [t for i, t in enumerate(taps) if i % 9 != 4]
    out = torch.zeros((b_, 8 * len(dilations), h, w))
    for b in range(b_):
        logits = [torch.zeros((len(origins), TILE_ROWS, TILE_COLS)) for _ in neighbours]
        for k in range(k_):
            halo = halo_tiles(x[b, k], origins, r)

            def tap(dy, dx, halo=halo):
                return halo[:, r - dy:r - dy + TILE_ROWS, r - dx:r - dx + TILE_COLS]

            s1 = torch.zeros_like(logits[0])
            for dy, dx in taps:
                s1 = s1 + tap(dy, dx)
            mean = s1 / t_
            s2 = torch.zeros_like(s1)
            for dy, dx in taps:
                v = tap(dy, dx) - mean
                s2 = s2 + v * v
            inv = 1.0 / (1e-8 + 0.1 * torch.sqrt(s2 / (t_ - 1)))
            centre = tap(0, 0)
            for p, (dy, dx) in enumerate(neighbours):
                logits[p] = logits[p] + -(tap(dy, dx) - centre).abs() * inv
        inv_k = torch.tensor(1.0, dtype=torch.float32) / k_
        lg = torch.stack(logits) * inv_k                    # (P, tiles, rows, cols)
        e = torch.exp(lg - lg.max(dim=0).values)
        total = torch.zeros_like(e[0])
        for p in range(e.shape[0]):
            total = total + e[p]
        aff = e * (1.0 / total)
        for t, (y0, x0) in enumerate(origins):
            hh, ww = min(TILE_ROWS, h - y0), min(TILE_COLS, w - x0)
            out[b, :, y0:y0 + hh, x0:x0 + ww] = aff[:, t, :hh, :ww]
    return out


def _guidance(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@functools.partial(jax.jit, static_argnums=1)
def _jax_affinity(x, dilations):
    logits = -jnp.abs(jax_pamr._neighbors(x, dilations) - x[:, :, None]) \
        / (1e-8 + 0.1 * jax_pamr._local_std(x, dilations))
    return jax.nn.softmax(jnp.mean(logits, axis=1), axis=1)


def test_the_tile_route_takes_the_recipe_dilations():
    assert MAX_HALO >= max(PRODUCTION)
    assert TILE_COLS == 32                       # one warp per tile row: 128-byte stores
    assert TILE_COLS + 2 * MAX_HALO <= 3 * 32    # a lane stages three columns of a halo row


@pytest.mark.parametrize("h,w", [(384, 384), (65, 131), (17, 13), (5, 300), (8, 32), (1, 1)])
def test_tiles_cover_every_pixel_once(h, w):
    count = np.zeros((h, w), np.int64)
    for y0, x0 in tile_origins(h, w):
        assert 0 <= y0 < h and 0 <= x0 < w
        count[y0:y0 + TILE_ROWS, x0:x0 + TILE_COLS] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("shape,dilations", SHAPES)
def test_emulated_tiles_match_the_plain_version(shape, dilations):
    x = torch.from_numpy(_guidance(shape, seed=shape[-1]))
    got = emulated_affinity(x, dilations)
    torch.testing.assert_close(got, pamr_affinity_plain(x, dilations), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape,dilations", SHAPES)
def test_emulated_tiles_match_the_jax_affinity(shape, dilations):
    x = _guidance(shape, seed=shape[-2])
    got = emulated_affinity(torch.from_numpy(x), dilations)
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax_affinity(jnp.asarray(x), dilations)),
                               rtol=RTOL, atol=ATOL)


def test_flat_guidance_gives_equal_weights():
    x = torch.full((1, 3, 20, 40), 0.5)
    got = emulated_affinity(x, PRODUCTION)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, torch.full_like(got, 1.0 / 48), rtol=1e-6, atol=0)
