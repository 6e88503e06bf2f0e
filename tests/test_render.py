"""Render tests: bilinear upscale + RGB565 pack vs the reference math."""

import numpy as np
import jax.numpy as jnp
import pytest

from esp32_fluid_simulation_tpu.render import (upscale_bilinear, pack_rgb565,
                                               render_rgb565, render_rgb8)
from esp32_fluid_simulation_tpu.utils.uq32 import (float_to_uq32,
                                                   uq32_to_float,
                                                   uq32_top_bits)
import oracle

F = np.float32


def test_upscale_matches_oracle(rng):
    c = rng.random((3, 7, 9), dtype=F)
    got = np.asarray(upscale_bilinear(jnp.asarray(c), 4))
    want = oracle.upscale_bilinear(np.moveaxis(c, 0, -1), 4)
    np.testing.assert_allclose(got, np.moveaxis(want, -1, 0),
                               rtol=1e-5, atol=1e-6)


def test_upscale_shape_reference():
    c = jnp.zeros((3, 61, 81), F)
    out = upscale_bilinear(c, 4)
    assert out.shape == (3, 240, 320)  # .ino:36-38,115: endpoints drop out


def test_upscale_node_values_preserved(rng):
    c = rng.random((3, 5, 6), dtype=F)
    out = np.asarray(upscale_bilinear(jnp.asarray(c), 4))
    np.testing.assert_allclose(out[:, ::4, ::4], c[:, :-1, :-1], atol=1e-6)


def test_pack_rgb565_known_values():
    # pure red / green / blue / white at full intensity, no byte swap
    rgb = jnp.asarray(np.array([[[1.0]], [[0.0]], [[0.0]]], F))
    assert int(pack_rgb565(rgb, bswap=False)[0, 0]) == 0xF800
    rgb = jnp.asarray(np.array([[[0.0]], [[1.0]], [[0.0]]], F))
    assert int(pack_rgb565(rgb, bswap=False)[0, 0]) == 0x07E0
    rgb = jnp.asarray(np.array([[[0.0]], [[0.0]], [[1.0]]], F))
    assert int(pack_rgb565(rgb, bswap=False)[0, 0]) == 0x001F
    rgb = jnp.asarray(np.ones((3, 1, 1), F))
    assert int(pack_rgb565(rgb, bswap=False)[0, 0]) == 0xFFFF


def test_pack_rgb565_byteswap():
    rgb = jnp.asarray(np.array([[[1.0]], [[0.0]], [[0.0]]], F))
    plain = int(pack_rgb565(rgb, bswap=False)[0, 0])
    sw = int(pack_rgb565(rgb, bswap=True)[0, 0])
    assert sw == (((plain << 8) | (plain >> 8)) & 0xFFFF)


def test_pack_matches_uq32_oracle(rng):
    """Our float top-bit extraction equals the UQ32 masking route
    (.ino:170-172) for values away from quantization boundaries."""
    vals = rng.random((3, 8, 8)).astype(F)
    got = np.asarray(pack_rgb565(jnp.asarray(vals), bswap=True))
    want = oracle.pack_rgb565(np.moveaxis(vals, 0, -1), bswap=True)
    # tolerate off-by-one-LSB on exact bucket boundaries
    mismatch = got != want
    assert mismatch.mean() < 0.02


def test_render_jits_and_rgb8():
    c = jnp.asarray(np.random.default_rng(0).random((3, 61, 81)), F)
    frame = render_rgb565(c, s=4)
    assert frame.shape == (240, 320) and frame.dtype == jnp.uint16
    img = render_rgb8(c, s=4)
    assert img.shape == (3, 240, 320) and img.dtype == jnp.uint8


def test_uq32_roundtrip(rng):
    x = rng.random(1000).astype(F)
    raw = float_to_uq32(x)
    back = uq32_to_float(raw)
    np.testing.assert_allclose(back, x, atol=2e-7)
    assert uq32_top_bits(np.uint32(0xF8000000), 5) == 0x1F


def test_render_smoke_modes(rng):
    """3D smoke views (VERDICT r4 next #8): MIP and slice reductions with
    the heat colormap, both wire formats."""
    from esp32_fluid_simulation_tpu.render import render_smoke
    rho = jnp.asarray(rng.random((8, 16, 32), dtype=F))
    mip = render_smoke(rho, mode="mip", fmt="rgb565")
    assert mip.shape == (16, 32) and mip.dtype == jnp.uint16
    # MIP along axis 0 == colormap+pack of the numpy max
    from esp32_fluid_simulation_tpu.render.smoke import heat_colormap
    from esp32_fluid_simulation_tpu.render import pack_rgb565
    want = np.asarray(pack_rgb565(heat_colormap(jnp.max(rho, axis=0))))
    np.testing.assert_array_equal(np.asarray(mip), want)
    sl = render_smoke(rho, mode="slice", axis=2, index=5, fmt="rgb8")
    assert sl.shape == (8, 16, 3) and sl.dtype == jnp.uint8
    want8 = np.asarray(jnp.moveaxis(jnp.clip(jnp.floor(
        heat_colormap(rho[:, :, 5]) * 256.0), 0, 255).astype(jnp.uint8),
        0, -1))
    np.testing.assert_array_equal(np.asarray(sl), want8)
    # default slice index = midplane
    mid = render_smoke(rho, mode="slice", axis=0, fmt="rgb565")
    want_mid = np.asarray(pack_rgb565(heat_colormap(rho[4])))
    np.testing.assert_array_equal(np.asarray(mid), want_mid)


# -- render_rgb565 against the oracle at the removed render kernel's shapes

@pytest.mark.parametrize("bswap", [True, False])
@pytest.mark.parametrize("shape,s", [((61, 81), 4), ((33, 130), 4),
                                     ((17, 129), 2)])
def test_render_rgb565_matches_oracle(rng, shape, s, bswap):
    """Upscale + pack == the oracle's direct bilinear math + UQ32 top-bit
    pack (.ino:116-176); float bilinear vs the oracle's may land on the
    other side of a 5/6-bit bucket edge, so codes may differ by one."""
    c = rng.random((3,) + shape, dtype=F)
    got = np.asarray(render_rgb565(jnp.asarray(c), s=s, bswap=bswap))
    assert got.shape == ((shape[0] - 1) * s, (shape[1] - 1) * s)
    up = oracle.upscale_bilinear(np.moveaxis(c, 0, -1), s)
    want = oracle.pack_rgb565(up, bswap=bswap)
    if bswap:
        got, want = _unswap(got), _unswap(want)
    for shift, bits in ((11, 5), (5, 6), (0, 5)):
        g = (got.astype(np.int32) >> shift) & ((1 << bits) - 1)
        w = (want.astype(np.int32) >> shift) & ((1 << bits) - 1)
        assert np.abs(g - w).max() <= 1
    assert (got != want).mean() < 0.02


def _unswap(x):
    x = x.astype(np.int32)
    return (((x << 8) | (x >> 8)) & 0xFFFF).astype(np.uint16)


@pytest.mark.parametrize("shape,s", [((61, 81), 4), ((33, 130), 4),
                                     ((17, 129), 2)])
def test_render_rgb565_clips_at_the_nodes(rng, shape, s):
    """Every s-th pixel is its node, packed as clip(floor(c * 2^k), 0,
    2^k - 1) bit for bit, including the 0.0/1.0 endpoints and values
    outside [0, 1] (a MacCormack dye is not clamped)."""
    c = rng.random((3,) + shape, dtype=F)
    c[:, ::7, ::5] = 1.0
    c[:, 1::9, ::3] = 0.0
    c[:, 2::11, 1::4] = -0.25
    c[:, 3::13, 2::6] = 1.5
    got = np.asarray(render_rgb565(jnp.asarray(c), s=s, bswap=False))
    nodes = c[:, :-1, :-1]
    r, g, b = (np.clip(np.floor(nodes[i] * (1 << k)), 0,
                       (1 << k) - 1).astype(np.int32)
               for i, k in ((0, 5), (1, 6), (2, 5)))
    want = ((r << 11) | (g << 5) | b).astype(np.uint16)
    np.testing.assert_array_equal(got[::s, ::s], want)
