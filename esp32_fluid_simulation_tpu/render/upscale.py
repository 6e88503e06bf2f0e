"""On-device render: separable bilinear upscale + RGB565 pack.

Capability match for the reference's ``draw_routine`` (``.ino:99-191``),
which upscales the (H-1)x(W-1) cell grid 4x to 320x240 by incremental
separable bilinear interpolation (``.ino:128-162``) and packs
``Vector3<UQ32>`` to RGB565 by masking the top 5/6/5 bits of each 32-bit
channel plus a byte swap for SPI order (``.ino:164-176``).

Device design: the reference's per-pixel incremental ``c += dc`` strength
reduction is a scalar-CPU trick; here the same separable bilinear math is
two broadcasted lerps (one fused XLA pass), and the whole render runs on
device so only final packed pixels ever cross to the host (the BASELINE
north-star requirement).  The last node row/column are lerp endpoints with no screen
area (``.ino:115``), hence the output is ``((H-1)*s, (W-1)*s)``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def upscale_bilinear(color: jax.Array, s: int) -> jax.Array:
    """Bilinear-upsample ``[C, H, W] -> [C, (H-1)*s, (W-1)*s]``.

    Output pixel ``(i*s + a, j*s + b)`` is the bilinear blend of nodes
    ``{i,i+1}x{j,j+1}`` at fractions ``(a/s, b/s)`` — identical math to the
    reference's incremental lerps (``.ino:128-162``) without the serial
    accumulation.
    """
    if s == 1:
        return color[:, :-1, :-1]
    c = color.astype(jnp.float32)
    ch, h, w = c.shape
    t = (jnp.arange(s, dtype=jnp.float32) / s)
    # Rows: lerp node rows i and i+1 at fractions t -> [C, H-1, s, W]
    r0 = c[:, :-1, :][:, :, None, :]
    r1 = c[:, 1:, :][:, :, None, :]
    tr = t[None, None, :, None]
    rows = r0 * (1 - tr) + r1 * tr
    rows = rows.reshape(ch, (h - 1) * s, w)
    # Cols: lerp node cols j and j+1 at fractions t -> [C, (H-1)s, W-1, s]
    c0 = rows[:, :, :-1][:, :, :, None]
    c1 = rows[:, :, 1:][:, :, :, None]
    tc = t[None, None, None, :]
    out = c0 * (1 - tc) + c1 * tc
    return out.reshape(ch, (h - 1) * s, (w - 1) * s)


def pack_rgb565(rgb: jax.Array, bswap: bool = True) -> jax.Array:
    """Pack ``[3, H, W]`` unit floats to uint16 RGB565.

    The reference keeps the top 5/6/5 bits of each UQ32 channel
    (``.ino:170-172``): for a unit float ``c`` that is ``floor(c * 2^k)``
    clipped to ``2^k - 1``.  ``bswap`` reproduces ``__builtin_bswap16``
    (``.ino:173``), the SPI byte order of the LCD path.
    """
    def chan(c, bits):
        # cast-then-clip is result-identical to the reference's
        # floor-then-clip for every finite input (truncation vs floor only
        # differ on negatives, which clip to 0 either way)
        q = (c.astype(jnp.float32) * (1 << bits)).astype(jnp.int32)
        return jnp.clip(q, 0, (1 << bits) - 1)

    r = chan(rgb[0], 5)
    g = chan(rgb[1], 6)
    b = chan(rgb[2], 5)
    word = (r << 11) | (g << 5) | b
    if bswap:
        word = ((word << 8) | (word >> 8)) & 0xFFFF
    return word.astype(jnp.uint16)


@functools.partial(jax.jit, static_argnames=("s", "bswap"))
def render_rgb565(color: jax.Array, s: int = 4, bswap: bool = True):
    """Full on-device render: upscale + RGB565 pack.  XLA fuses the lerps
    and the pack into one loop, so only uint16 pixels are written."""
    return pack_rgb565(upscale_bilinear(color, s), bswap=bswap)


render_rgb8 = jax.jit(
    lambda color, s=4: jnp.clip(
        jnp.floor(upscale_bilinear(color, s) * 256.0), 0, 255
    ).astype(jnp.uint8),
    static_argnames=("s",),
)
render_rgb8.__doc__ = """RGB888 render for host-side demo output (PNG/PPM)."""


@functools.partial(jax.jit, static_argnames=("d",))
def decimate_mean(color: jax.Array, d: int) -> jax.Array:
    """d:1 mean-pool of ``[C, H, W]`` for the stream view (the LCD is
    smaller than the sim; the reference upscales, production grids
    downsample).  Two slice-add passes (rows, then columns on the
    already-reduced array) anti-alias for free.

    Non-divisible dims are cropped to the largest d-multiple first (the
    reference's own 61x81 grid divides by nothing; the old strided slice
    accepted any d and this must too)."""
    if d == 1:
        return color
    _, h, w = color.shape
    hc, wc = (h // d) * d, (w // d) * d
    if hc == 0 or wc == 0:
        raise ValueError(f"decimation {d} exceeds grid {h}x{w}")
    color = color[:, :hc, :wc]
    r = color[:, 0::d]
    for i in range(1, d):
        r = r + color[:, i::d]
    out = r[:, :, 0::d]
    for i in range(1, d):
        out = out + r[:, :, i::d]
    return (out * jnp.asarray(1.0 / (d * d), jnp.float32).astype(out.dtype))


@functools.partial(jax.jit, static_argnames=("s",))
def render_rgbx(color: jax.Array, s: int = 4) -> jax.Array:
    """Packed RGBX8888 render: one uint32/px, little-endian R|G<<8|B<<16.

    Full-color alternative wire format for the MJPEG stream: one uint32
    plane instead of a ``[H, W, 3]`` uint8 array with a size-3 minor axis;
    the native encoder consumes the 4-byte pixels directly (libjpeg-turbo
    JCS_EXT_RGBX).  The server's default wire
    format is RGB565 (half the device->host bytes, the reference's own
    display format, .ino:164-176); use this one when the stream must be
    8-bit lossless per channel.  Channel quantization matches
    ``render_rgb8`` exactly (same bytes)."""
    up = upscale_bilinear(color, s)

    def q(c):
        return jnp.clip(jnp.floor(c * 256.0), 0, 255).astype(jnp.uint32)

    return q(up[0]) | (q(up[1]) << 8) | (q(up[2]) << 16)
