"""Unit + oracle-parity tests for semi-Lagrangian advection (advect.h)."""

import numpy as np
import jax.numpy as jnp
import pytest

from esp32_fluid_simulation_tpu.ops.advect import (advect, advect_maccormack,
                                                   sample_linear)
import oracle

F = np.float32
SHAPE = (13, 17)


def _rand_vel(rng, shape, scale=3.0):
    return (scale * rng.standard_normal((2,) + shape)).astype(F)


def _rand_field(rng, shape, channels=None):
    s = ((channels,) + shape) if channels else shape
    return rng.random(s, dtype=F)


def test_zero_velocity_is_identity(rng):
    f = _rand_field(rng, SHAPE)
    v = jnp.zeros((2,) + SHAPE, F)
    out = advect(jnp.asarray(f), v, 1 / 30, no_slip=False)
    np.testing.assert_allclose(np.asarray(out), f, rtol=0, atol=1e-7)


def test_constant_field_invariant_interior(rng):
    """Advecting a constant field returns the constant wherever the
    backtrace stays in bounds (no_slip=False keeps it constant even OOB)."""
    f = jnp.full(SHAPE, 0.625, F)
    v = jnp.asarray(_rand_vel(rng, SHAPE, scale=2.0))
    out = advect(f, v, 1 / 30, no_slip=False)
    np.testing.assert_allclose(np.asarray(out), 0.625, rtol=0, atol=1e-6)


def test_uniform_translation_of_linear_field():
    """Backtracing a linear ramp through a uniform velocity shifts it by
    exactly v*dt (bilinear interp is exact on linear fields)."""
    h, w = SHAPE
    ramp = np.add.outer(np.arange(h, dtype=F), np.zeros(w, F))
    v = np.zeros((2, h, w), F)
    v[0] = 6.0  # 6 cells/s along axis 0
    dt = 0.5
    out = np.asarray(advect(jnp.asarray(ramp), jnp.asarray(v), dt,
                            no_slip=False))
    # interior rows see ramp shifted by -3 cells
    np.testing.assert_allclose(out[4:, :], ramp[4:, :] - 3.0, atol=1e-5)


@pytest.mark.parametrize("no_slip", [False, True])
@pytest.mark.parametrize("scale", [1.0, 8.0, 40.0])
def test_matches_oracle(rng, no_slip, scale):
    """Random fields/velocities incl. far-out-of-bounds backtraces: the
    vectorized gather must match the C++ transliteration branch-for-branch
    (interior bilinear, edge lerp, corner clamp, no-slip discount)."""
    f = _rand_field(rng, SHAPE)
    v = _rand_vel(rng, SHAPE, scale=scale)
    got = np.asarray(advect(jnp.asarray(f), jnp.asarray(v), 1 / 30, no_slip))
    vel_last = np.moveaxis(v, 0, -1)
    want = oracle.advect(f, vel_last, 1 / 30, no_slip)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_matches_oracle_vector_field(rng):
    """Self-advection layout: channels-first [2,H,W] vs oracle's trailing
    channels."""
    v = _rand_vel(rng, SHAPE, scale=10.0)
    got = np.asarray(advect(jnp.asarray(v), jnp.asarray(v), 1 / 30, True))
    vel_last = np.moveaxis(v, 0, -1)
    want = oracle.advect(vel_last, vel_last, 1 / 30, True)
    np.testing.assert_allclose(got, np.moveaxis(want, -1, 0),
                               rtol=2e-6, atol=2e-6)


def test_3d_advection_runs_and_zero_vel_identity(rng):
    shape = (6, 7, 8)
    f = rng.random(shape, dtype=F)
    v = jnp.zeros((3,) + shape, F)
    out = advect(jnp.asarray(f), v, 0.1, no_slip=True)
    np.testing.assert_allclose(np.asarray(out), f, atol=1e-7)


def test_maccormack_constant_and_bounds(rng):
    f = jnp.full(SHAPE, 0.5, F)
    v = jnp.asarray(_rand_vel(rng, SHAPE, scale=2.0))
    out = advect_maccormack(f, v, 1 / 30, no_slip=False)
    np.testing.assert_allclose(np.asarray(out), 0.5, atol=1e-6)
    # limiter: no new extrema beyond the sampled stencil's range
    g = _rand_field(rng, SHAPE)
    out2 = np.asarray(advect_maccormack(jnp.asarray(g), v, 1 / 30, False))
    assert out2.min() >= g.min() - 1e-6 and out2.max() <= g.max() + 1e-6


def test_sample_linear_exact_nodes(rng):
    """Sampling exactly at node coordinates returns the node values,
    including the last row/col (clamped di=1 path)."""
    f = _rand_field(rng, SHAPE)
    ii = jnp.asarray(np.add.outer(np.arange(SHAPE[0], dtype=F),
                                  np.zeros(SHAPE[1], F)))
    jj = jnp.asarray(np.add.outer(np.zeros(SHAPE[0], F),
                                  np.arange(SHAPE[1], dtype=F)))
    out = sample_linear(jnp.asarray(f), (ii, jj), no_slip=False)
    np.testing.assert_allclose(np.asarray(out), f, atol=1e-6)


def test_maccormack_preserves_noslip_discount():
    """Regression: the monotonic clamp must not undo the no-slip wall
    discount (the stencil extrema are undiscounted node values)."""
    h, w = 16, 20
    f = jnp.full((h, w), 30.0, F)
    v = np.zeros((2, h, w), F)
    v[0] = 30.0  # backtrace from row 0 lands 1 cell outside the wall
    dt = 1 / 30.
    semi = np.asarray(advect(f, jnp.asarray(v), dt, no_slip=True))
    mac = np.asarray(advect_maccormack(f, jnp.asarray(v), dt, no_slip=True))
    # overshoot 1.0 >= 0.5 -> discount factor 0 at the wall row
    np.testing.assert_allclose(semi[0, 5:15], 0.0, atol=1e-6)
    np.testing.assert_allclose(mac[0, 5:15], semi[0, 5:15], atol=1e-5)


def test_rk2_more_accurate_on_rotation(rng):
    """Midpoint backtrace beats forward-Euler on a rotating field: advect a
    smooth blob through rigid rotation and compare against the exact
    rotation of the blob."""
    from esp32_fluid_simulation_tpu.ops.advect import advect_rk2
    h = w = 64
    ci = cj = 31.5
    ii = np.arange(h, dtype=F)[:, None]
    jj = np.arange(w, dtype=F)[None, :]
    omega = 1.2  # rad/s
    v = np.stack([-(jj - cj) * omega + 0 * ii, (ii - ci) * omega + 0 * jj])
    blob = np.exp(-(((ii - 40) ** 2 + (jj - 31.5) ** 2) / 30.0)).astype(F)
    dt = 0.25
    # exact: rotate the blob center backward by omega*dt
    th = omega * dt
    ri = (ii - ci) * np.cos(th) + (jj - cj) * np.sin(th) + ci
    rj = -(ii - ci) * np.sin(th) + (jj - cj) * np.cos(th) + cj
    exact = np.exp(-(((ri - 40) ** 2 + (rj - 31.5) ** 2) / 30.0)).astype(F)
    e1 = np.abs(np.asarray(advect(jnp.asarray(blob), jnp.asarray(v), dt,
                                  False)) - exact)
    e2 = np.abs(np.asarray(advect_rk2(jnp.asarray(blob), jnp.asarray(v), dt,
                                      False)) - exact)
    assert e2.max() < 0.5 * e1.max()


def test_rk2_zero_velocity_identity(rng):
    from esp32_fluid_simulation_tpu.ops.advect import advect_rk2
    f = _rand_field(rng, SHAPE)
    v = jnp.zeros((2,) + SHAPE, F)
    out = advect_rk2(jnp.asarray(f), v, 1 / 30, no_slip=True)
    np.testing.assert_allclose(np.asarray(out), f, atol=1e-7)


# -- the XLA-compiled op at the production step's shapes and options ------
# (the shapes the removed hand-written advection kernel was pinned at)

def _oracle_advect(f, v, dt, no_slip):
    """``[C?, H, W]`` field through ``oracle.advect`` channel by channel."""
    vel = np.moveaxis(v, 0, -1)
    if f.ndim == 2:
        return oracle.advect(f, vel, dt, no_slip)
    return np.stack([oracle.advect(c, vel, dt, no_slip) for c in f])


@pytest.mark.parametrize("no_slip", [False, True])
@pytest.mark.parametrize("shape", [(61, 81), (96, 200)])
def test_advect_matches_oracle_at_step_shapes(rng, shape, no_slip):
    f = _rand_field(rng, shape)
    v = _rand_vel(rng, shape, scale=60.0)
    got = np.asarray(advect(jnp.asarray(f), jnp.asarray(v), 1 / 30., no_slip))
    np.testing.assert_allclose(got, _oracle_advect(f, v, 1 / 30., no_slip),
                               rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_dye_advect_clip01_matches_oracle(rng, dtype):
    """The step's dye stage, ``clip(advect(dye), 0, 1)``, with values pushed
    outside [0, 1] so the clamp acts.  bf16 dye interpolates in bf16: the
    nested lerp rounds three times at magnitudes below 2 (ulp 2^-7)."""
    shape = (48, 96)
    f = (3.0 * _rand_field(rng, shape, channels=3) - 1.0)
    f = np.asarray(jnp.asarray(f).astype(dtype), F)
    v = _rand_vel(rng, shape, scale=90.0)
    got = jnp.clip(advect(jnp.asarray(f).astype(dtype), jnp.asarray(v),
                          1 / 30., no_slip=False), 0.0, 1.0)
    assert got.dtype == dtype
    want = np.clip(_oracle_advect(f, v, 1 / 30., False), 0.0, 1.0)
    tol = 2e-5 if dtype == jnp.float32 else 3 * 2 ** -7
    np.testing.assert_allclose(np.asarray(got, F), want, rtol=0, atol=tol)


@pytest.mark.parametrize("shape", [(96, 256), (88, 200)])
def test_self_advect_matches_oracle(rng, shape):
    """Velocity self-advect (no-slip), the step's first stage."""
    v = _rand_vel(rng, shape, scale=80.0)
    got = np.asarray(advect(jnp.asarray(v), jnp.asarray(v), 1 / 30., True))
    vel = np.moveaxis(v, 0, -1)
    want = np.moveaxis(oracle.advect(vel, vel, 1 / 30., True), -1, 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_advect_multichannel_matches_oracle(rng):
    shape = (96, 200)
    f = _rand_field(rng, shape, channels=3)
    v = _rand_vel(rng, shape, scale=30.0)
    got = np.asarray(advect(jnp.asarray(f), jnp.asarray(v), 1 / 30., False))
    np.testing.assert_allclose(got, _oracle_advect(f, v, 1 / 30., False),
                               rtol=1e-5, atol=2e-5)
