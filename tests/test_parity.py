"""Physics-parity gate: the jitted step vs the C++ transliteration
oracle at the reference 61x81 grid with scripted impulses (BASELINE config 1,
SURVEY.md §4.2)."""

import numpy as np
import jax.numpy as jnp
import pytest

from esp32_fluid_simulation_tpu import (SimConfig, Impulses, init_state,
                                        make_step)
from esp32_fluid_simulation_tpu.models.stable_fluids import init_color
import oracle

F = np.float32


def _scripted_impulses(step_idx):
    """Deterministic drags in sim frame: a couple of pokes per step."""
    return [
        ((10 + step_idx, 20), (120.0, -60.0)),
        ((30, 40 + step_idx), (-90.0, 150.0)),
        ((45, 60), (50.0, 50.0)),
    ]


def test_init_color_matches_oracle():
    cfg = SimConfig()  # (61, 81)
    got = np.asarray(init_state(cfg).color)  # [3, H, W]
    want = oracle.init_color(61, 81)  # [H, W, 3]
    np.testing.assert_allclose(got, np.moveaxis(want, -1, 0),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("steps", [3])
def test_full_step_parity(steps):
    cfg = SimConfig()
    h, w = cfg.shape
    state = init_state(cfg)
    step_fn = make_step(cfg, donate=False)

    vel_o = np.zeros((h, w, 2), F)
    col_o = oracle.init_color(h, w)

    for t in range(steps):
        imps = _scripted_impulses(t)
        pos = [p for p, _ in imps]
        vel = [v for _, v in imps]
        state = step_fn(state, Impulses.from_lists(cfg, pos, vel))
        vel_o, col_o, _, _ = oracle.step(vel_o, col_o, imps, dt=cfg.dt,
                                         dx=cfg.dx, iters=cfg.sor_iters,
                                         omega=cfg.omega)

    got_v = np.asarray(state.velocity)
    got_c = np.asarray(state.color)
    np.testing.assert_allclose(got_v, np.moveaxis(vel_o, -1, 0),
                               rtol=1e-4, atol=2e-4)
    # dye clip to [0,1] in our step is a no-op vs oracle within tolerance
    np.testing.assert_allclose(got_c, np.clip(np.moveaxis(col_o, -1, 0), 0, 1),
                               rtol=1e-4, atol=2e-4)
    assert int(state.step) == steps


def test_projection_reduces_divergence():
    """After one projected step from an impulse-kicked state, the remaining
    divergence is a small fraction of the pre-projection divergence."""
    from esp32_fluid_simulation_tpu import make_step_with_metrics
    cfg = SimConfig()
    state = init_state(cfg)
    fn = make_step_with_metrics(cfg, donate=False)
    imp = Impulses.from_lists(cfg, [(30, 40), (31, 41)],
                              [(300.0, 0.0), (0.0, -300.0)])
    state, m = fn(state, imp)
    # 10 SOR sweeps (the reference budget) only partially kill a fresh point
    # impulse's divergence — expect a solid reduction, not elimination.
    assert float(m["div_post_max"]) < 0.75 * float(m["div_pre_max"])
    assert bool(m["finite"])


def test_fuzzed_step_parity(rng):
    """Randomized impulse schedules, 6 steps, full oracle parity at the
    reference grid — the golden-dump workflow as a property test."""
    cfg = SimConfig()
    h, w = cfg.shape
    state = init_state(cfg)
    step_fn = make_step(cfg, donate=False)
    vel_o = np.zeros((h, w, 2), F)
    col_o = oracle.init_color(h, w)
    for t in range(6):
        n = int(rng.integers(0, 5))
        imps = [((int(rng.integers(0, h)), int(rng.integers(0, w))),
                 (float(rng.uniform(-250, 250)), float(rng.uniform(-250, 250))))
                for _ in range(n)]
        pos = [p for p, _ in imps]
        vel = [v for _, v in imps]
        state = step_fn(state, Impulses.from_lists(cfg, pos, vel))
        vel_o, col_o, _, _ = oracle.step(vel_o, col_o, imps, dt=cfg.dt,
                                         dx=cfg.dx, iters=cfg.sor_iters,
                                         omega=cfg.omega)
    np.testing.assert_allclose(np.asarray(state.velocity),
                               np.moveaxis(vel_o, -1, 0),
                               rtol=2e-4, atol=5e-4)
    np.testing.assert_allclose(np.asarray(state.color),
                               np.clip(np.moveaxis(col_o, -1, 0), 0, 1),
                               rtol=2e-4, atol=5e-4)
