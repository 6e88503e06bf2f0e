"""Model-level tests: step mechanics, impulses, config, checkpoint, watchdog."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from esp32_fluid_simulation_tpu import (SimConfig, SimState, Impulses,
                                        init_state, make_step)
from esp32_fluid_simulation_tpu.models.stable_fluids import apply_impulses
from esp32_fluid_simulation_tpu.utils.checkpoint import (
    save_checkpoint, load_checkpoint, dump_arr, load_arr)
from esp32_fluid_simulation_tpu.utils.watchdog import make_guarded_step
from esp32_fluid_simulation_tpu.io_host.touch import (
    TouchCalibration, drags_from_touch_trace, drags_to_impulses,
    scripted_swirl)

F = np.float32


def test_init_state_shapes():
    cfg = SimConfig()
    s = init_state(cfg)
    assert s.velocity.shape == (2, 61, 81)
    assert s.color.shape == (3, 61, 81)
    assert float(jnp.max(jnp.abs(s.velocity))) == 0.0
    # dye stays in [0,1] and sums to ~1 per pixel after blur
    total = np.asarray(jnp.sum(s.color, axis=0))
    np.testing.assert_allclose(total, 1.0, atol=1e-5)


def test_apply_impulses_order_and_mask():
    cfg = SimConfig(max_impulses=4)
    vel = jnp.zeros((2, 61, 81), F)
    imp = Impulses(
        pos=jnp.asarray([[5, 5], [5, 5], [9, 9], [0, 0]], jnp.int32),
        velocity=jnp.asarray([[1, 1], [2, 2], [3, 3], [7, 7]], F),
        active=jnp.asarray([True, True, True, False]),
    )
    out = np.asarray(apply_impulses(vel, imp))
    assert out[0, 5, 5] == 2.0  # later drag overwrites earlier (.ino:265-268)
    assert out[0, 9, 9] == 3.0
    assert out[0, 0, 0] == 0.0  # inactive slot ignored


def test_impulse_clamping():
    cfg = SimConfig(max_impulses=2)
    vel = jnp.zeros((2, 61, 81), F)
    imp = Impulses(
        pos=jnp.asarray([[100, 100], [-5, -5]], jnp.int32),
        velocity=jnp.asarray([[1, 1], [2, 2]], F),
        active=jnp.asarray([True, True]),
    )
    out = np.asarray(apply_impulses(vel, imp))
    assert out[0, 60, 80] == 1.0 and out[0, 0, 0] == 2.0


def test_step_donation_and_counter():
    cfg = SimConfig()
    fn = make_step(cfg, donate=True)
    state = init_state(cfg)
    none = Impulses.none(cfg)
    for _ in range(3):
        state = fn(state, none)
    assert int(state.step) == 3
    assert bool(jnp.all(jnp.isfinite(state.velocity)))


def test_solver_variants_agree_loosely():
    """Jacobi and SOR project to qualitatively the same divergence-free
    field (BASELINE config 2 A/B)."""
    imp_pos, imp_vel = [(20, 30)], [(200.0, -100.0)]
    outs = {}
    for solver, iters in (("sor", 10), ("jacobi", 40)):
        cfg = SimConfig(shape=(33, 41), solver=solver, sor_iters=iters)
        fn = make_step(cfg, donate=False)
        st = fn(init_state(cfg), Impulses.from_lists(cfg, imp_pos, imp_vel))
        outs[solver] = np.asarray(st.velocity)
    diff = np.abs(outs["sor"] - outs["jacobi"]).max()
    scale = np.abs(outs["sor"]).max()
    assert diff < 0.15 * scale


def test_maccormack_and_vorticity_step_runs():
    cfg = SimConfig(shape=(33, 41), advector="maccormack", vorticity_eps=2.0)
    fn = make_step(cfg, donate=False)
    st = fn(init_state(cfg),
            Impulses.from_lists(cfg, [(16, 20)], [(100.0, 50.0)]))
    assert bool(jnp.all(jnp.isfinite(st.velocity)))
    assert bool(jnp.all(jnp.isfinite(st.color)))


def test_config_json_roundtrip():
    cfg = SimConfig(shape=(128, 128), solver="jacobi", dtype="bfloat16")
    cfg2 = SimConfig.from_json(cfg.to_json())
    assert cfg == cfg2


def test_config_rejects_degenerate_adaptive():
    """sor_check_every=0 would spin the adaptive solve's on-device
    while_loop forever (zero sweeps per iteration); the config refuses."""
    import pytest
    with pytest.raises(ValueError):
        SimConfig(shape=(64, 64), solver="sor_adaptive", sor_check_every=0)
    with pytest.raises(ValueError):
        SimConfig(shape=(64, 64), solver="sor_adaptive", sor_tol=0.0)


def test_checkpoint_roundtrip(tmp_path):
    cfg = SimConfig(shape=(17, 19))
    state = init_state(cfg)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, state, cfg)
    state2, cfg2 = load_checkpoint(path)
    assert cfg2 == cfg
    np.testing.assert_array_equal(np.asarray(state.color),
                                  np.asarray(state2.color))


def test_arr_dump_roundtrip(tmp_path):
    x = np.random.default_rng(0).random((61, 81)).astype(F)
    p = str(tmp_path / "sim_pressure.arr")
    dump_arr(p, jnp.asarray(x))
    np.testing.assert_array_equal(load_arr(p), x)


def test_watchdog_detects_and_resets():
    """Fault injection (SURVEY §5): salt the state with NaN and verify the
    guarded step detects it and resets to the initial condition."""
    cfg = SimConfig(shape=(17, 19))
    fn = make_guarded_step(cfg, donate=False)
    state = init_state(cfg)
    none = Impulses.none(cfg)
    state, reset = fn(state, none)
    assert not bool(reset)
    bad = SimState(
        velocity=state.velocity.at[0, 3, 3].set(jnp.nan),
        color=state.color, step=state.step)
    state2, reset2 = fn(bad, none)
    assert bool(reset2)
    assert bool(jnp.all(jnp.isfinite(state2.velocity)))
    assert float(jnp.max(jnp.abs(state2.velocity))) == 0.0


def test_touch_pipeline_semantics():
    cfg = SimConfig()
    cal = TouchCalibration()
    # two consecutive touches -> exactly one drag (first poll only seeds)
    trace = [(False, 0, 0), (True, 1000, 1000), (True, 1200, 1100),
             (False, 0, 0), (True, 2000, 2000)]
    drags = drags_from_touch_trace(trace, cfg, cal)
    assert len(drags) == 1
    (gx, gy), (vx, vy) = drags[0]
    # velocity = delta_cells * 1000/10ms (.ino:83)
    imp = drags_to_impulses(drags, cfg)
    # sim frame swaps x/y (.ino:264-268)
    assert int(imp.pos[0, 0]) == gy and int(imp.pos[0, 1]) == gx
    assert float(imp.velocity[0, 0]) == vy and float(imp.velocity[0, 1]) == vx


def test_scripted_swirl_impulses():
    cfg = SimConfig()
    imp = scripted_swirl(cfg, t_step=0)
    assert bool(jnp.any(imp.active))
    assert int(jnp.max(imp.pos[:, 0])) < 61
    assert int(jnp.max(imp.pos[:, 1])) < 81


def test_orbax_checkpoint_roundtrip(tmp_path):
    from esp32_fluid_simulation_tpu.utils.checkpoint import (
        save_checkpoint_orbax, load_checkpoint_orbax)
    cfg = SimConfig(shape=(17, 19))
    state = init_state(cfg)
    path = str(tmp_path / "orbax_ck")
    save_checkpoint_orbax(path, state, cfg)
    state2, cfg2 = load_checkpoint_orbax(path, state)
    assert cfg2 == cfg
    np.testing.assert_array_equal(np.asarray(state.color),
                                  np.asarray(state2.color))


def test_multi_step_scan_matches_sequential():
    """make_multi_step (lax.scan runner) == stepping one frame at a time."""
    from esp32_fluid_simulation_tpu import (SimConfig, Impulses, init_state,
                                            make_step, make_multi_step,
                                            stack_schedule)
    from esp32_fluid_simulation_tpu.io_host.touch import scripted_swirl
    cfg = SimConfig(shape=(33, 49), sor_iters=4)
    imps = [scripted_swirl(cfg, t, speed=120.0) for t in range(5)]

    st_a = init_state(cfg)
    fn = make_step(cfg, donate=False)
    for imp in imps:
        st_a = fn(st_a, imp)

    st_b = make_multi_step(cfg, donate=False)(init_state(cfg),
                                              stack_schedule(imps))
    np.testing.assert_array_equal(np.asarray(st_a.velocity),
                                  np.asarray(st_b.velocity))
    np.testing.assert_array_equal(np.asarray(st_a.color),
                                  np.asarray(st_b.color))
    assert int(st_b.step) == 5


# -- step_render composes step and render in one program -----------------

@pytest.mark.parametrize("bswap", [True, False])
@pytest.mark.parametrize("cfg_kw", [
    dict(color_dtype="float32"),
    dict(color_dtype="bfloat16"),
    dict(color_dtype="bfloat16", domain_tile=(32, 64)),
], ids=["f32", "bf16", "bf16_tiled"])
def test_step_render_matches_step_then_render(cfg_kw, bswap):
    """step_render(scaling=1) == render_rgb565(step(...).color, s=1),
    bit for bit, on a single domain and on a tiled supergrid."""
    from esp32_fluid_simulation_tpu import render_rgb565, step, step_render
    cfg = SimConfig(shape=(64, 128), scaling=1, sor_iters=4, **cfg_kw)
    st = init_state(cfg)
    imp = Impulses.from_lists(cfg, [(5, 7), (20, 40), (40, 100)],
                              [(30.0, -12.0), (-8.0, 25.0), (50.0, 60.0)])
    got, frame = jax.jit(functools.partial(step_render, cfg=cfg,
                                           bswap=bswap))(st, imp)
    ref = jax.jit(functools.partial(step, cfg=cfg))(st, imp)
    want = render_rgb565(ref.color, s=1, bswap=bswap)
    assert frame.shape == (63, 127) and frame.dtype == jnp.uint16
    np.testing.assert_array_equal(np.asarray(got.velocity),
                                  np.asarray(ref.velocity))
    np.testing.assert_array_equal(np.asarray(got.color, F),
                                  np.asarray(ref.color, F))
    np.testing.assert_array_equal(np.asarray(frame), np.asarray(want))


@pytest.mark.parametrize("positions", [
    [(20, 30), (20, 30), (40, 50)],
    [(20, 30), (40, 50), (20, 30), (99, -3), (61, 96)],
], ids=["duplicate", "duplicate_and_clamped"])
def test_impulses_last_wins_through_projection(rng, positions):
    """Queue-drain order (the LAST active slot wins at a duplicated cell,
    out-of-range positions clamp) survives the projection: apply_impulses
    then divergence -> RB-SOR -> gradient == the oracle's .ino:264-278."""
    import oracle
    from esp32_fluid_simulation_tpu.models.stable_fluids import _project
    cfg = SimConfig(shape=(64, 96), sor_iters=3)
    vel = rng.normal(0, 40, (2, 64, 96)).astype(F)
    vels = [(90.0, -45.0), (33.0, 44.0), (-60.0, 120.0), (7.0, 8.0),
            (-5.0, 6.0)][:len(positions)]
    imp = Impulses.from_lists(cfg, positions, vels)
    got = np.asarray(_project(apply_impulses(jnp.asarray(vel), imp), cfg))
    v = oracle.apply_impulses(np.moveaxis(vel, 0, -1).copy(),
                              list(zip(positions, vels)))
    p = oracle.poisson_solve(oracle.divergence(v), iters=3)
    want = np.moveaxis(oracle.subtract_gradient(v, p), -1, 0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


# -- options that once selected a hand-written kernel are refused --------

@pytest.mark.parametrize("kw", [
    dict(advect_impl="pallas"), dict(advect_impl="jnp"),
    dict(advect_max_disp=12), dict(advect_sample_dtype="bfloat16"),
    dict(solver="sor_pallas"), dict(solver="fused_pallas"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_config_rejects_removed_kernel_options(kw):
    import json
    import dataclasses
    with pytest.raises(ValueError, match="removed.*(drop it|use solver)"):
        SimConfig(**kw)
    with pytest.raises(ValueError, match="removed"):
        SimConfig.from_json(json.dumps({"shape": [8, 8], **kw}))
    with pytest.raises(ValueError, match="removed"):
        dataclasses.replace(SimConfig(), **kw)


@pytest.mark.parametrize("field", ["advect_impl", "advect_max_disp",
                                   "sor_impl", "sor_chunk"])
def test_smoke_config_rejects_removed_kernel_options(field):
    from esp32_fluid_simulation_tpu.models.smoke3d import SmokeConfig
    with pytest.raises(ValueError, match=f"{field}.*removed"):
        SmokeConfig(**{field: 2})
