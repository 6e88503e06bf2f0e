"""3D smoke model and vmap ensemble tests (BASELINE configs 4/5)."""

import numpy as np
import jax
import jax.numpy as jnp

from esp32_fluid_simulation_tpu import SimConfig, Impulses, init_state, make_step
from esp32_fluid_simulation_tpu.models.smoke3d import (SmokeConfig, init_smoke,
                                                       make_smoke_step)
from esp32_fluid_simulation_tpu.models.ensemble import (init_ensemble,
                                                        stack_impulses,
                                                        make_ensemble_step)

F = np.float32


def test_smoke_plume_rises():
    cfg = SmokeConfig(shape=(32, 24, 24), mg_cycles=1)
    fn = make_smoke_step(cfg, donate=False)
    st = init_smoke(cfg)
    for _ in range(25):
        st = fn(st)
    rho = np.asarray(st.density)
    assert np.isfinite(rho).all() and rho.max() > 0.05
    # source sits near axis-0 index ~0.9*D (bottom); buoyancy pushes smoke to
    # lower indices (up): there must be smoke well above the source sphere
    src_top = int(0.9 * 32 - 0.08 * 24) - 2
    above = rho[:src_top].sum()
    assert above > 0.0
    v = np.asarray(st.velocity)
    assert np.isfinite(v).all()
    # net vertical motion is upward (negative axis-0 velocity where smoke is)
    w_up = (v[0] * rho).sum()
    assert w_up < 0


def test_smoke_bf16_scalars():
    """scalar_dtype='bfloat16' keeps density/temperature bf16 end-to-end
    (velocity/pressure stay f32) and still produces a rising plume close to
    the f32 run (the bench's 256^3 config uses this, mirroring the 2D
    production config's bf16 dye)."""
    import jax.numpy as jnp
    kw = dict(shape=(32, 24, 24), mg_cycles=1)
    st_b = init_smoke(SmokeConfig(scalar_dtype="bfloat16", **kw))
    fn_b = make_smoke_step(SmokeConfig(scalar_dtype="bfloat16", **kw),
                           donate=False)
    st_f = init_smoke(SmokeConfig(scalar_dtype="float32", **kw))
    fn_f = make_smoke_step(SmokeConfig(scalar_dtype="float32", **kw),
                           donate=False)
    for _ in range(25):
        st_b = fn_b(st_b)
        st_f = fn_f(st_f)
    assert st_b.density.dtype == jnp.bfloat16
    assert st_b.temperature.dtype == jnp.bfloat16
    assert st_b.velocity.dtype == jnp.float32
    rho_b = np.asarray(st_b.density, np.float32)
    rho_f = np.asarray(st_f.density, np.float32)
    assert np.isfinite(rho_b).all()
    # same plume to bf16 tolerance: total smoke mass within a few percent
    assert abs(rho_b.sum() - rho_f.sum()) < 0.05 * max(rho_f.sum(), 1e-6)
    v_b = np.asarray(st_b.velocity)
    assert np.isfinite(v_b).all() and (v_b[0] * rho_b).sum() < 0


def test_smoke_divergence_controlled():
    from esp32_fluid_simulation_tpu.ops.fd import divergence
    cfg = SmokeConfig(shape=(16, 16, 16), solver="sor", sor_iters=8)
    fn = make_smoke_step(cfg, donate=False)
    st = init_smoke(cfg)
    for _ in range(6):
        st = fn(st)
    div = np.asarray(divergence(st.velocity))
    speed = np.abs(np.asarray(st.velocity)).max() + 1e-6
    assert np.abs(div).max() < 0.7 * speed


def test_ensemble_members_independent():
    cfg = SimConfig(shape=(24, 32), max_impulses=2)
    n = 4
    st = init_ensemble(cfg, n)
    fn = make_ensemble_step(cfg, donate=False)
    imps = [Impulses.from_lists(cfg, [(12, 16)], [(float(60 + 40 * k), 0.0)])
            for k in range(n)]
    batched = stack_impulses(imps)
    for _ in range(3):
        st = fn(st, batched)
        batched = stack_impulses([Impulses.none(cfg)] * n)
    v = np.asarray(st.velocity)
    assert v.shape == (n, 2, 24, 32)
    # members got different kicks -> different fields
    assert not np.allclose(v[0], v[1])
    assert not np.allclose(v[1], v[3])
    # each member matches an unbatched run with the same schedule
    single = make_step(cfg, donate=False)
    s = init_state(cfg)
    s = single(s, imps[2])
    s = single(s, Impulses.none(cfg))
    s = single(s, Impulses.none(cfg))
    np.testing.assert_allclose(v[2], np.asarray(s.velocity),
                               rtol=1e-5, atol=1e-5)


def test_smoke_with_vorticity_confinement():
    cfg = SmokeConfig(shape=(16, 16, 16), vorticity_eps=3.0, solver="sor", sor_iters=6)
    fn = make_smoke_step(cfg, donate=False)
    st = init_smoke(cfg)
    for _ in range(10):
        st = fn(st)
    assert np.isfinite(np.asarray(st.velocity)).all()
    assert np.isfinite(np.asarray(st.density)).all()


def test_curl3d_rigid_rotation():
    from esp32_fluid_simulation_tpu.ops.fd import curl3d
    d = h = w = 12
    # v = Omega x r with Omega = (2, 0, 0): v = (0, -2*z2', 2*z1')
    z1 = np.arange(h, dtype=F)[None, :, None] - h / 2
    z2 = np.arange(w, dtype=F)[None, None, :] - w / 2
    v = np.zeros((3, d, h, w), F)
    v[1] = np.broadcast_to(-2 * z2, (d, h, w))
    v[2] = np.broadcast_to(2 * z1, (d, h, w))
    c = np.asarray(curl3d(jnp.asarray(v)))
    np.testing.assert_allclose(c[0][1:-1, 1:-1, 1:-1], 4.0, atol=1e-5)
    np.testing.assert_allclose(c[1][1:-1, 1:-1, 1:-1], 0.0, atol=1e-5)
    np.testing.assert_allclose(c[2][1:-1, 1:-1, 1:-1], 0.0, atol=1e-5)


def test_checked_step_localizes_nan():
    from esp32_fluid_simulation_tpu.utils.debug import make_checked_step
    from esp32_fluid_simulation_tpu import SimState
    cfg = SimConfig(shape=(17, 19))
    fn = make_checked_step(cfg)
    st = init_state(cfg)
    err, out = fn(st, Impulses.none(cfg))
    assert err.get() is None  # clean step -> no error
    bad = SimState(velocity=st.velocity.at[0, 3, 3].set(jnp.nan),
                   color=st.color, step=st.step)
    err2, _ = fn(bad, Impulses.none(cfg))
    assert err2.get() is not None and "nan" in str(err2.get()).lower()


def test_tiled_domain_matches_vmapped_members():
    """domain_tile supergrid (jnp fallback) == independently stepped member
    sims: members must not leak into each other through any stencil."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from esp32_fluid_simulation_tpu import (SimConfig, Impulses, init_state,
                                            make_step)
    from esp32_fluid_simulation_tpu.models.stable_fluids import _to_members

    member = SimConfig(shape=(24, 40), sor_iters=4)
    cfg = dataclasses.replace(member, shape=(48, 80), domain_tile=(24, 40))
    # distinct impulses per member (one global impulse list; positions offset)
    imp = Impulses.from_lists(
        cfg,
        [(10, 12), (10 + 24, 12), (12, 12 + 40), (30, 50)],
        [(90.0, -45.0), (-60.0, 120.0), (50.0, 80.0), (-70.0, -30.0)])

    st = init_state(cfg)
    fn = make_step(cfg, donate=False)
    for t in range(3):
        st = fn(st, imp if t == 0 else Impulses.none(cfg))

    # oracle: each member stepped as its own sim
    fnm = make_step(member, donate=False)
    outs_v, outs_c = [], []
    member_imps = [
        [((10, 12), (90.0, -45.0))],
        [((12, 12), (50.0, 80.0))],
        [((10, 12), (-60.0, 120.0))],
        [((6, 10), (-70.0, -30.0))],
    ]
    st0 = init_state(member)
    for m in range(4):
        s = st0
        mi = Impulses.from_lists(member, [p for p, _ in member_imps[m]],
                                 [v for _, v in member_imps[m]])
        for t in range(3):
            s = fnm(s, mi if t == 0 else Impulses.none(member))
        outs_v.append(s.velocity)
        outs_c.append(s.color)

    got_v = _to_members(st.velocity, 24, 40)
    got_c = _to_members(st.color, 24, 40)
    for m in range(4):
        np.testing.assert_allclose(np.asarray(got_v[m]),
                                   np.asarray(outs_v[m]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(got_c[m]),
                                   np.asarray(outs_c[m]),
                                   rtol=1e-5, atol=1e-5)


def test_tiled_ensemble_helpers():
    """tiled_ensemble_config factorization + member impulse offsetting."""
    from esp32_fluid_simulation_tpu.models.ensemble import (
        tiled_ensemble_config, tiled_member_impulses)
    member = SimConfig(shape=(24, 40), sor_iters=4)
    cfg, gh, gw = tiled_ensemble_config(member, 6)
    assert gh * gw == 6 and cfg.shape == (gh * 24, gw * 40)
    assert cfg.domain_tile == (24, 40)

    imp = tiled_member_impulses(
        cfg, member, gh, gw,
        [([(1, 2)], [(10.0, 20.0)])] + [([], [])] * 5)
    # member 0's (1, 2) stays at (1, 2); only one active slot
    assert int(imp.active.sum()) == 1
    assert tuple(np.asarray(imp.pos[0])) == (1, 2)

    imp2 = tiled_member_impulses(
        cfg, member, gh, gw,
        [([], [])] * 5 + [([(3, 4)], [(1.0, 2.0)])])
    oi, oj = (5 // gw) * 24, (5 % gw) * 40
    assert tuple(np.asarray(imp2.pos[0])) == (oi + 3, oj + 4)


def test_ensemble_auto_tiled_matches_vmap():
    """make_ensemble_step(mode="auto") routes compatible configs to the
    tiled supergrid (VERDICT r2 weak #5); results match the vmapped batch
    (the parity oracle) including per-member impulses."""
    cfg = SimConfig(shape=(32, 32), sor_iters=4, max_impulses=2)
    n = 6
    st = init_ensemble(cfg, n)
    fn_auto = make_ensemble_step(cfg, donate=False)          # auto -> tiled
    fn_vmap = make_ensemble_step(cfg, donate=False, mode="vmap")
    # member 0 writes the SAME cell twice: the later slot must win (the
    # reference's queue-drain overwrite, .ino:264-269)
    imps = [Impulses.from_lists(cfg, [(8 + k, 9), (8 + k, 9) if k == 0
                                      else (20, 4 + k)],
                                [(float(50 + 30 * k), -40.0),
                                 (25.0, float(-60 + 10 * k))])
            for k in range(n)]
    batched = stack_impulses(imps)
    none = stack_impulses([Impulses.none(cfg)] * n)
    sa, sv = st, st
    for t in range(3):
        im = batched if t == 0 else none
        sa = fn_auto(sa, im)
        sv = fn_vmap(sv, im)
    np.testing.assert_allclose(np.asarray(sa.velocity),
                               np.asarray(sv.velocity),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(sa.color, np.float32),
                               np.asarray(sv.color, np.float32),
                               rtol=1e-4, atol=1e-4)
    assert np.asarray(sa.step).shape == (n,)


def test_ensemble_multi_step_matches_stepwise():
    """make_ensemble_multi_step (scan rollout, one layout conversion per
    call) == iterating make_ensemble_step, on both routes."""
    from esp32_fluid_simulation_tpu.models.ensemble import (
        make_ensemble_multi_step)
    from esp32_fluid_simulation_tpu.models.stable_fluids import stack_schedule
    cfg = SimConfig(shape=(32, 32), sor_iters=4, max_impulses=2)
    n = 4
    st = init_ensemble(cfg, n)
    per_step = [stack_impulses(
        [Impulses.from_lists(cfg, [(8 + k + t, 9)], [(40.0, -30.0 + k)])
         for k in range(n)]) for t in range(3)]
    schedule = stack_schedule(per_step)
    for mode in ("auto", "vmap"):
        run = make_ensemble_multi_step(cfg, donate=False, mode=mode)
        out = run(st, schedule)
        ref = st
        sfn = make_ensemble_step(cfg, donate=False, mode=mode)
        for imp in per_step:
            ref = sfn(ref, imp)
        np.testing.assert_allclose(np.asarray(out.velocity),
                                   np.asarray(ref.velocity),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(out.color, np.float32),
                                   np.asarray(ref.color, np.float32),
                                   rtol=1e-5, atol=1e-5)
        assert np.asarray(out.step).shape == (n,)
        assert int(np.asarray(out.step)[0]) == 3


def test_ensemble_mode_tiled_rejects_incompatible():
    import pytest as _pytest
    cfg = SimConfig(shape=(32, 32), vorticity_eps=1.0)
    with _pytest.raises(ValueError, match="not tiled-ensemble compatible"):
        make_ensemble_step(cfg, mode="tiled")
