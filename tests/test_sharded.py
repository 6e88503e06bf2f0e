"""Sharded-vs-single-device parity on an 8-virtual-device CPU mesh
(SURVEY.md §4.3: the standard JAX trick — the identical code then runs on a
real device mesh)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from esp32_fluid_simulation_tpu import SimConfig, Impulses, init_state, make_step
from esp32_fluid_simulation_tpu.parallel import (make_mesh, make_sharded_step,
                                                 sharded_state_sharding)
from esp32_fluid_simulation_tpu.parallel.sharded import make_sharded_render
from esp32_fluid_simulation_tpu.render import render_rgb565

F = np.float32


def _mesh_2x4():
    assert len(jax.devices()) >= 8, "conftest must fake 8 CPU devices"
    return make_mesh(jax.devices()[:8], batch=1, grid_shape=(2, 4))


@pytest.fixture(scope="module")
def cfg():
    # divisible by the (2, 4) mesh; small velocities stay under the CFL clamp
    return SimConfig(shape=(64, 96), sor_iters=10, omega=1.8)


def _kicked_state(cfg, steps=3):
    """Run a few unsharded steps with impulses to get a non-trivial state."""
    fn = make_step(cfg, donate=False)
    st = init_state(cfg)
    for t in range(steps):
        imp = Impulses.from_lists(
            cfg, [(20 + t, 30), (40, 50 - t)], [(90.0, -45.0), (-60.0, 120.0)])
        st = fn(st, imp)
    return st


def test_sharded_step_matches_single_device(cfg):
    mesh = _mesh_2x4()
    st = _kicked_state(cfg)
    imp = Impulses.from_lists(cfg, [(10, 10)], [(50.0, 80.0)])

    single = make_step(cfg, donate=False)(st, imp)

    sh = sharded_state_sharding(cfg, mesh)
    st_sh = jax.device_put(st, sh)
    sharded_fn = make_sharded_step(cfg, mesh, donate=False)
    out = sharded_fn(st_sh, imp)

    np.testing.assert_allclose(np.asarray(out.velocity),
                               np.asarray(single.velocity),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.color),
                               np.asarray(single.color),
                               rtol=1e-5, atol=1e-5)
    assert int(out.step) == int(single.step)


def test_sharded_multi_step_stability(cfg):
    mesh = _mesh_2x4()
    sh = sharded_state_sharding(cfg, mesh)
    st = jax.device_put(init_state(cfg), sh)
    fn = make_sharded_step(cfg, mesh, donate=False)
    none = Impulses.none(cfg)
    imp = Impulses.from_lists(cfg, [(32, 48)], [(200.0, 150.0)])
    for t in range(5):
        st = fn(st, imp if t == 0 else none)
    v = np.asarray(st.velocity)
    assert np.isfinite(v).all()
    assert np.abs(v).max() > 0  # the impulse propagated


def test_sharded_render_matches_single(cfg):
    mesh = _mesh_2x4()
    st = _kicked_state(cfg, steps=2)
    want = np.asarray(render_rgb565(st.color, s=cfg.scaling))
    sh = sharded_state_sharding(cfg, mesh)
    st_sh = jax.device_put(st, sh)
    got = np.asarray(make_sharded_render(cfg, mesh)(st_sh.color))
    assert got.shape == want.shape  # lerp-endpoint crop now done on device
    # bit-identical modulo float lerp order -> compare decoded channels
    assert (got == want).mean() > 0.999


def test_batched_spatial_mesh_runs():
    """batch=2 x spatial 2x2: ensemble member per batch shard, grid sharded
    within — the full (dp x sp) mesh on 8 devices."""
    cfg = SimConfig(shape=(32, 64))
    mesh = make_mesh(jax.devices()[:8], batch=2, grid_shape=(2, 2))
    from jax.sharding import PartitionSpec as P, NamedSharding
    from esp32_fluid_simulation_tpu.parallel.topology import (BATCH_AXIS,
                                                              X_AXIS, Y_AXIS)
    # vmap the single-device step over a stacked ensemble, sharded over batch
    fn = make_step(cfg, donate=False)
    st0 = init_state(cfg)
    batch = jax.tree.map(lambda x: jnp.stack([x, x]), st0)
    imp = Impulses.from_lists(cfg, [(16, 32)], [(100.0, -50.0)])
    imp_b = jax.tree.map(lambda x: jnp.stack([x, x]), imp)
    vfn = jax.jit(jax.vmap(lambda s, i: fn(s, i)))
    spec = NamedSharding(mesh, P(BATCH_AXIS))
    batch = jax.device_put(batch, jax.tree.map(lambda _: spec, st0,
                                               is_leaf=lambda x: x is None))
    out = vfn(batch, imp_b)
    v = np.asarray(out.velocity)
    assert v.shape == (2, 2, 32, 64) and np.isfinite(v).all()
    # both members identical (same inputs)
    np.testing.assert_allclose(v[0], v[1], atol=0)


@pytest.mark.parametrize("sor_halo", [2, 5, 20])
def test_sharded_sor_halo_depths_exact(cfg, sor_halo):
    """Wider SOR halos (fewer collectives, redundant ring compute) must be
    numerically identical to per-half-sweep exchange."""
    mesh = _mesh_2x4()
    st = _kicked_state(cfg, steps=2)
    imp = Impulses.from_lists(cfg, [(10, 10)], [(50.0, 80.0)])
    sh = sharded_state_sharding(cfg, mesh)
    st_sh = jax.device_put(st, sh)
    base = make_sharded_step(cfg, mesh, donate=False, sor_halo=1)(st_sh, imp)
    wide = make_sharded_step(cfg, mesh, donate=False,
                             sor_halo=sor_halo)(st_sh, imp)
    np.testing.assert_allclose(np.asarray(wide.velocity),
                               np.asarray(base.velocity),
                               rtol=2e-6, atol=2e-6)


def test_sharded_vorticity_matches_single_device():
    cfgv = SimConfig(shape=(64, 96), vorticity_eps=3.0)
    mesh = _mesh_2x4()
    fn1 = make_step(cfgv, donate=False)
    st = init_state(cfgv)
    imp = Impulses.from_lists(cfgv, [(32, 48)], [(150.0, -90.0)])
    for t in range(3):
        st = fn1(st, imp if t == 0 else Impulses.none(cfgv))
    st_sh = jax.device_put(init_state(cfgv),
                           sharded_state_sharding(cfgv, mesh))
    fns = make_sharded_step(cfgv, mesh, donate=False)
    for t in range(3):
        st_sh = fns(st_sh, imp if t == 0 else Impulses.none(cfgv))
    np.testing.assert_allclose(np.asarray(st_sh.velocity),
                               np.asarray(st.velocity),
                               rtol=1e-4, atol=1e-4)


def test_sharded_rejects_unsupported_configs():
    # 3D configs dispatch to parallel.sharded3d; what remains unsupported
    # there is the residual-targeted solve (single-device only).
    mesh = _mesh_2x4()
    with pytest.raises(NotImplementedError):
        make_sharded_step(SimConfig(shape=(16, 16, 16),
                                    solver="sor_adaptive"), mesh)


def test_sharded_rk2_matches_single_device():
    # Tolerance note: rk2's second backtrace goes through a *sampled*
    # velocity, so a 1-ulp difference from the shard-window coordinate
    # rebasing (si - ox + k) can flip a floor() cell boundary and move one
    # bilinear stencil by a cell — observed as 1/12288 elements at ~2e-4.
    # That is decomposition-inherent, not a halo bug; bound it loosely.
    cfgr = SimConfig(shape=(64, 96), advector="rk2", sor_iters=4)
    mesh = _mesh_2x4()
    imp = Impulses.from_lists(cfgr, [(32, 48)], [(150.0, -90.0)])
    st = init_state(cfgr)
    fn1 = make_step(cfgr, donate=False)
    for t in range(3):
        st = fn1(st, imp if t == 0 else Impulses.none(cfgr))
    st_sh = jax.device_put(init_state(cfgr),
                           sharded_state_sharding(cfgr, mesh))
    fns = make_sharded_step(cfgr, mesh, donate=False)
    for t in range(3):
        st_sh = fns(st_sh, imp if t == 0 else Impulses.none(cfgr))
    np.testing.assert_allclose(np.asarray(st_sh.velocity),
                               np.asarray(st.velocity),
                               rtol=1e-3, atol=5e-4)
    np.testing.assert_allclose(np.asarray(st_sh.color),
                               np.asarray(st.color),
                               rtol=1e-3, atol=5e-4)


def test_sharded_step_with_metrics_matches_single_device():
    """psum/pmax-reduced observability scalars (SURVEY §5) == the
    single-device step_with_metrics values."""
    from esp32_fluid_simulation_tpu.models.stable_fluids import (
        make_step_with_metrics)
    from esp32_fluid_simulation_tpu.parallel import (
        make_sharded_step_with_metrics)
    cfgm = SimConfig(shape=(64, 96), sor_iters=4)
    mesh = _mesh_2x4()
    imp = Impulses.from_lists(cfgm, [(32, 48)], [(120.0, -60.0)])
    st = init_state(cfgm)
    _, want = make_step_with_metrics(cfgm, donate=False)(st, imp)

    st_sh = jax.device_put(init_state(cfgm),
                           sharded_state_sharding(cfgm, mesh))
    out, got = make_sharded_step_with_metrics(cfgm, mesh, donate=False)(
        st_sh, imp)

    assert bool(got["finite"]) and bool(want["finite"])
    for key in ("div_pre_max", "div_post_max", "poisson_residual_l2",
                "max_speed"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4, atol=1e-5)


def test_sharded_maccormack_matches_single_device():
    cfgm = SimConfig(shape=(64, 96), advector="maccormack")
    mesh = _mesh_2x4()
    imp = Impulses.from_lists(cfgm, [(32, 48)], [(150.0, -90.0)])
    st = init_state(cfgm)
    fn1 = make_step(cfgm, donate=False)
    for t in range(3):
        st = fn1(st, imp if t == 0 else Impulses.none(cfgm))
    st_sh = jax.device_put(init_state(cfgm),
                           sharded_state_sharding(cfgm, mesh))
    fns = make_sharded_step(cfgm, mesh, donate=False)
    for t in range(3):
        st_sh = fns(st_sh, imp if t == 0 else Impulses.none(cfgm))
    np.testing.assert_allclose(np.asarray(st_sh.velocity),
                               np.asarray(st.velocity),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(st_sh.color),
                               np.asarray(st.color),
                               rtol=1e-4, atol=1e-4)


def test_sharded_jacobi_matches_single_device():
    cfgj = SimConfig(shape=(64, 96), solver="jacobi", sor_iters=20,
                     omega=0.9)
    mesh = _mesh_2x4()
    imp = Impulses.from_lists(cfgj, [(32, 48)], [(150.0, -90.0)])
    st = make_step(cfgj, donate=False)(init_state(cfgj), imp)
    st_sh = jax.device_put(init_state(cfgj),
                           sharded_state_sharding(cfgj, mesh))
    out = make_sharded_step(cfgj, mesh, donate=False, sor_halo=4)(st_sh, imp)
    np.testing.assert_allclose(np.asarray(out.velocity),
                               np.asarray(st.velocity),
                               rtol=1e-5, atol=1e-5)


def test_sharded_multigrid_matches_single_device():
    cfgm = SimConfig(shape=(64, 96), solver="multigrid", mg_cycles=2)
    mesh = _mesh_2x4()
    imp = Impulses.from_lists(cfgm, [(32, 48)], [(150.0, -90.0)])
    st = init_state(cfgm)
    fn1 = make_step(cfgm, donate=False)
    for t in range(3):
        st = fn1(st, imp if t == 0 else Impulses.none(cfgm))
    st_sh = jax.device_put(init_state(cfgm),
                           sharded_state_sharding(cfgm, mesh))
    fns = make_sharded_step(cfgm, mesh, donate=False)
    for t in range(3):
        st_sh = fns(st_sh, imp if t == 0 else Impulses.none(cfgm))
    np.testing.assert_allclose(np.asarray(st_sh.velocity),
                               np.asarray(st.velocity),
                               rtol=1e-4, atol=1e-4)
