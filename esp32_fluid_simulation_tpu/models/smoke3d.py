"""3D smoke plume model (BASELINE config 5's 256^3 workload).

A second model family on the same op stack: the reference's dye-bed loop
(``.ino:249-289``) generalized to 3D with the standard smoke extensions
(Fedkiw et al. 2001) the 2D dye sim has no need for:

* scalar smoke density + temperature fields advected through the flow,
* buoyancy force along the vertical axis (axis 0):
  ``f = (alpha*T - beta*rho) * z_hat``,
* a source region that continuously injects density/temperature (the plume),
* optional per-step dissipation.

All spatial ops are the rank-polymorphic ops from ``ops/`` (advect,
divergence, SOR/multigrid projection, gradient subtract) running in 3D.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import reject_removed_fields
from ..ops.advect import advect
from ..ops.fd import divergence, subtract_gradient
from ..ops.poisson import sor_solve
from ..ops.multigrid import multigrid_solve


# Fields that once selected a hand-written 3D kernel (see
# ``config.REMOVED_FIELDS``): refused with the replacement spelled out.
REMOVED_SMOKE_FIELDS = {
    "advect_impl": "drop it: advection always runs the XLA-compiled op",
    "advect_max_disp": "drop it: the single-device advection has no CFL "
                       "clamp (the sharded step takes max_disp as an "
                       "argument of make_sharded_smoke_step)",
    "sor_impl": "drop it: solver='sor' always runs the XLA-compiled "
                "red-black SOR",
    "sor_chunk": "drop it: the XLA-compiled SOR has no launch chunks",
}


@dataclasses.dataclass(frozen=True)
class SmokeConfig:
    shape: Tuple[int, int, int] = (64, 64, 64)  # (D=vertical, H, W)
    dt: float = 1.0 / 30.0
    dx: float = 1.0
    # Default RB-SOR, like the reference (its ONE solver, poisson.cpp:14-61);
    # multigrid is the config-3-style opt-in and the sharded coarse-ladder
    # option.
    solver: str = "sor"            # sor | multigrid
    sor_iters: int = 10
    omega: float = 1.5
    mg_cycles: int = 1
    buoyancy_alpha: float = 8.0    # thermal lift
    buoyancy_beta: float = 2.0     # smoke weight
    dissipation: float = 0.0       # per-step scalar decay
    vorticity_eps: float = 0.0     # 3D vorticity confinement strength
    source_center: Tuple[float, float, float] = (0.9, 0.5, 0.5)  # fractional
    source_radius: float = 0.08    # fractional
    source_density: float = 1.0
    source_temperature: float = 1.0
    dtype: str = "float32"
    # Storage dtype for the advected scalars (density + temperature) only;
    # velocity and pressure always run in ``dtype``.  Default "bfloat16"
    # mirrors the reference's own reduced-precision dye storage (UQ32 fixed
    # point, uq32.h): the smoke scalars are render-bound quantities, and
    # bf16 halves their gather and HBM traffic.  The f32-vs-bf16 plume A/B
    # is pinned in tests/test_models_extra.py::test_smoke_bf16_scalars
    # (total smoke mass within a few percent after 25 steps).
    scalar_dtype: str = "bfloat16"

    def __new__(cls, *args, **kwargs):
        reject_removed_fields(kwargs, REMOVED_SMOKE_FIELDS)
        return super().__new__(cls)

    @property
    def jdtype(self):
        return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[self.dtype]

    @property
    def sdtype(self):
        return {"float32": jnp.float32,
                "bfloat16": jnp.bfloat16}[self.scalar_dtype]


class SmokeState(NamedTuple):
    velocity: jax.Array     # [3, D, H, W]
    density: jax.Array      # [D, H, W]
    temperature: jax.Array  # [D, H, W]
    step: jax.Array


def _source_mask(cfg: SmokeConfig) -> np.ndarray:
    """Spherical plume source near the bottom (axis-0 high side = ground)."""
    d, h, w = cfg.shape
    ci = np.array(cfg.source_center) * np.array([d, h, w])
    rad = cfg.source_radius * min(cfg.shape)
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing="ij")
    dist2 = ((zz - ci[0]) ** 2 + (yy - ci[1]) ** 2 + (xx - ci[2]) ** 2)
    return (dist2 <= rad * rad).astype(np.float32)


def init_smoke(cfg: SmokeConfig) -> SmokeState:
    # density and temperature must be distinct buffers: a shared zeros array
    # would alias under jit donation ("donate the same buffer twice").
    return SmokeState(
        velocity=jnp.zeros((3,) + cfg.shape, cfg.jdtype),
        density=jnp.zeros(cfg.shape, cfg.sdtype),
        temperature=jnp.zeros(cfg.shape, cfg.sdtype),
        step=jnp.zeros((), jnp.int32),
    )


def smoke_step(state: SmokeState, cfg: SmokeConfig) -> SmokeState:
    dt = cfg.dt
    vel, rho, temp = state.velocity, state.density, state.temperature

    # 1. advect everything through the current flow
    vel = advect(vel, vel, dt, no_slip=True)
    rho = advect(rho, vel, dt, no_slip=False)
    temp = advect(temp, vel, dt, no_slip=False)

    # 2. inject the plume source
    src = jnp.asarray(_source_mask(cfg), cfg.sdtype)
    rho = jnp.minimum(rho + dt * cfg.source_density * src, 1.0)
    temp = temp + dt * cfg.source_temperature * src

    # 3. buoyancy along -axis0 (low indices = up): hot+light rises.  The
    # force accumulates into f32 velocity, so compute it in f32 even when
    # the scalars are stored bf16 (same HBM traffic, full accuracy).
    buoy = (cfg.buoyancy_alpha * temp.astype(cfg.jdtype)
            - cfg.buoyancy_beta * rho.astype(cfg.jdtype)) * dt
    vel = vel.at[0].add(-buoy)
    if cfg.vorticity_eps > 0:
        from ..ops.fd import vorticity_confinement
        vel = vorticity_confinement(vel, cfg.vorticity_eps, dt, cfg.dx)

    # 4. pressure projection (same Neumann system as 2D, in 3D)
    div = divergence(vel, cfg.dx)
    if cfg.solver == "multigrid":
        p = multigrid_solve(div, cfg.dx, cycles=cfg.mg_cycles)
    else:
        p = sor_solve(div, cfg.dx, cfg.sor_iters, cfg.omega)
    vel = subtract_gradient(vel, p, cfg.dx)

    # 5. optional dissipation
    if cfg.dissipation > 0:
        decay = 1.0 - cfg.dissipation * dt
        rho = rho * decay
        temp = temp * decay

    return SmokeState(velocity=vel, density=rho, temperature=temp,
                      step=state.step + 1)


def make_smoke_step(cfg: SmokeConfig, donate: bool = True):
    fn = functools.partial(smoke_step, cfg=cfg)
    return jax.jit(fn, donate_argnums=(0,) if donate else ())
