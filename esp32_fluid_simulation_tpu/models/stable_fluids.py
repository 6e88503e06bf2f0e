"""The flagship model: Stam-style stable-fluids dye bed as one jitted step.

The whole body of the reference's ``loop()`` between its I/O endpoints
(``.ino:249-289``) is pure array math; here it becomes exactly one
``@jax.jit`` pure function ``step(state, impulses) -> state``:

  1. self-advect velocity (``.ino:251-256``, no-slip sampling),
  2. apply the drained drag queue as masked scatter writes (``.ino:258-269``),
  3. pressure projection: divergence -> RB-SOR -> gradient subtract
     (``.ino:271-278``),
  4. advect dye (``.ino:280-282``).

The reference's per-frame heap churn and double-buffer ``SWAP`` vanish: XLA
buffer donation reuses the state buffers in place.  ``init_state`` matches
``setup()`` (``.ino:194-246``): zero velocity, angular RGB sectors, two
sequential in-place triangular blurs.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SimConfig
from ..state import SimState, Impulses
from ..ops.advect import advect, advect_maccormack, advect_rk2
from ..ops.fd import divergence, subtract_gradient, vorticity_confinement
from ..ops.poisson import poisson_solve, poisson_residual
from ..ops.blur import triangular_blur_inplace


def init_color(cfg: SimConfig) -> jax.Array:
    """Angular RGB sectors around the grid center, then two in-place
    [1/4,1/2,1/4] blurs (``.ino:203-241``).  Colors are unit-scale floats
    (the reference's UQ32 fixed point maps uint32 onto [0,1), ``uq32.h``).

    In tiled-domain mode every member tile gets its own (identical) sector
    init — the member pattern is built and blurred once, then tiled, so the
    blur never smears across member boundaries."""
    if cfg.domain_tile is not None:
        import dataclasses
        mh, mw = cfg.domain_tile
        member_cfg = dataclasses.replace(cfg, shape=(mh, mw),
                                         domain_tile=None, solver="sor")
        member = init_color(member_cfg)
        gh = cfg.shape[0] // mh
        gw = cfg.shape[1] // mw
        return jnp.tile(member, (1, gh, gw))
    h, w = cfg.shape[-2], cfg.shape[-1]
    ci, cj = h // 2, w // 2
    ii = np.arange(h, dtype=np.float32)[:, None]
    jj = np.arange(w, dtype=np.float32)[None, :]
    # ``ci - ii`` (not ``-(ii - ci)``): the reference negates an *integer*
    # zero at the center row (.ino:210), yielding +0.0 and atan2 = +pi on the
    # left half; float ``-(ii-ci)`` would give -0.0 and -pi there.
    angle = np.arctan2(ci - ii, jj - cj)
    red = angle < -np.pi / 3
    green = (angle >= -np.pi / 3) & (angle < np.pi / 3)
    blue = ~(red | green)
    color = np.stack([red, green, blue]).astype(np.float32)  # [3, H, W]
    if cfg.ndim == 3:
        color = np.broadcast_to(color[:, None], (3,) + cfg.shape).copy()
    c = jnp.asarray(color, cfg.jcolor_dtype)
    # Horizontal (j) pass then vertical (i) pass, both sequential in-place
    # recurrences (.ino:220-241).
    c = triangular_blur_inplace(c, axis=c.ndim - 1)
    c = triangular_blur_inplace(c, axis=c.ndim - 2)
    return c


def init_state(cfg: SimConfig) -> SimState:
    """Zero velocity + sector dye; matches ``setup()`` (``.ino:194-241``)."""
    vel = jnp.zeros((cfg.ndim,) + cfg.shape, cfg.jdtype)
    return SimState(velocity=vel, color=init_color(cfg),
                    step=jnp.zeros((), jnp.int32))


def apply_impulses(vel: jax.Array, imp: Impulses) -> jax.Array:
    """Write drag velocities directly into cells (``.ino:264-269``).

    ONE scatter for all slots.  Draining the FreeRTOS queue in order means
    the LAST active slot wins at a duplicated cell; that overwrite order is
    resolved up front in slot space (k^2 tiny vector ops, k=16) and
    superseded/inactive slots are routed out of bounds on axis 0 and
    dropped by the ``mode="drop"`` scatter (a per-slot ``.at[].set`` loop
    would cost 2k full-grid passes).  Indices are clamped to the grid, like
    the reference's calibration map.
    """
    shape = vel.shape[1:]
    nd = len(shape)
    k = imp.pos.shape[0]
    idx = tuple(jnp.clip(imp.pos[:, a], 0, shape[a] - 1) for a in range(nd))
    act = imp.active
    same = idx[0][:, None] == idx[0][None, :]
    for ax in range(1, nd):
        same &= idx[ax][:, None] == idx[ax][None, :]
    later = jnp.triu(jnp.ones((k, k), jnp.bool_), 1)      # s' > s
    superseded = jnp.any(same & later & act[None, :], axis=1)
    rows = jnp.where(act & ~superseded, idx[0], shape[0])  # OOB -> dropped
    return vel.at[(slice(None), rows) + idx[1:]].set(
        imp.velocity.T.astype(vel.dtype), mode="drop")


def _advect_by(cfg: SimConfig):
    if cfg.advector == "maccormack":
        return advect_maccormack
    if cfg.advector == "rk2":
        return advect_rk2
    return advect


def _to_members(x: jax.Array, mh: int, mw: int) -> jax.Array:
    """[C, gh*mh, gw*mw] -> [gh*gw, C, mh, mw] (tiled-domain <-> batch)."""
    c, H, W = x.shape
    gh, gw = H // mh, W // mw
    return (x.reshape(c, gh, mh, gw, mw)
            .transpose(1, 3, 0, 2, 4).reshape(gh * gw, c, mh, mw))


def _from_members(x: jax.Array, H: int, W: int) -> jax.Array:
    n, c, mh, mw = x.shape
    gh, gw = H // mh, W // mw
    return (x.reshape(gh, gw, c, mh, mw)
            .transpose(2, 0, 3, 1, 4).reshape(c, H, W))


def _step_tiled(state: SimState, impulses: Impulses,
                cfg: SimConfig, apply_fn=None):
    """Tiled-domain step (BASELINE config 4 as one grid): one supergrid of
    independent member domains, each member's ops vmapped over the
    reshaped batch so every boundary condition acts per (mh, mw) tile.

    ``apply_fn(vel) -> vel`` overrides the impulse application (the
    auto-tiled ensemble path injects per-member batched impulses there)."""
    from ..ops.poisson import sor_solve, jacobi_solve

    mh, mw = cfg.domain_tile
    H, W = cfg.shape
    if apply_fn is None:
        apply_fn = lambda v: apply_impulses(v, impulses)  # noqa: E731

    def project_m(v):
        d = divergence(v, cfg.dx)
        if cfg.solver == "jacobi":
            p = jacobi_solve(d, cfg.dx, cfg.sor_iters, min(cfg.omega, 1.0))
        else:
            p = sor_solve(d, cfg.dx, cfg.sor_iters, cfg.omega)
        return subtract_gradient(v, p, cfg.dx)

    vel_m = _to_members(state.velocity, mh, mw)
    vel_m = jax.vmap(lambda v: advect(v, v, cfg.dt, no_slip=True))(vel_m)
    vel = _from_members(vel_m, H, W)
    vel = apply_fn(vel)
    vel_m = jax.vmap(project_m)(_to_members(vel, mh, mw))
    col_m = jax.vmap(lambda f, v: advect(f, v, cfg.dt, no_slip=False))(
        _to_members(state.color, mh, mw), vel_m)
    vel = _from_members(vel_m, H, W)
    color = jnp.clip(_from_members(col_m, H, W), 0.0, 1.0)
    return SimState(velocity=vel, color=color, step=state.step + 1)


def step(state: SimState, impulses: Impulses, cfg: SimConfig) -> SimState:
    """One simulation step — the pure-functional ``loop()`` (``.ino:249-289``)."""
    if cfg.domain_tile is not None:
        return _step_tiled(state, impulses, cfg)
    adv = _advect_by(cfg)

    vel = adv(state.velocity, state.velocity, cfg.dt, no_slip=True)
    vel = apply_impulses(vel, impulses)
    if cfg.vorticity_eps > 0.0:  # rank-polymorphic (2D curl or 3D, ops.fd)
        vel = vorticity_confinement(vel, cfg.vorticity_eps, cfg.dt, cfg.dx)

    vel = _project(vel, cfg)

    color = adv(state.color, vel, cfg.dt, no_slip=False)
    if cfg.clamps_dye:
        color = jnp.clip(color, 0.0, 1.0)
    return SimState(velocity=vel, color=color, step=state.step + 1)


def _project(vel: jax.Array, cfg: SimConfig) -> jax.Array:
    """Pressure projection (``.ino:271-278``): divergence -> Poisson solve
    -> gradient subtract."""
    div = divergence(vel, cfg.dx)
    p = poisson_solve(div, cfg)
    return subtract_gradient(vel, p, cfg.dx)


def step_render(state: SimState, impulses: Impulses, cfg: SimConfig,
                bswap: bool = True):
    """One step plus the on-device RGB565 frame, in ONE program.

    This is the serving shape of the reference's sim+draw pipeline
    (``loop()`` + ``draw_routine``'s pack, ``.ino:249-289,164-176``): only
    final packed pixels leave the device.  The render composes after the
    step in the same jitted program, so XLA fuses the upscale and pack into
    one loop that writes uint16 pixels.
    """
    from ..render import render_rgb565

    st = step(state, impulses, cfg)
    return st, render_rgb565(st.color, s=cfg.scaling, bswap=bswap)


def make_step_render(cfg: SimConfig, bswap: bool = True,
                     donate: bool = True):
    """Jitted ``(state, impulses) -> (state, rgb565_frame)`` — see
    :func:`step_render`."""
    fn = functools.partial(step_render, cfg=cfg, bswap=bswap)
    return jax.jit(fn, donate_argnums=(0,) if donate else ())


def step_with_metrics(state: SimState, impulses: Impulses, cfg: SimConfig):
    """Step plus on-device observability (SURVEY §5 metrics subsystem):
    pre/post-projection divergence extrema, Poisson residual norm, max |v|.
    All reductions stay on device; fetch lazily."""
    adv = _advect_by(cfg)

    vel = adv(state.velocity, state.velocity, cfg.dt, no_slip=True)
    vel = apply_impulses(vel, impulses)
    if cfg.vorticity_eps > 0.0:  # rank-polymorphic (2D curl or 3D, ops.fd)
        vel = vorticity_confinement(vel, cfg.vorticity_eps, cfg.dt, cfg.dx)

    div = divergence(vel, cfg.dx)
    p = poisson_solve(div, cfg)
    vel = subtract_gradient(vel, p, cfg.dx)
    div_post = divergence(vel, cfg.dx)

    color = adv(state.color, vel, cfg.dt, no_slip=False)
    color = jnp.clip(color, 0.0, 1.0) if cfg.clamps_dye else color

    res = poisson_residual(p, div, cfg.dx)
    metrics = {
        "div_pre_max": jnp.max(jnp.abs(div)),
        "div_post_max": jnp.max(jnp.abs(div_post)),
        "poisson_residual_l2": jnp.sqrt(jnp.mean(res * res)),
        "max_speed": jnp.sqrt(jnp.max(jnp.sum(vel * vel, axis=0))),
        "finite": jnp.all(jnp.isfinite(vel)) & jnp.all(jnp.isfinite(color)),
    }
    new_state = SimState(velocity=vel, color=color, step=state.step + 1)
    return new_state, metrics


def make_step(cfg: SimConfig, donate: bool = True):
    """Jitted step specialized to ``cfg`` with state-buffer donation (the
    replacement for the reference's SWAP double buffering)."""
    fn = functools.partial(step, cfg=cfg)
    return jax.jit(fn, donate_argnums=(0,) if donate else ())


def make_step_with_metrics(cfg: SimConfig, donate: bool = True):
    fn = functools.partial(step_with_metrics, cfg=cfg)
    return jax.jit(fn, donate_argnums=(0,) if donate else ())


def make_multi_step(cfg: SimConfig, donate: bool = True):
    """scan-compiled multi-step runner: ``run(state, schedule) -> state``
    advances the sim by ``n`` steps in ONE device program, where
    ``schedule`` is an ``Impulses`` pytree with a leading ``[n]`` axis (the
    whole drag schedule uploaded once).  On small grids this removes the
    per-step host dispatch + impulse upload that otherwise dominates (the
    61x81 reference workload is launch-latency-bound); it is also the
    serving shape for batch rollouts."""
    def run(state: SimState, schedule: Impulses) -> SimState:
        out, _ = jax.lax.scan(
            lambda st, imp: (step(st, imp, cfg), None), state, schedule)
        return out

    return jax.jit(run, donate_argnums=(0,) if donate else ())


def stack_schedule(imps) -> Impulses:
    """[Impulses, ...] (one per step) -> scan schedule with leading [n]."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *imps)
