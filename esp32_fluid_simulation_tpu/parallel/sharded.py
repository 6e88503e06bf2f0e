"""The sharded simulation step: the whole of ``loop()`` (``.ino:249-289``)
under ``shard_map`` over a ``(batch, x, y)`` device mesh.

Every field is partitioned over the trailing two spatial axes; each stencil
pass exchanges exactly the strips it needs over the device interconnect
(``parallel.halo``), and the boundary conditions apply only on the shards
that own a global edge — the distributed rendition of the reference's interior-fast /
boundary-safe dispatch (``operations.h:11-38``).  Collective budget per step:

* advection: one ``max_disp+1``-wide exchange per axis per advected field
  (MacCormack adds the backward pass);
* projection: SOR exchanges a ``sor_halo``-wide strip once per ``sor_halo``
  half-sweeps (trapezoidal validity — red-black semantics preserved
  exactly); Jacobi once per ``sor_halo`` iterations; multigrid smooths with
  1-wide exchanges per level and all-gathers the tiny replicated coarse
  ladder once per V-cycle;
* divergence/gradient/vorticity: 1-wide exchanges, each velocity component
  only along its own difference axis.

Numerically identical (up to float reassociation) to the single-device step:
``tests/test_sharded.py`` pins sharded == unsharded on an 8-virtual-device
CPU mesh (SURVEY.md §4.3).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding
from jax import shard_map

from ..config import SimConfig
from ..state import SimState, Impulses
from ..ops.advect import sample_linear, noslip_axis_factor
from ..ops.poisson import _neg_inv_diag  # noqa: F401  (single-dev variant)
from .halo import exchange_halo
from .topology import BATCH_AXIS, X_AXIS, Y_AXIS


def sharded_state_sharding(cfg: SimConfig, mesh: Mesh, batched: bool = False):
    """NamedShardings for a SimState on ``mesh``."""
    lead = (BATCH_AXIS,) if batched else ()
    # 3D states carry a local vertical axis between channels and the
    # sharded horizontal axes: [C, (D,) H, W]
    grid = P(*lead, None, *((None,) * (cfg.ndim - 2)), X_AXIS, Y_AXIS)
    return SimState(
        velocity=NamedSharding(mesh, grid),
        color=NamedSharding(mesh, grid),
        step=NamedSharding(mesh, P()),
    )


def _local_coords(cfg, nx, ny, lh, lw):
    """Global (i, j) coordinate arrays for this shard's block."""
    ox = lax.axis_index(X_AXIS) * lh
    oy = lax.axis_index(Y_AXIS) * lw
    ii = jax.lax.broadcasted_iota(jnp.int32, (lh, lw), 0) + ox
    jj = jax.lax.broadcasted_iota(jnp.int32, (lh, lw), 1) + oy
    return ii, jj, ox, oy


def _exchange2(x, width, nx, ny, bcs=("zero", "zero")):
    x = exchange_halo(x, width, -2, X_AXIS, nx, bcs[0])
    x = exchange_halo(x, width, -1, Y_AXIS, ny, bcs[1])
    return x


def make_sharded_step(cfg: SimConfig, mesh: Mesh, max_disp: int = 12,
                      donate: bool = True, sor_halo: int = 1,
                      with_metrics: bool = False):
    """Build a jitted sharded ``step(state, impulses) -> state``.

    ``max_disp``: advection CFL clamp in cells — sets the halo width, so it
    bounds interconnect traffic as well as the backtrace.
    ``sor_halo``: pressure-halo depth; k trades k-ring redundant compute for
    ~k-fold fewer SOR collectives (see ``sor_local``).
    ``with_metrics``: return ``(state, metrics)`` with mesh-reduced
    observability scalars (see ``make_sharded_step_with_metrics``).
    """
    halo_k = sor_halo
    if cfg.ndim == 3:
        # vertical axis local, horizontal axes sharded — the smoke model's
        # decomposition for the dye-bed physics (VERDICT r4 next #7)
        from .sharded3d import make_sharded_step_3d
        return make_sharded_step_3d(cfg, mesh, max_disp=max_disp,
                                    donate=donate, sor_halo=sor_halo,
                                    with_metrics=with_metrics)
    if cfg.domain_tile is not None:
        # Running a tiled-domain config as a plain single-domain sharded
        # step would silently drop every member-wall boundary condition
        # (wrong physics, no error) — refuse instead.  The sharded tiled
        # supergrid lives in make_sharded_tiled_step.
        raise NotImplementedError(
            "make_sharded_step does not run domain_tile configs; use "
            "parallel.sharded_tiled.make_sharded_tiled_step (shards own "
            "whole member tiles) or a single device")
    if cfg.advector not in ("semilag", "maccormack", "rk2"):
        raise NotImplementedError(
            f"sharded step supports advector='semilag'/'maccormack'/'rk2', "
            f"got {cfg.advector!r} (silently substituting would change "
            f"physics vs the single-device run)")
    if cfg.solver not in ("sor", "jacobi", "multigrid"):
        raise NotImplementedError(
            f"sharded step supports solver='sor'/'jacobi'/'multigrid', "
            f"got {cfg.solver!r}")
    H, W = cfg.shape
    nx = mesh.shape[X_AXIS]
    ny = mesh.shape[Y_AXIS]
    if H % nx or W % ny:
        raise ValueError(f"grid {cfg.shape} not divisible by mesh ({nx},{ny})")
    lh, lw = H // nx, W // ny
    k = max_disp + 1
    dt, dx = cfg.dt, cfg.dx
    f32 = jnp.float32

    def advect_local(field, vel, ii, jj, ox, oy, no_slip, sign=1.0,
                     return_minmax=False):
        """Backtrace + gather in a k-halo window; global-coordinate clamps."""
        fpad = _exchange2(field, k, nx, ny)
        v0 = vel[0].astype(f32)
        v1 = vel[1].astype(f32)
        gi = ii.astype(f32)
        gj = jj.astype(f32)
        si_raw = gi - sign * v0 * f32(dt)
        sj_raw = gj - sign * v1 * f32(dt)
        # CFL clamp to the halo, then the reference domain clamp
        si = jnp.clip(jnp.clip(si_raw, gi - max_disp, gi + max_disp),
                      0.0, f32(H - 1))
        sj = jnp.clip(jnp.clip(sj_raw, gj - max_disp, gj + max_disp),
                      0.0, f32(W - 1))
        # local window coords: window row 0 == global row (offset - k), so a
        # global coordinate g maps to g - offset + k
        li = si - ox.astype(f32) + f32(k)
        lj = sj - oy.astype(f32) + f32(k)
        res = sample_linear(fpad, (li, lj), no_slip=False,
                            return_minmax=return_minmax)
        out, extra = (res[0], res[1:]) if return_minmax else (res, ())
        if no_slip:
            out = out * (noslip_axis_factor(si_raw, H)
                         * noslip_axis_factor(sj_raw, W)).astype(out.dtype)
        return (out, *extra) if return_minmax else out

    def rk2_local(field, vel, ii, jj, ox, oy, no_slip):
        """Midpoint backtrace (ops.advect.advect_rk2, shard-local): sample
        the velocity at x - dt/2·v(x) from a k-halo window, then trace the
        full step through it.  Both stages CFL-clamp to the halo."""
        gi = ii.astype(f32)
        gj = jj.astype(f32)
        v0 = vel[0].astype(f32)
        v1 = vel[1].astype(f32)
        vpad = _exchange2(vel, k, nx, ny)

        def window_coords(ci_raw, cj_raw):
            ci = jnp.clip(jnp.clip(ci_raw, gi - max_disp, gi + max_disp),
                          0.0, f32(H - 1))
            cj = jnp.clip(jnp.clip(cj_raw, gj - max_disp, gj + max_disp),
                          0.0, f32(W - 1))
            return (ci - ox.astype(f32) + f32(k),
                    cj - oy.astype(f32) + f32(k))

        v_mid = sample_linear(
            vpad, window_coords(gi - 0.5 * dt * v0, gj - 0.5 * dt * v1))
        si_raw = gi - v_mid[0].astype(f32) * f32(dt)
        sj_raw = gj - v_mid[1].astype(f32) * f32(dt)
        fpad = _exchange2(field, k, nx, ny)
        out = sample_linear(fpad, window_coords(si_raw, sj_raw))
        if no_slip:
            out = out * (noslip_axis_factor(si_raw, H)
                         * noslip_axis_factor(sj_raw, W)).astype(out.dtype)
        return out

    def advect_dispatch(field, vel, ii, jj, ox, oy, no_slip):
        if cfg.advector == "rk2":
            return rk2_local(field, vel, ii, jj, ox, oy, no_slip)
        if cfg.advector != "maccormack":
            return advect_local(field, vel, ii, jj, ox, oy, no_slip)
        # MacCormack (ops.advect.advect_maccormack, shard-local): forward
        # predictor with stencil extrema, backward corrector, clamp bounds
        # extended to the (possibly no-slip-discounted) predictor.
        phi_hat, cmin, cmax = advect_local(field, vel, ii, jj, ox, oy,
                                           no_slip, return_minmax=True)
        phi_back = advect_local(phi_hat, vel, ii, jj, ox, oy, no_slip,
                                sign=-1.0)
        corrected = phi_hat + 0.5 * (field - phi_back)
        cmin = jnp.minimum(cmin, phi_hat)
        cmax = jnp.maximum(cmax, phi_hat)
        return jnp.clip(corrected, cmin, cmax)

    def divergence_local(vel):
        # each component only needs ghosts along its own difference axis
        vx = exchange_halo(vel[0], 1, -2, X_AXIS, nx, "reflect_neg")
        vy = exchange_halo(vel[1], 1, -1, Y_AXIS, ny, "reflect_neg")
        inv = jnp.asarray(1.0 / (2.0 * dx), vel.dtype)
        return ((vx[2:, :] - vx[:-2, :]) + (vy[:, 2:] - vy[:, :-2])) * inv

    def vorticity_local(vel):
        """Fedkiw confinement with edge-clamped halos (matches
        ops.fd.vorticity_confinement on the global grid)."""
        inv = jnp.asarray(1.0 / (2.0 * dx), vel.dtype)
        tiny = jnp.asarray(1e-6, vel.dtype)
        vx = exchange_halo(vel[0], 1, -1, Y_AXIS, ny, "edge")
        vy = exchange_halo(vel[1], 1, -2, X_AXIS, nx, "edge")
        w = ((vy[2:, :] - vy[:-2, :]) - (vx[:, 2:] - vx[:, :-2])) * inv
        aw = jnp.abs(w)
        aw_x = exchange_halo(aw, 1, -2, X_AXIS, nx, "edge")
        aw_y = exchange_halo(aw, 1, -1, Y_AXIS, ny, "edge")
        g0 = (aw_x[2:, :] - aw_x[:-2, :]) * inv
        g1 = (aw_y[:, 2:] - aw_y[:, :-2]) * inv
        mag = jnp.sqrt(g0 * g0 + g1 * g1) + tiny
        f = jnp.stack([(g1 / mag) * w, -(g0 / mag) * w], axis=0)
        return vel + (cfg.vorticity_eps * dx * dt) * f

    def gradient_sub_local(vel, p):
        ppad = _exchange2(p, 1, nx, ny, ("edge", "edge"))
        inv = jnp.asarray(1.0 / (2.0 * dx), vel.dtype)
        gx = (ppad[2:, 1:-1] - ppad[:-2, 1:-1]) * inv
        gy = (ppad[1:-1, 2:] - ppad[1:-1, :-2]) * inv
        return vel - jnp.stack([gx, gy], axis=0)

    def sor_local(d, ii, jj):
        """Red-black SOR over the mesh with a tunable halo depth.

        ``sor_halo = 1`` exchanges a 1-wide strip before every half-sweep
        (minimum traffic, maximum collective count).  ``sor_halo = k``
        exchanges a k-wide strip once per k half-sweeps and runs those
        half-sweeps on the extended block — each half-sweep invalidates one
        ring, so the owned block stays exact (trapezoidal tiling).
        Collectives per solve
        drop from ``2*iters`` to ``ceil(2*iters/k) (+1 for d's halo``).
        Global parity and the Neumann diagonal follow poisson.cpp:10-12,
        67-89.
        """
        k = max(1, min(halo_k, 2 * cfg.sor_iters))
        lut = jnp.asarray(
            (-1.0 / np.arange(1, 5, dtype=np.float64)).astype(np.float32),
            d.dtype)

        def stencil_consts(gi, gj):
            a = (4 - (gi == 0).astype(jnp.int32)
                 - (gi == H - 1).astype(jnp.int32)
                 - (gj == 0).astype(jnp.int32)
                 - (gj == W - 1).astype(jnp.int32))
            in_dom = (gi >= 0) & (gi < H) & (gj >= 0) & (gj < W)
            return (gi + gj) % 2, lut[a - 1], in_dom

        w = jnp.asarray(cfg.omega, d.dtype)
        one_m_w = jnp.asarray(1.0 - cfg.omega, d.dtype)

        # padded-block coords (block (0,0) is global (ox-k, oy-k))
        gi = (jax.lax.broadcasted_iota(jnp.int32, (lh + 2 * k, lw + 2 * k), 0)
              + (ii[0, 0] - k))
        gj = (jax.lax.broadcasted_iota(jnp.int32, (lh + 2 * k, lw + 2 * k), 1)
              + (jj[0, 0] - k))
        parity, neg_inv, in_dom = stencil_consts(gi, gj)
        dxd = jnp.asarray(dx, d.dtype) * _exchange2(d, k, nx, ny)
        dxd = jnp.where(in_dom, dxd, 0.0)

        zrow = jnp.zeros((1, lw + 2 * k), d.dtype)
        zcol = jnp.zeros((lh + 2 * k, 1), d.dtype)

        if cfg.solver == "jacobi":
            w = jnp.asarray(min(cfg.omega, 1.0), d.dtype)
            one_m_w = jnp.asarray(1.0 - min(cfg.omega, 1.0), d.dtype)

        def halves(pp, start, count):
            for m in range(count):
                nb = ((jnp.concatenate([zrow, pp[:-1]], 0)
                       + jnp.concatenate([pp[1:], zrow], 0))
                      + jnp.concatenate([zcol, pp[:, :-1]], 1)) \
                    + jnp.concatenate([pp[:, 1:], zcol], 1)
                p_new = one_m_w * pp + w * (neg_inv * (dxd - nb))
                if cfg.solver == "jacobi":
                    mask = in_dom
                else:
                    mask = (parity == (start + m) % 2) & in_dom
                pp = jnp.where(mask, p_new, jnp.where(in_dom, pp, 0.0))
            return pp

        # jacobi: one full update per iteration; sor: two half-sweeps
        total = cfg.sor_iters if cfg.solver == "jacobi" else 2 * cfg.sor_iters
        p = jnp.zeros_like(d)
        done = 0
        while done < total:
            n_here = min(k, total - done)
            pp = _exchange2(p, k, nx, ny)
            p = halves(pp, done, n_here)[k:-k, k:-k]
            done += n_here
        return p

    def mg_local(d, ii, jj):
        """Sharded geometric multigrid (solver='multigrid').

        Hybrid ladder: levels stay sharded while every shard's block halves
        cleanly (even, >= 8 per side); below that the level is all-gathered
        and the remaining V-cycle runs replicated on every shard (coarse
        grids are tiny; the collectives are one tiled all_gather per cycle).
        Same restriction (2x2 mean), linear prolongation, RB smoother, and
        -4x residual scaling as ops/multigrid.py, so the level ladder and
        numerics match the single-device solver.
        """
        from ..ops.multigrid import (_vcycle as _vcycle_rep, _coarse_shapes,
                                     _restrict, _prolong)
        omega_s = min(cfg.omega, 1.3)
        n_pre = n_post = 2

        # static level plan: (H_l, W_l, lh_l, lw_l) while shardable
        plan = []
        Hl, Wl, lhl, lwl = H, W, lh, lw
        while (lhl % 2 == 0 and lwl % 2 == 0 and lhl >= 8 and lwl >= 8
               and min(Hl, Wl) > 3):
            plan.append((Hl, Wl, lhl, lwl))
            Hl, Wl, lhl, lwl = Hl // 2, Wl // 2, lhl // 2, lwl // 2
        rep_shapes = _coarse_shapes((Hl, Wl), 32)

        def consts(level):
            Hg, Wg, lhg, lwg = plan[level]
            ox = lax.axis_index(X_AXIS) * lhg
            oy = lax.axis_index(Y_AXIS) * lwg
            gi = jax.lax.broadcasted_iota(jnp.int32, (lhg, lwg), 0) + ox
            gj = jax.lax.broadcasted_iota(jnp.int32, (lhg, lwg), 1) + oy
            a = (4 - (gi == 0).astype(jnp.int32)
                 - (gi == Hg - 1).astype(jnp.int32)
                 - (gj == 0).astype(jnp.int32)
                 - (gj == Wg - 1).astype(jnp.int32))
            lut = jnp.asarray(
                (-1.0 / np.arange(1, 5, dtype=np.float64)).astype(np.float32),
                d.dtype)
            return (gi + gj) % 2, lut[a - 1], ox, oy

        w_s = jnp.asarray(omega_s, d.dtype)
        one_m_ws = jnp.asarray(1.0 - omega_s, d.dtype)

        def nbr_sum(p):
            pp = _exchange2(p, 1, nx, ny)
            return (pp[:-2, 1:-1] + pp[2:, 1:-1]
                    + pp[1:-1, :-2] + pp[1:-1, 2:])

        def smooth(p, b, parity, neg_inv, sweeps):
            for _ in range(sweeps):
                for color in (0, 1):
                    p_new = one_m_ws * p + w_s * (neg_inv * (b - nbr_sum(p)))
                    p = jnp.where(parity == color, p_new, p)
            return p

        def residual(p, b, level):
            _, _, lhg, lwg = plan[level]
            Hg, Wg = plan[level][0], plan[level][1]
            gi = (jax.lax.broadcasted_iota(jnp.int32, (lhg, lwg), 0)
                  + lax.axis_index(X_AXIS) * lhg)
            gj = (jax.lax.broadcasted_iota(jnp.int32, (lhg, lwg), 1)
                  + lax.axis_index(Y_AXIS) * lwg)
            a = (4 - (gi == 0).astype(jnp.int32)
                 - (gi == Hg - 1).astype(jnp.int32)
                 - (gj == 0).astype(jnp.int32)
                 - (gj == Wg - 1).astype(jnp.int32)).astype(d.dtype)
            return nbr_sum(p) - a * p - b

        def restrict_local(x):
            lhg, lwg = x.shape
            return x.reshape(lhg // 2, 2, lwg // 2, 2).mean(axis=(1, 3))

        def prolong_sharded(x, level_fine):
            # cell-centered linear interp per axis, neighbor values via
            # edge-clamped halos (matches ops.multigrid._prolong globally)
            for axis in (0, 1):
                axname, n_sh = ((X_AXIS, nx) if axis == 0 else (Y_AXIS, ny))
                xp = exchange_halo(x, 1, axis, axname, n_sh, "edge")
                n = x.shape[axis]
                lo = jax.lax.slice_in_dim(xp, 0, n, axis=axis)
                hi = jax.lax.slice_in_dim(xp, 2, n + 2, axis=axis)
                even = 0.75 * x + 0.25 * lo
                odd = 0.75 * x + 0.25 * hi
                inter = jnp.stack([even, odd], axis=axis + 1)
                x = inter.reshape(x.shape[:axis] + (2 * n,)
                                  + x.shape[axis + 1:])
            return x

        def vcycle(p, b, level):
            parity, neg_inv, ox, oy = consts(level)
            p = smooth(p, b, parity, neg_inv, n_pre)
            r = residual(p, b, level)
            b_c = -4.0 * restrict_local(r)
            if level + 1 < len(plan):
                e_c = vcycle(jnp.zeros_like(b_c), b_c, level + 1)
            else:
                # gather the coarse level and solve replicated
                g = lax.all_gather(b_c, X_AXIS, axis=0, tiled=True)
                g = lax.all_gather(g, Y_AXIS, axis=1, tiled=True)
                e_rep = _vcycle_rep(jnp.zeros_like(g), g, rep_shapes, 0,
                                    omega_s, n_pre, n_post, 16)
                _, _, lhg, lwg = plan[level]
                e_c = lax.dynamic_slice(
                    e_rep, (lax.axis_index(X_AXIS) * (lhg // 2),
                            lax.axis_index(Y_AXIS) * (lwg // 2)),
                    (lhg // 2, lwg // 2))
            p = p + prolong_sharded(e_c, level)
            p = smooth(p, b, parity, neg_inv, n_post)
            return p

        b = jnp.asarray(dx, d.dtype) * d
        p = jnp.zeros_like(d)
        if not plan:  # too small to shard the ladder: replicate immediately
            g = lax.all_gather(b, X_AXIS, axis=0, tiled=True)
            g = lax.all_gather(g, Y_AXIS, axis=1, tiled=True)
            from ..ops.multigrid import multigrid_solve
            p_rep = multigrid_solve(g / jnp.asarray(dx, d.dtype), dx,
                                    cycles=cfg.mg_cycles, omega=cfg.omega)
            return lax.dynamic_slice(
                p_rep, (lax.axis_index(X_AXIS) * lh,
                        lax.axis_index(Y_AXIS) * lw), (lh, lw))
        for _ in range(cfg.mg_cycles):
            p = vcycle(p, b, 0)
        return p

    def impulses_local(vel, imp: Impulses, ii, jj):
        """Masked overwrite at global cells — scatter-free, shard-oblivious
        (.ino:264-269 semantics; later impulses win)."""
        for n in range(cfg.max_impulses):
            gi = jnp.clip(imp.pos[n, 0], 0, H - 1)
            gj = jnp.clip(imp.pos[n, 1], 0, W - 1)
            hit = imp.active[n] & (ii == gi) & (jj == gj)
            vel = jnp.where(hit[None],
                            imp.velocity[n, :, None, None].astype(vel.dtype),
                            vel)
        return vel

    def project_local(vel, ii, jj, want_p=False):
        """Pressure projection; returns (vel, p or None)."""
        div = divergence_local(vel)
        if cfg.solver == "multigrid":
            p = mg_local(div, ii, jj)
        else:
            p = sor_local(div, ii, jj)
        return gradient_sub_local(vel, p), (p if want_p else None)

    def gmax(x):
        return lax.pmax(lax.pmax(jnp.max(x), X_AXIS), Y_AXIS)

    def gsum(x):
        return lax.psum(lax.psum(jnp.sum(x), X_AXIS), Y_AXIS)

    def residual_local(p, div, ii, jj):
        """ops.poisson.poisson_residual with exchanged zero-ghost halos and
        the global-edge Neumann diagonal."""
        pp = _exchange2(p, 1, nx, ny)
        nb = (pp[:-2, 1:-1] + pp[2:, 1:-1]) + pp[1:-1, :-2] + pp[1:-1, 2:]
        a = (4 - (ii == 0).astype(jnp.int32) - (ii == H - 1).astype(jnp.int32)
             - (jj == 0).astype(jnp.int32)
             - (jj == W - 1).astype(jnp.int32)).astype(p.dtype)
        return nb - a * p - jnp.asarray(dx, p.dtype) * div

    def local_step_core(state: SimState, imp: Impulses, want_metrics: bool):
        ii, jj, ox, oy = _local_coords(cfg, nx, ny, lh, lw)
        vel = advect_dispatch(state.velocity, state.velocity, ii, jj, ox, oy,
                              no_slip=True)
        vel = impulses_local(vel, imp, ii, jj)
        if cfg.vorticity_eps > 0.0:
            vel = vorticity_local(vel)
        div_pre = divergence_local(vel) if want_metrics else None
        vel, p = project_local(vel, ii, jj, want_p=want_metrics)
        color = advect_dispatch(state.color, vel, ii, jj, ox, oy,
                                no_slip=False)
        if cfg.advector != "maccormack":
            color = jnp.clip(color, 0.0, 1.0)
        new_state = SimState(velocity=vel, color=color, step=state.step + 1)
        if not want_metrics:
            return new_state
        # SURVEY §5 metrics, distributed: local reductions + psum/pmax over
        # the mesh (every shard returns the identical replicated scalars)
        div_post = divergence_local(vel)
        res = residual_local(p, div_pre, ii, jj)
        n_cells = float(H * W)
        metrics = {
            "div_pre_max": gmax(jnp.abs(div_pre)),
            "div_post_max": gmax(jnp.abs(div_post)),
            "poisson_residual_l2": jnp.sqrt(gsum(res * res) / n_cells),
            "max_speed": jnp.sqrt(gmax(jnp.sum(vel * vel, axis=0))),
            "finite": (gsum((~jnp.isfinite(vel)).sum().astype(jnp.int32)
                            + (~jnp.isfinite(color)).sum().astype(jnp.int32))
                       == 0),
        }
        return new_state, metrics

    def local_step(state, imp):
        return local_step_core(state, imp, False)

    def local_step_metrics(state, imp):
        return local_step_core(state, imp, True)

    grid_spec = P(None, X_AXIS, Y_AXIS)
    state_spec = SimState(velocity=grid_spec, color=grid_spec, step=P())
    imp_spec = Impulses(pos=P(), velocity=P(), active=P())

    if with_metrics:
        metric_specs = {k: P() for k in
                        ("div_pre_max", "div_post_max", "poisson_residual_l2",
                         "max_speed", "finite")}
        fn = shard_map(
            local_step_metrics, mesh=mesh,
            in_specs=(state_spec, imp_spec),
            out_specs=(state_spec, metric_specs),
            check_vma=False,
        )
    else:
        fn = shard_map(
            local_step, mesh=mesh,
            in_specs=(state_spec, imp_spec),
            out_specs=state_spec,
            check_vma=False,
        )
    return jax.jit(fn, donate_argnums=(0,) if donate else ())


def make_sharded_step_with_metrics(cfg: SimConfig, mesh: Mesh,
                                   max_disp: int = 12, donate: bool = True,
                                   sor_halo: int = 1):
    """Sharded ``step_with_metrics``: the sharded step plus the SURVEY §5
    observability scalars, reduced across the mesh with ``psum``/``pmax``
    (VERDICT r1 missing #4: metrics previously existed single-device only)."""
    return make_sharded_step(cfg, mesh, max_disp=max_disp, donate=donate,
                             sor_halo=sor_halo, with_metrics=True)


def make_sharded_render(cfg: SimConfig, mesh: Mesh):
    """Sharded upscale+RGB565: each shard upscales its block using a 1-node
    edge halo; the lerp-endpoint row/col (the reference's ``.ino:115``) is
    cropped on device so the output matches the single-device render
    contract: ``[(H-1)*s, (W-1)*s]`` uint16, device-sharded."""
    H, W = cfg.shape
    nx = mesh.shape[X_AXIS]
    ny = mesh.shape[Y_AXIS]
    s = cfg.scaling

    from ..render.upscale import pack_rgb565, upscale_bilinear

    def local_render(color):
        cpad = _exchange2(color, 1, nx, ny, ("edge", "edge"))
        c = cpad[:, 1:, 1:]  # keep only the +1 ghost on the high side
        return pack_rgb565(upscale_bilinear(c, s))

    fn = shard_map(
        local_render, mesh=mesh,
        in_specs=(P(None, X_AXIS, Y_AXIS),),
        out_specs=P(X_AXIS, Y_AXIS),
        check_vma=False,
    )
    return jax.jit(lambda color: fn(color)[:(H - 1) * s, :(W - 1) * s])
