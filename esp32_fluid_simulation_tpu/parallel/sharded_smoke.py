"""Sharded 3D smoke step (BASELINE config 5: 256^3 plume over a mesh).

The vertical axis (D, axis -3) stays local to every shard; the horizontal
axes shard over the ``(x, y)`` mesh exactly like the 2D step — halo windows
for the advection backtrace, per-half-sweep pressure halos, boundary
conditions only on global-edge shards.  Parity vs the single-device
``models.smoke3d`` step is pinned in tests/test_sharded_smoke.py on the
virtual CPU mesh.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding

from ..models.smoke3d import SmokeConfig, SmokeState, _source_mask
from ..ops.advect import sample_linear
from .halo import exchange_halo
from .topology import X_AXIS, Y_AXIS


def sharded_smoke_sharding(cfg: SmokeConfig, mesh: Mesh):
    vol = P(None, None, X_AXIS, Y_AXIS)   # [3, D, H, W]
    scal = P(None, X_AXIS, Y_AXIS)        # [D, H, W]
    return SmokeState(
        velocity=NamedSharding(mesh, vol),
        density=NamedSharding(mesh, scal),
        temperature=NamedSharding(mesh, scal),
        step=NamedSharding(mesh, P()),
    )


def make_sharded_smoke_step(cfg: SmokeConfig, mesh: Mesh, max_disp: int = 4,
                            donate: bool = True):
    D, H, W = cfg.shape
    nx = mesh.shape[X_AXIS]
    ny = mesh.shape[Y_AXIS]
    if H % nx or W % ny:
        raise ValueError(f"grid {cfg.shape} not divisible by mesh ({nx},{ny})")
    lh, lw = H // nx, W // ny
    k = max_disp + 1
    dt, dx = cfg.dt, cfg.dx
    f32 = jnp.float32

    def _exchange2(x, width, bcs=("zero", "zero")):
        x = exchange_halo(x, width, -2, X_AXIS, nx, bcs[0])
        x = exchange_halo(x, width, -1, Y_AXIS, ny, bcs[1])
        return x

    def coords():
        ox = lax.axis_index(X_AXIS) * lh
        oy = lax.axis_index(Y_AXIS) * lw
        shp = (D, lh, lw)
        zz = jax.lax.broadcasted_iota(jnp.int32, shp, 0)
        ii = jax.lax.broadcasted_iota(jnp.int32, shp, 1) + ox
        jj = jax.lax.broadcasted_iota(jnp.int32, shp, 2) + oy
        return zz, ii, jj, ox, oy

    def advect_local(field, vel, zz, ii, jj, ox, oy, no_slip):
        fpad = _exchange2(field, k)
        gz = zz.astype(f32)
        gi = ii.astype(f32)
        gj = jj.astype(f32)
        sz_raw = gz - vel[0].astype(f32) * f32(dt)
        si_raw = gi - vel[1].astype(f32) * f32(dt)
        sj_raw = gj - vel[2].astype(f32) * f32(dt)
        sz = jnp.clip(sz_raw, 0.0, f32(D - 1))   # vertical axis fully local
        si = jnp.clip(jnp.clip(si_raw, gi - max_disp, gi + max_disp),
                      0.0, f32(H - 1))
        sj = jnp.clip(jnp.clip(sj_raw, gj - max_disp, gj + max_disp),
                      0.0, f32(W - 1))
        li = si - ox.astype(f32) + f32(k)
        lj = sj - oy.astype(f32) + f32(k)
        out = sample_linear(fpad, (sz, li, lj), no_slip=False)
        if no_slip:
            from ..ops.advect import noslip_axis_factor
            fac = (noslip_axis_factor(sz_raw, D)
                   * noslip_axis_factor(si_raw, H)
                   * noslip_axis_factor(sj_raw, W))
            out = out * fac.astype(out.dtype)
        return out

    def divergence_local(vel):
        inv = jnp.asarray(1.0 / (2.0 * dx), vel.dtype)
        vz = vel[0]
        # vertical axis: local reflect-negate ghosts (finitediff.cpp:17-20)
        lo = -vz[:1]
        hi = -vz[-1:]
        vz_e = jnp.concatenate([lo, vz, hi], axis=0)
        flow = vz_e[2:] - vz_e[:-2]
        # each component only needs ghosts along its own difference axis
        vx = exchange_halo(vel[1], 1, -2, X_AXIS, nx, "reflect_neg")
        vy = exchange_halo(vel[2], 1, -1, Y_AXIS, ny, "reflect_neg")
        flow = flow + (vx[:, 2:, :] - vx[:, :-2, :])
        flow = flow + (vy[:, :, 2:] - vy[:, :, :-2])
        return flow * inv

    def gradient_sub_local(vel, p):
        inv = jnp.asarray(1.0 / (2.0 * dx), vel.dtype)
        pz = jnp.concatenate([p[:1], p, p[-1:]], axis=0)  # Neumann clamp
        gz = (pz[2:] - pz[:-2]) * inv
        ppad = _exchange2(p, 1, ("edge", "edge"))
        gx = (ppad[:, 2:, 1:-1] - ppad[:, :-2, 1:-1]) * inv
        gy = (ppad[:, 1:-1, 2:] - ppad[:, 1:-1, :-2]) * inv
        return vel - jnp.stack([gz, gx, gy], axis=0)

    def sor_local(d, zz, ii, jj):
        parity = (zz + ii + jj) % 2
        a = (6
             - (zz == 0).astype(jnp.int32) - (zz == D - 1).astype(jnp.int32)
             - (ii == 0).astype(jnp.int32) - (ii == H - 1).astype(jnp.int32)
             - (jj == 0).astype(jnp.int32) - (jj == W - 1).astype(jnp.int32))
        lut = jnp.asarray(
            (-1.0 / np.arange(1, 7, dtype=np.float64)).astype(np.float32),
            d.dtype)
        neg_inv = lut[a - 1]
        w = jnp.asarray(cfg.omega, d.dtype)
        one_m_w = jnp.asarray(1.0 - cfg.omega, d.dtype)
        dxd = jnp.asarray(dx, d.dtype) * d
        zrow = jnp.zeros_like(d[:1])
        p = jnp.zeros_like(d)
        for _ in range(cfg.sor_iters):
            for color in (0, 1):
                nb = (jnp.concatenate([zrow, p[:-1]], 0)
                      + jnp.concatenate([p[1:], zrow], 0))
                ppad = _exchange2(p, 1)
                nb = nb + (ppad[:, :-2, 1:-1] + ppad[:, 2:, 1:-1]
                           + ppad[:, 1:-1, :-2] + ppad[:, 1:-1, 2:])
                p_new = one_m_w * p + w * (neg_inv * (dxd - nb))
                p = jnp.where(parity == color, p_new, p)
        return p

    def shift_ec(x, axis):
        """(x[+1] - x[-1]) along ``axis`` with edge-clamped ghosts — the
        sharded rendition of ops.fd._shift_edge_clamp on [D, lh, lw]:
        axis 0 (vertical) is shard-local, axes 1/2 exchange a 1-wide strip."""
        if axis == 0:
            ext = jnp.concatenate([x[:1], x, x[-1:]], axis=0)
            return ext[2:] - ext[:-2]
        axname, n_sh = (X_AXIS, nx) if axis == 1 else (Y_AXIS, ny)
        xp = exchange_halo(x, 1, axis, axname, n_sh, "edge")
        lo = jax.lax.slice_in_dim(xp, 0, x.shape[axis], axis=axis)
        hi = jax.lax.slice_in_dim(xp, 2, x.shape[axis] + 2, axis=axis)
        return hi - lo

    def vorticity_local(vel):
        """3D Fedkiw confinement (ops.fd.vorticity_confinement, nd==3) with
        halo-exchanged edge-clamped differences."""
        inv = jnp.asarray(1.0 / (2.0 * dx), vel.dtype)
        tiny = jnp.asarray(1e-6, vel.dtype)

        def d(comp, axis):
            return shift_ec(vel[comp], axis) * inv

        w = jnp.stack([
            d(2, 1) - d(1, 2),
            d(0, 2) - d(2, 0),
            d(1, 0) - d(0, 1),
        ], axis=0)
        aw = jnp.sqrt(jnp.sum(w * w, axis=0))
        g = jnp.stack([shift_ec(aw, kax) * inv for kax in range(3)], axis=0)
        mag = jnp.sqrt(jnp.sum(g * g, axis=0)) + tiny
        n = g / mag
        f = jnp.stack([
            n[1] * w[2] - n[2] * w[1],
            n[2] * w[0] - n[0] * w[2],
            n[0] * w[1] - n[1] * w[0],
        ], axis=0)
        return vel + (cfg.vorticity_eps * dx * dt) * f

    def mg3d_local(d3, zz, ii, jj):
        """Sharded 3D geometric multigrid (the 2D hybrid ladder of
        parallel.sharded.mg_local generalized): levels stay sharded while
        every shard's horizontal block halves cleanly; below that the level
        is all-gathered and the remaining V-cycle runs replicated.  Same
        restriction / linear prolongation / RB smoother / -4x residual
        scaling as ops.multigrid, so numerics match the single-device
        solver."""
        from ..ops.multigrid import _vcycle as _vcycle_rep, _coarse_shapes
        omega_s = 1.3   # multigrid_solve's smoother cap
        n_pre = n_post = 2

        plan = []
        Dl, Hl, Wl, lhl, lwl = D, H, W, lh, lw
        while (Dl % 2 == 0 and lhl % 2 == 0 and lwl % 2 == 0
               and lhl >= 8 and lwl >= 8 and min(Dl, Hl, Wl) > 3):
            plan.append((Dl, Hl, Wl, lhl, lwl))
            Dl, Hl, Wl = Dl // 2, Hl // 2, Wl // 2
            lhl, lwl = lhl // 2, lwl // 2
        rep_shapes = _coarse_shapes((Dl, Hl, Wl), 32)

        def consts(level):
            Dg, Hg, Wg, lhg, lwg = plan[level]
            ox = lax.axis_index(X_AXIS) * lhg
            oy = lax.axis_index(Y_AXIS) * lwg
            shp = (Dg, lhg, lwg)
            z = jax.lax.broadcasted_iota(jnp.int32, shp, 0)
            gi = jax.lax.broadcasted_iota(jnp.int32, shp, 1) + ox
            gj = jax.lax.broadcasted_iota(jnp.int32, shp, 2) + oy
            a = (6
                 - (z == 0).astype(jnp.int32) - (z == Dg - 1).astype(jnp.int32)
                 - (gi == 0).astype(jnp.int32)
                 - (gi == Hg - 1).astype(jnp.int32)
                 - (gj == 0).astype(jnp.int32)
                 - (gj == Wg - 1).astype(jnp.int32))
            lut = jnp.asarray(
                (-1.0 / np.arange(1, 7, dtype=np.float64)).astype(np.float32),
                d3.dtype)
            return (z + gi + gj) % 2, lut[a - 1], a.astype(d3.dtype)

        w_s = jnp.asarray(omega_s, d3.dtype)
        one_m_ws = jnp.asarray(1.0 - omega_s, d3.dtype)

        def nbr_sum(p):
            zrow = jnp.zeros_like(p[:1])
            nb = (jnp.concatenate([zrow, p[:-1]], 0)
                  + jnp.concatenate([p[1:], zrow], 0))
            pp = _exchange2(p, 1)
            return nb + (pp[:, :-2, 1:-1] + pp[:, 2:, 1:-1]
                         + pp[:, 1:-1, :-2] + pp[:, 1:-1, 2:])

        def smooth(p, b, parity, neg_inv, sweeps):
            for _ in range(sweeps):
                for color in (0, 1):
                    p_new = one_m_ws * p + w_s * (neg_inv * (b - nbr_sum(p)))
                    p = jnp.where(parity == color, p_new, p)
            return p

        def restrict_local(x):
            Dg, lhg, lwg = x.shape
            return x.reshape(Dg // 2, 2, lhg // 2, 2,
                             lwg // 2, 2).mean(axis=(1, 3, 5))

        def prolong_sharded(x):
            for axis in range(3):
                n = x.shape[axis]
                if axis == 0:
                    lo_e = jnp.concatenate(
                        [x[:1], jax.lax.slice_in_dim(x, 0, n - 1, axis=0)], 0)
                    hi_e = jnp.concatenate(
                        [jax.lax.slice_in_dim(x, 1, n, axis=0), x[-1:]], 0)
                else:
                    axname, n_sh = ((X_AXIS, nx) if axis == 1
                                    else (Y_AXIS, ny))
                    xp = exchange_halo(x, 1, axis, axname, n_sh, "edge")
                    lo_e = jax.lax.slice_in_dim(xp, 0, n, axis=axis)
                    hi_e = jax.lax.slice_in_dim(xp, 2, n + 2, axis=axis)
                even = 0.75 * x + 0.25 * lo_e
                odd = 0.75 * x + 0.25 * hi_e
                inter = jnp.stack([even, odd], axis=axis + 1)
                x = inter.reshape(x.shape[:axis] + (2 * n,)
                                  + x.shape[axis + 1:])
            return x

        def vcycle(p, b, level):
            parity, neg_inv, a = consts(level)
            p = smooth(p, b, parity, neg_inv, n_pre)
            r = nbr_sum(p) - a * p - b
            b_c = -4.0 * restrict_local(r)
            if level + 1 < len(plan):
                e_c = vcycle(jnp.zeros_like(b_c), b_c, level + 1)
            else:
                g = lax.all_gather(b_c, X_AXIS, axis=1, tiled=True)
                g = lax.all_gather(g, Y_AXIS, axis=2, tiled=True)
                e_rep = _vcycle_rep(jnp.zeros_like(g), g, rep_shapes, 0,
                                    omega_s, n_pre, n_post, 16)
                Dg, _, _, lhg, lwg = plan[level]
                e_c = lax.dynamic_slice(
                    e_rep, (0, lax.axis_index(X_AXIS) * (lhg // 2),
                            lax.axis_index(Y_AXIS) * (lwg // 2)),
                    (Dg // 2, lhg // 2, lwg // 2))
            p = p + prolong_sharded(e_c)
            p = smooth(p, b, parity, neg_inv, n_post)
            return p

        b = jnp.asarray(dx, d3.dtype) * d3
        p = jnp.zeros_like(d3)
        if not plan:    # too small to shard the ladder: replicate immediately
            from ..ops.multigrid import multigrid_solve
            g = lax.all_gather(b, X_AXIS, axis=1, tiled=True)
            g = lax.all_gather(g, Y_AXIS, axis=2, tiled=True)
            p_rep = multigrid_solve(g / jnp.asarray(dx, d3.dtype), dx,
                                    cycles=cfg.mg_cycles)
            return lax.dynamic_slice(
                p_rep, (0, lax.axis_index(X_AXIS) * lh,
                        lax.axis_index(Y_AXIS) * lw), (D, lh, lw))
        for _ in range(cfg.mg_cycles):
            p = vcycle(p, b, 0)
        return p

    src_global = _source_mask(cfg)

    def local_step(state: SmokeState) -> SmokeState:
        zz, ii, jj, ox, oy = coords()
        vel, rho, temp = state.velocity, state.density, state.temperature

        vel = advect_local(vel, vel, zz, ii, jj, ox, oy, no_slip=True)
        rho = advect_local(rho, vel, zz, ii, jj, ox, oy, no_slip=False)
        temp = advect_local(temp, vel, zz, ii, jj, ox, oy, no_slip=False)

        # local slice of the global source mask, via dynamic_slice at the
        # shard offset (the mask is a trace-time numpy constant)
        src_full = jnp.asarray(src_global, rho.dtype)
        src = lax.dynamic_slice(src_full, (0, ox, oy), (D, lh, lw))
        rho = jnp.minimum(rho + dt * cfg.source_density * src, 1.0)
        temp = temp + dt * cfg.source_temperature * src

        buoy = (cfg.buoyancy_alpha * temp - cfg.buoyancy_beta * rho) * dt
        vel = vel.at[0].add(-buoy)
        if cfg.vorticity_eps > 0:
            vel = vorticity_local(vel)

        div = divergence_local(vel)
        if cfg.solver == "multigrid":
            p = mg3d_local(div, zz, ii, jj)
        else:
            p = sor_local(div, zz, ii, jj)
        vel = gradient_sub_local(vel, p)

        if cfg.dissipation > 0:
            decay = 1.0 - cfg.dissipation * dt
            rho = rho * decay
            temp = temp * decay

        return SmokeState(velocity=vel, density=rho, temperature=temp,
                          step=state.step + 1)

    vol = P(None, None, X_AXIS, Y_AXIS)
    scal = P(None, X_AXIS, Y_AXIS)
    spec = SmokeState(velocity=vol, density=scal, temperature=scal, step=P())
    fn = shard_map(local_step, mesh=mesh, in_specs=(spec,), out_specs=spec,
                   check_vma=False)
    return jax.jit(fn, donate_argnums=(0,) if donate else ())
