"""vmap-batched ensembles (BASELINE config 4: 256 independent 256^2 sims on
one chip for parameter sweeps).

Because the step is a pure function of a state pytree, batching is one
``jax.vmap`` — the reference's latent SPMD (SURVEY.md §2 "parallelism
strategies") made literal.  Members can differ in their impulse schedules
(the swept parameter); config stays shared so one XLA program serves the
whole ensemble.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import SimConfig
from ..state import SimState, Impulses
from .stable_fluids import init_state, step


def init_ensemble(cfg: SimConfig, n: int) -> SimState:
    """n identical members (diverge via per-member impulses)."""
    s = init_state(cfg)
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n,) + x.shape), s)


def stack_impulses(imps) -> Impulses:
    """[Impulses, ...] (one per member) -> batched Impulses."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *imps)


def _tiled_compatible(cfg: SimConfig) -> bool:
    """Can this member config run as one tiled-domain supergrid step?"""
    return (cfg.ndim == 2 and cfg.advector == "semilag"
            and cfg.vorticity_eps == 0.0 and cfg.domain_tile is None
            and cfg.solver == "sor" and min(cfg.shape) >= 32)


def _member_impulse_targets(imp: Impulses, gh: int, gw: int,
                            mh: int, mw: int):
    """[n, k] member impulses -> flat supergrid scatter targets.

    Within a member, slot order preserves the reference's queue-drain
    overwrite semantics (``.ino:264-269``) — for duplicate positions the
    LAST active slot wins.  Overwrites are resolved up front in [n, k]
    index space (k^2 tiny vector ops); superseded/inactive slots are
    routed to row ``gh*mh`` (out of bounds — scatter with mode="drop").
    Returns ``(rows[n*k], cols[n*k], vals[nd, n*k])``."""
    n, k, nd = imp.pos.shape
    oi = (jnp.arange(n, dtype=jnp.int32) // gw) * mh   # [n] tile origins
    oj = (jnp.arange(n, dtype=jnp.int32) % gw) * mw
    li = jnp.clip(imp.pos[:, :, 0], 0, mh - 1)         # [n, k] member-local
    lj = jnp.clip(imp.pos[:, :, 1], 0, mw - 1)
    act = imp.active                                   # [n, k]
    same = ((li[:, :, None] == li[:, None, :])
            & (lj[:, :, None] == lj[:, None, :]))      # [n, k, k]
    later = jnp.triu(jnp.ones((k, k), jnp.bool_), 1)[None]   # s' > s
    superseded = jnp.any(same & later & act[:, None, :], axis=2)
    write = act & ~superseded
    rows = jnp.where(write, oi[:, None] + li, gh * mh)  # OOB = dropped
    cols = oj[:, None] + lj
    vals = jnp.moveaxis(imp.velocity, 2, 0).reshape(nd, n * k)
    return rows.reshape(-1), cols.reshape(-1), vals


def _apply_member_impulses(vel, imp: Impulses, gh: int, gw: int,
                           mh: int, mw: int):
    """Batched per-member impulses onto the supergrid velocity.

    ONE scatter for all (member, slot) points (members write to disjoint
    tiles, so cross-member order is irrelevant); a per-slot ``.at[].set``
    loop would cost 2k full-grid passes."""
    rows, cols, vals = _member_impulse_targets(imp, gh, gw, mh, mw)
    return vel.at[:, rows, cols].set(vals.astype(vel.dtype), mode="drop")


def _resolve_tiled(cfg: SimConfig, mode: str) -> bool:
    """Shared mode validation for the ensemble builders."""
    if mode not in ("auto", "vmap", "tiled"):
        raise ValueError(f"unknown ensemble mode {mode!r}")
    if mode == "tiled" and not _tiled_compatible(cfg):
        raise ValueError("config is not tiled-ensemble compatible "
                         "(needs 2D semilag, no vorticity, sor solver)")
    return _tiled_compatible(cfg) if mode == "auto" else mode == "tiled"


# mode="auto" refuses to fall back to the per-member vmap path from this
# member count on: a large ensemble that silently lost its supergrid route
# is a configuration mistake worth surfacing.  Small ensembles stay quiet.
_AUTO_VMAP_GUARD_N = 64


def _guard_auto_vmap(cfg: SimConfig, n: int) -> None:
    if n >= _AUTO_VMAP_GUARD_N:
        raise ValueError(
            f"mode='auto' fell back to the vmap ensemble path for n={n} "
            f"members — this config ({cfg.advector=}, "
            f"{cfg.vorticity_eps=}, {cfg.solver=}) is not tiled-supergrid "
            f"compatible.  Pass mode='vmap' explicitly to run the batched "
            f"per-member programs, or use a tiled-compatible member config "
            f"(2D semilag, no vorticity, solver='sor').")


def _to_super(state: SimState, cfg_super: SimConfig) -> SimState:
    """Member-stack [n, C, mh, mw] state -> one supergrid state."""
    from .stable_fluids import _from_members
    H, W = cfg_super.shape
    return SimState(
        velocity=_from_members(state.velocity, H, W),
        color=_from_members(state.color, H, W),
        step=state.step[0] if state.step.ndim else state.step)


def _from_super(out: SimState, cfg: SimConfig, n: int) -> SimState:
    """Supergrid state -> member-stack [n, C, mh, mw] state."""
    from .stable_fluids import _to_members
    mh, mw = cfg.shape
    return SimState(
        velocity=_to_members(out.velocity, mh, mw),
        color=_to_members(out.color, mh, mw),
        step=jnp.broadcast_to(out.step, (n,)))


def make_ensemble_step(cfg: SimConfig, donate: bool = True,
                       mode: str = "auto"):
    """Batched step: (SimState[n, ...], Impulses[n, ...]) -> SimState.

    ``mode="auto"`` (default) routes compatible configs onto the tiled-
    domain supergrid — members become tiles of one big grid and the whole
    ensemble advances in ONE step.  ``"vmap"`` forces the
    batched-small-programs path (also the parity oracle); ``"tiled"``
    requires a compatible config."""
    if not _resolve_tiled(cfg, mode):
        vfn = jax.vmap(functools.partial(step, cfg=cfg))

        def fn(state: SimState, imps: Impulses) -> SimState:
            if mode == "auto":
                _guard_auto_vmap(cfg, state.velocity.shape[0])
            return vfn(state, imps)

        return jax.jit(fn, donate_argnums=(0,) if donate else ())

    from .stable_fluids import _step_tiled

    def fn(state: SimState, imps: Impulses) -> SimState:
        n = state.velocity.shape[0]
        cfg_super, gh, gw = tiled_ensemble_config(cfg, n)
        mh, mw = cfg.shape
        apply_fn = functools.partial(_apply_member_impulses, imp=imps,
                                     gh=gh, gw=gw, mh=mh, mw=mw)
        out = _step_tiled(_to_super(state, cfg_super), None, cfg_super,
                          apply_fn=apply_fn)
        return _from_super(out, cfg, n)

    return jax.jit(fn, donate_argnums=(0,) if donate else ())


def make_ensemble_multi_step(cfg: SimConfig, donate: bool = True,
                             mode: str = "auto"):
    """scan-compiled ensemble rollout: ``run(state, schedule) -> state``
    advances all members ``n_steps`` in ONE device program.

    ``schedule`` is an ``Impulses`` pytree with leading ``[n_steps,
    n_members]`` axes (``stable_fluids.stack_schedule`` over per-step
    ``stack_impulses`` results).  Unlike stepping ``make_ensemble_step`` in
    a host loop, the tiled route converts member-stack <-> supergrid layout
    ONCE per call instead of every step, and the whole forcing
    schedule uploads in one transfer (the ensemble analogue of
    ``make_multi_step``)."""
    if not _resolve_tiled(cfg, mode):
        sfn = jax.vmap(functools.partial(step, cfg=cfg))

        def run(state: SimState, schedule: Impulses) -> SimState:
            if mode == "auto":
                _guard_auto_vmap(cfg, state.velocity.shape[0])
            out, _ = jax.lax.scan(
                lambda st, imp: (sfn(st, imp), None), state, schedule)
            return out

        return jax.jit(run, donate_argnums=(0,) if donate else ())

    from .stable_fluids import _step_tiled

    def run(state: SimState, schedule: Impulses) -> SimState:
        n = state.velocity.shape[0]
        cfg_super, gh, gw = tiled_ensemble_config(cfg, n)
        mh, mw = cfg.shape

        def body(st, imp):
            apply_fn = functools.partial(_apply_member_impulses, imp=imp,
                                         gh=gh, gw=gw, mh=mh, mw=mw)
            return _step_tiled(st, None, cfg_super,
                               apply_fn=apply_fn), None

        out, _ = jax.lax.scan(body, _to_super(state, cfg_super), schedule)
        return _from_super(out, cfg, n)

    return jax.jit(run, donate_argnums=(0,) if donate else ())


def tiled_ensemble_config(member_cfg: SimConfig, n: int):
    """Supergrid config for n member domains (BASELINE config 4 as one
    grid): members become tiles of one big grid and every boundary
    condition acts per tile (``SimConfig.domain_tile``), so the whole
    ensemble advances in ONE step.  Returns (supergrid_cfg, gh, gw)."""
    import dataclasses
    import math
    gh = int(math.sqrt(n))
    while n % gh:
        gh -= 1
    gw = n // gh
    h, w = member_cfg.shape
    return dataclasses.replace(
        member_cfg, shape=(gh * h, gw * w), domain_tile=(h, w)), gh, gw


def tiled_member_impulses(cfg_super: SimConfig, member_cfg: SimConfig,
                          gh: int, gw: int, per_member) -> Impulses:
    """Per-member impulse lists -> one supergrid Impulses batch.

    ``per_member``: list of (pos_list, vel_list) per member (row-major over
    the (gh, gw) tile grid); positions are member-local and get offset to
    the member's tile origin.  The supergrid step applies at most
    ``cfg_super.max_impulses`` total — spread schedules across steps for
    dense forcing."""
    h, w = member_cfg.shape
    pos, vel = [], []
    for m, (ps, vs) in enumerate(per_member):
        oi, oj = (m // gw) * h, (m % gw) * w
        pos.extend((oi + p[0], oj + p[1]) for p in ps)
        vel.extend(vs)
    return Impulses.from_lists(cfg_super, pos, vel)
