"""Sharded tiled-domain supergrid step (BASELINE config 4 past one chip).

A ``SimConfig.domain_tile`` supergrid packs independent (mh, mw) member
domains into one big grid; every boundary condition is a *member wall*
(``models.stable_fluids._step_tiled``).
Sharding that supergrid over an (x, y) device mesh with each shard owning
WHOLE member tiles makes the step embarrassingly parallel: member walls
never cross shard boundaries, so no halo exchange is needed at all — the
reference's latent SPMD (SURVEY §2 "parallelism strategies", the
``domain_iter`` shape-uniform data parallelism) at its cheapest.  Each shard
runs the ordinary tiled step (``models.stable_fluids._step_tiled``) on its
local supergrid block; only the impulse scatter is shard-aware (global
positions shift into the shard frame, out-of-shard writes drop).

The alignment requirement (mesh divides the grid, shard blocks divide into
whole members) is checked at build time; a config that needs member tiles
to straddle shards should instead shard members over the ``batch`` axis via
the vmap ensemble path.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import SimConfig
from ..state import SimState, Impulses
from .topology import X_AXIS, Y_AXIS


def _shard_local_scatter(vel, rows, cols, vals, ox, oy, lh, lw):
    """Scatter global (rows, cols) -> this shard's local block.

    Out-of-shard (and already OOB-routed superseded/inactive) targets are
    re-routed to local row ``lh`` and dropped by the scatter."""
    in_shard = ((rows >= ox) & (rows < ox + lh)
                & (cols >= oy) & (cols < oy + lw))
    lr = jnp.where(in_shard, rows - ox, lh)
    lc = jnp.where(in_shard, cols - oy, 0)
    return vel.at[:, lr, lc].set(vals.astype(vel.dtype), mode="drop")


def make_sharded_tiled_step(cfg: SimConfig, mesh: Mesh, donate: bool = True,
                            member_impulses: bool = False):
    """Jitted sharded step for a ``domain_tile`` supergrid config.

    ``member_impulses=False``: takes plain ``Impulses`` with supergrid-global
    positions (the ``step(state, impulses, cfg)`` contract for tiled
    configs).  ``member_impulses=True``: takes the ensemble-batched
    ``Impulses`` with leading ``[n_members]`` axis and member-local
    positions (``models.ensemble.stack_impulses``), applied via the same
    one-scatter overwrite resolution as the single-device supergrid.
    """
    if cfg.domain_tile is None:
        raise ValueError("make_sharded_tiled_step needs a domain_tile "
                         "config; use make_sharded_step for one domain")
    H, W = cfg.shape
    mh, mw = cfg.domain_tile
    nx = mesh.shape[X_AXIS]
    ny = mesh.shape[Y_AXIS]
    if H % nx or W % ny:
        raise ValueError(f"grid {cfg.shape} not divisible by mesh "
                         f"({nx},{ny})")
    lh, lw = H // nx, W // ny
    if lh % mh or lw % mw:
        raise ValueError(
            f"shard blocks ({lh},{lw}) must contain whole member tiles "
            f"({mh},{mw}): pick a mesh whose (x,y) factors divide the "
            f"({H // mh},{W // mw}) member grid")
    local_cfg = dataclasses.replace(cfg, shape=(lh, lw))
    gh_g, gw_g = H // mh, W // mw   # global member grid

    from ..models.stable_fluids import _step_tiled, apply_impulses

    def local_step(state: SimState, imp: Impulses) -> SimState:
        ox = lax.axis_index(X_AXIS) * lh
        oy = lax.axis_index(Y_AXIS) * lw

        if member_impulses:
            from ..models.ensemble import _member_impulse_targets

            def apply_fn(v):
                rows, cols, vals = _member_impulse_targets(
                    imp, gh_g, gw_g, mh, mw)
                return _shard_local_scatter(v, rows, cols, vals,
                                            ox, oy, lh, lw)
        else:
            def apply_fn(v):
                # same last-wins overwrite resolution as apply_impulses,
                # on supergrid-global positions, then shifted shard-local
                k = imp.pos.shape[0]
                gi = jnp.clip(imp.pos[:, 0], 0, H - 1)
                gj = jnp.clip(imp.pos[:, 1], 0, W - 1)
                act = imp.active
                same = ((gi[:, None] == gi[None, :])
                        & (gj[:, None] == gj[None, :]))
                later = jnp.triu(jnp.ones((k, k), jnp.bool_), 1)
                superseded = jnp.any(same & later & act[None, :], axis=1)
                rows = jnp.where(act & ~superseded, gi, H)
                return _shard_local_scatter(v, rows, gj, imp.velocity.T,
                                            ox, oy, lh, lw)

        return _step_tiled(state, None, local_cfg, apply_fn=apply_fn)

    grid_spec = P(None, X_AXIS, Y_AXIS)
    state_spec = SimState(velocity=grid_spec, color=grid_spec, step=P())
    imp_spec = Impulses(pos=P(), velocity=P(), active=P())
    fn = shard_map(local_step, mesh=mesh,
                   in_specs=(state_spec, imp_spec),
                   out_specs=state_spec, check_vma=False)
    return jax.jit(fn, donate_argnums=(0,) if donate else ())


def make_sharded_ensemble_step(member_cfg: SimConfig, mesh: Mesh, n: int,
                               donate: bool = True):
    """Ensemble API over the sharded supergrid: (SimState[n, ...],
    Impulses[n, ...]) -> SimState[n, ...], the multi-chip rendition of
    ``models.ensemble.make_ensemble_step(mode="tiled")``.

    Layout conversion (member stack <-> supergrid) happens inside the jit;
    the supergrid state is sharded over the (x, y) mesh axes."""
    from ..models.ensemble import (tiled_ensemble_config, _to_super,
                                   _from_super)
    cfg_super, gh, gw = tiled_ensemble_config(member_cfg, n)
    inner = make_sharded_tiled_step(cfg_super, mesh, donate=False,
                                    member_impulses=True)

    def fn(state: SimState, imps: Impulses) -> SimState:
        out = inner(_to_super(state, cfg_super), imps)
        return _from_super(out, member_cfg, n)

    return jax.jit(fn, donate_argnums=(0,) if donate else ()), cfg_super
