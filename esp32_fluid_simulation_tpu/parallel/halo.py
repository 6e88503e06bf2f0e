"""Halo exchange over a device mesh with boundary-condition-aware edges.

The stencils in ``ops/`` read 1 neighbor cell (divergence, gradient, SOR) or
``max_disp+1`` cells (advection backtrace).  Sharding the grid over mesh axes
means each stencil application needs the neighbor shard's edge strip — the
grid-world equivalent of ring attention's block rotation (SURVEY.md §5).

``exchange_halo`` runs inside ``shard_map``: it ships ``width``-wide strips
to both neighbors along one mesh axis with ``jax.lax.ppermute`` (neighbor
traffic over the device interconnect, no all-to-all) and fills the two
*global* edges according to the physical boundary condition:

* ``zero``        — zero ghosts (SOR neighbor sums, advect windows);
* ``edge``        — clamp to the edge value (Neumann pressure gradient,
                    ``finitediff.cpp:51-54``);
* ``reflect_neg`` — negated mirror (no-penetration ghost velocity,
                    ``finitediff.cpp:17-20``).

``ppermute`` already yields zeros on shards that receive nothing, so ``zero``
needs no fixup at all.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _take(x, dim, start, size):
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(start, start + size) if start >= 0 else slice(start, None)
    return x[tuple(idx)]


def exchange_halo(x: jax.Array, width: int, dim: int, axis_name: str,
                  n_shards: int, bc: str = "zero") -> jax.Array:
    """Return ``x`` extended by ``width`` ghost cells on both sides of array
    axis ``dim``, exchanged along mesh axis ``axis_name`` (``n_shards``
    static)."""
    if width == 0:
        return x
    dim = dim % x.ndim
    if width > x.shape[dim]:
        raise ValueError(
            f"halo width {width} exceeds the shard extent {x.shape[dim]} "
            f"along dim {dim} — use a smaller max_disp/sor_halo or fewer "
            f"shards on this axis (strips would silently truncate)")

    if n_shards == 1:
        lo_ghost = jnp.zeros_like(_take(x, dim, 0, width))
        hi_ghost = jnp.zeros_like(lo_ghost)
    else:
        # my high strip -> next shard's low ghost; my low strip -> previous
        # shard's high ghost.  Non-receiving edge shards get zeros.
        hi_strip = _take(x, dim, -width, width)
        lo_strip = _take(x, dim, 0, width)
        lo_ghost = lax.ppermute(
            hi_strip, axis_name, [(i, i + 1) for i in range(n_shards - 1)])
        hi_ghost = lax.ppermute(
            lo_strip, axis_name, [(i + 1, i) for i in range(n_shards - 1)])

    if bc != "zero":
        idx = lax.axis_index(axis_name) if n_shards > 1 else 0
        if bc == "edge":
            lo_fill = jnp.repeat(_take(x, dim, 0, 1), width, axis=dim)
            hi_fill = jnp.repeat(_take(x, dim, -1, 1), width, axis=dim)
        elif bc == "reflect_neg":
            lo_fill = -jnp.flip(_take(x, dim, 0, width), axis=dim)
            hi_fill = -jnp.flip(_take(x, dim, -width, width), axis=dim)
        else:
            raise ValueError(f"unknown bc {bc!r}")
        if n_shards == 1:
            lo_ghost, hi_ghost = lo_fill, hi_fill
        else:
            lo_ghost = jnp.where(idx == 0, lo_fill, lo_ghost)
            hi_ghost = jnp.where(idx == n_shards - 1, hi_fill, hi_ghost)

    return jnp.concatenate([lo_ghost, x, hi_ghost], axis=dim)
