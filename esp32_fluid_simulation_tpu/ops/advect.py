"""Semi-Lagrangian advection as a vectorized backtrace + multilinear gather.

Capability match for the reference's ``advect.h`` (87 LoC): for every node,
backtrace ``source = (i, j) - vel * dt`` (``advect.h:81``) and sample the old
field there with bilinear interpolation.  The reference's sampler
(``advect.h:24-72``) has three behaviors this module reproduces exactly, but
vectorized over the whole grid instead of per-cell branches:

* interior: bilinear interpolation of the 4 surrounding nodes
  (``advect.h:38-42``);
* out of bounds on any axis: collapse that axis to the boundary node and lerp
  only along the in-bounds axes (``advect.h:44-55``) — mathematically equal
  to multilinear interpolation at the *clamped* coordinate, which is how it
  is computed here (one code path, no branches, one fused XLA loop);
* optional no-slip discount: a sample past the wall is attenuated linearly to
  zero over half a cell of overshoot, per out-of-bounds axis
  (``advect.h:57-71``).

Rank-polymorphic: the same code advects 2D ``(H, W)`` and 3D ``(D, H, W)``
grids (trilinear), and any number of leading channel axes (velocity
``[nd, *shape]``, dye ``[3, *shape]`` — the reference templates over element
type for the same reason, ``advect.h:74-76``).

Also provides MacCormack (BFECC-style) advection with a monotonic limiter
(BASELINE config 3), built from the same gather machinery.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp


def _lerp(t, a, b):
    """Reference lerp form ``p1*(1-t) + p2*t`` (``advect.h:14-16``)."""
    return a * (1 - t) + b * t


def _gather_corners(field: jax.Array, i0s: Sequence[jax.Array]):
    """Gather the 2^nd corner values around base indices ``i0s``.

    Returns a nested-list tree matching the recursive lerp order: index 0/1
    on axis k selects node i0/i0+1 on spatial axis k.
    """
    nd = len(i0s)

    def gather(offsets):
        idx = tuple(i0s[k] + offsets[k] for k in range(nd))
        return field[(Ellipsis,) + idx]

    def build(axis, offsets):
        if axis == nd:
            return gather(offsets)
        return [build(axis + 1, offsets + (0,)), build(axis + 1, offsets + (1,))]

    return build(0, ())


def sample_linear(
    field: jax.Array,
    coords: Sequence[jax.Array],
    no_slip: bool = False,
    return_minmax: bool = False,
):
    """Multilinear sample of ``field`` at fractional ``coords`` with the
    reference's edge-collapse + no-slip-discount semantics.

    field:  ``[*channels, *shape]``; coords: one float array per spatial axis
    (all broadcast-compatible, typically each of shape ``shape``).
    """
    nd = len(coords)
    shape = field.shape[field.ndim - nd:]
    dtype = field.dtype

    i0s, fracs, factors = [], [], []
    for k in range(nd):
        n = shape[k]
        c = coords[k]
        # Clamped-coordinate interpolation == the reference's edge lerp
        # (advect.h:44-55): collapse OOB axes to the boundary node.
        cc = jnp.clip(c, 0.0, n - 1.0)
        i0 = jnp.clip(jnp.floor(cc), 0, n - 2).astype(jnp.int32)
        fracs.append((cc - i0).astype(dtype))
        i0s.append(i0)
        if no_slip:
            # advect.h:62-70: overshoot past the wall attenuates to zero over
            # half a cell; note ``c >= n-1`` already counts as the boundary.
            under = c < 0
            over = c >= n - 1
            overshoot = jnp.where(under, -c, c - (n - 1))
            f = jnp.where(
                under | over,
                jnp.where(overshoot < 0.5, 1.0 - 2.0 * overshoot, 0.0),
                1.0,
            )
            factors.append(f.astype(dtype))

    corners = _gather_corners(field, i0s)

    def reduce_lerp(tree, axis):
        if axis == nd:
            return tree
        lo = reduce_lerp(tree[0], axis + 1)
        hi = reduce_lerp(tree[1], axis + 1)
        # Reference nests the *first* axis outermost (advect.h:19-22).
        return _lerp(fracs[axis], lo, hi)

    val = reduce_lerp(corners, 0)

    if no_slip:
        total = factors[0]
        for f in factors[1:]:
            total = total * f
        val = val * total

    if not return_minmax:
        return val

    leaves = jax.tree_util.tree_leaves(corners)
    cmin = leaves[0]
    cmax = leaves[0]
    for leaf in leaves[1:]:
        cmin = jnp.minimum(cmin, leaf)
        cmax = jnp.maximum(cmax, leaf)
    return val, cmin, cmax


def noslip_axis_factor(raw_coord: jax.Array, n: int):
    """The per-axis no-slip overshoot discount (``advect.h:62-70``), from the
    *unclamped* backtrace coordinate against a domain of ``n`` nodes."""
    under = raw_coord < 0
    over = raw_coord >= n - 1
    overshoot = jnp.where(under, -raw_coord, raw_coord - (n - 1))
    return jnp.where(
        under | over,
        jnp.where(overshoot < 0.5, 1.0 - 2.0 * overshoot, 0.0),
        1.0,
    )


def _backtrace_coords(vel: jax.Array, dt, sign=1.0):
    """source_k = idx_k - sign * vel_k * dt  (advect.h:81)."""
    nd = vel.shape[0]
    shape = vel.shape[1:]
    dtype = vel.dtype
    coords = []
    for k in range(nd):
        idx = jax.lax.broadcasted_iota(dtype, shape, k)
        coords.append(idx - sign * vel[k] * dt)
    return coords


def advect(field: jax.Array, vel: jax.Array, dt: float, no_slip: bool):
    """Advect ``field`` through ``vel`` for one step of ``dt``.

    Matches ``advect()`` at ``advect.h:74-85``: the velocity field advects
    itself with ``no_slip=True`` and dye with ``no_slip=False``
    (``.ino:253-254, 282``).
    """
    coords = _backtrace_coords(vel, dt)
    return sample_linear(field, coords, no_slip=no_slip)


def advect_rk2(field: jax.Array, vel: jax.Array, dt: float, no_slip: bool):
    """Second-order (midpoint) backtrace: sample the velocity at
    ``x - dt/2 * v(x)`` and trace the full step through it (Stam's original
    is forward-Euler along the characteristic; RK2 halves the trajectory
    error — cf. multi-stage semi-Lagrangian schemes, PAPERS.md).  Sampling
    semantics are identical to ``advect``."""
    nd = vel.shape[0]
    mid_coords = _backtrace_coords(vel, dt * 0.5)
    v_mid = sample_linear(vel, mid_coords, no_slip=False)
    shape = vel.shape[1:]
    dtype = vel.dtype
    coords = []
    for k in range(nd):
        idx = jax.lax.broadcasted_iota(dtype, shape, k)
        coords.append(idx - v_mid[k] * dt)
    return sample_linear(field, coords, no_slip=no_slip)


def advect_maccormack(field: jax.Array, vel: jax.Array, dt: float,
                      no_slip: bool):
    """Second-order MacCormack advection with monotonic clamp.

    Forward predictor, backward corrector, error-compensated result, clamped
    to the extrema of the interpolation stencil at the backtraced point so no
    new extrema are introduced (Selle et al. 2008).  New capability (BASELINE
    config 3) — absent from the reference, which is first-order semi-Lagrangian
    only.
    """
    fwd_coords = _backtrace_coords(vel, dt)
    phi_hat, cmin, cmax = sample_linear(field, fwd_coords, no_slip=no_slip,
                                        return_minmax=True)
    back_coords = _backtrace_coords(vel, dt, sign=-1.0)
    phi_back = sample_linear(phi_hat, back_coords, no_slip=no_slip)
    corrected = phi_hat + 0.5 * (field - phi_back)
    # The clamp bounds must include the predictor: the stencil extrema are
    # computed from UNdiscounted node values, so clamping to them alone would
    # undo the no-slip wall discount baked into phi_hat (clamp-to-stencil
    # would pull a discounted near-wall sample back up to the wall value).
    cmin = jnp.minimum(cmin, phi_hat)
    cmax = jnp.maximum(cmax, phi_hat)
    return jnp.clip(corrected, cmin, cmax)
