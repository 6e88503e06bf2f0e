"""Poisson pressure solvers: checkerboard red-black SOR, Jacobi, residuals.

Capability match for the reference's RB-SOR solver (``poisson.cpp``, 132 LoC),
re-designed for a data-parallel device.  The reference serializes a
checkerboard traversal with a ``goto``-driven two-color sweep
(``poisson.cpp:14-61``); the checkerboard
split exists precisely because all same-color updates are independent — i.e.
it is latent data parallelism.  Here each half-sweep is one vectorized masked
stencil update over the whole grid: the lanes the ESP32 walked serially run
in parallel on the device, and the black half-sweep reads the freshly-updated
red cells, preserving exact Gauss-Seidel red-black semantics (modulo float
reassociation; the test oracle pins this down).

Semantics reproduced exactly:

* pressure zero-initialized every solve (``poisson.cpp:117-119``);
* sweep = even-parity pass then odd-parity pass; the reference's first pass
  covers cells with ``(i+j) & 1 == 0`` (``poisson.cpp:10-12, 22-27`` with
  ``on_red=false`` first);
* Gauss-Seidel cell update with variable diagonal ``a_ii`` = number of
  in-bounds neighbors (2 corners / 3 edges / 4 interior in 2D), which encodes
  the Neumann pressure BC via the ``neg_a_ii_inv`` LUT (``poisson.cpp:63-90``)
  — here a precomputed ``-1/a_ii`` array (constant-folded under jit);
* SOR over-relaxation ``p <- (1-w)p + w*p_gs`` (``poisson.cpp:92-112``).

Rank-polymorphic: the same code solves 2D and 3D grids (a_ii up to 6).
Jacobi (order-free) is the A/B alternative (BASELINE config 2); a multigrid
preconditioner lives in ``multigrid.py`` (config 3).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def _shift_zero(p: jax.Array, axis: int, direction: int) -> jax.Array:
    """Neighbor value along ``axis`` with zero ghosts outside the domain."""
    n = p.shape[axis]
    zeros = jnp.zeros_like(jax.lax.slice_in_dim(p, 0, 1, axis=axis))
    if direction < 0:
        body = jax.lax.slice_in_dim(p, 0, n - 1, axis=axis)
        return jnp.concatenate([zeros, body], axis=axis)
    body = jax.lax.slice_in_dim(p, 1, n, axis=axis)
    return jnp.concatenate([body, zeros], axis=axis)


def neighbor_sum(p: jax.Array) -> jax.Array:
    """Sum of the 2*nd face neighbors, zero outside the domain, accumulated
    in the reference's order (axis0-lo, axis0-hi, axis1-lo, axis1-hi, ...;
    ``poisson.cpp:70-86, 107``)."""
    total = None
    for axis in range(p.ndim):
        for direction in (-1, 1):
            nb = _shift_zero(p, axis, direction)
            total = nb if total is None else total + nb
    return total


def _neighbor_count_np(shape) -> np.ndarray:
    a = np.zeros(shape, np.int32)
    for axis in range(len(shape)):
        ind = np.ones(shape[axis], np.int32) * 2
        ind[0] = 1
        ind[-1] = 1
        bshape = [1] * len(shape)
        bshape[axis] = shape[axis]
        a = a + ind.reshape(bshape)
    return a


def neighbor_count(shape, dtype=jnp.float32) -> jax.Array:
    """a_ii: number of in-bounds face neighbors per node (``poisson.cpp:71-86``).

    Computed with numpy at trace time — a compile-time constant, like the
    reference's LUT."""
    return jnp.asarray(_neighbor_count_np(shape), dtype)


def _neg_inv_diag(shape, dtype=jnp.float32) -> jax.Array:
    """-1/a_ii as an array, matching ``neg_a_ii_inv`` (``poisson.cpp:67``):
    the LUT entries are double divisions rounded to float."""
    a = _neighbor_count_np(shape)
    lut = (-1.0 / np.arange(1, 2 * len(shape) + 1, dtype=np.float64))
    neg_inv = lut[a - 1].astype(np.float32)
    return jnp.asarray(neg_inv, dtype)


def _parity(shape) -> jax.Array:
    """(i + j + ...) % 2 checkerboard parity (``poisson.cpp:10-12``)."""
    par = np.zeros(shape, np.int32)
    for axis in range(len(shape)):
        bshape = [1] * len(shape)
        bshape[axis] = shape[axis]
        par = par + np.arange(shape[axis], dtype=np.int32).reshape(bshape)
    return jnp.asarray(par % 2, jnp.int32)


def _gs_update(p, d, neg_inv, dx):
    """Gauss-Seidel value: neg_inv * (dx*d - nbr_sum) (``poisson.cpp:88-89``)."""
    return neg_inv * (jnp.asarray(dx, p.dtype) * d - neighbor_sum(p))


def sor_sweep(p: jax.Array, d: jax.Array, omega: float, dx: float = 1.0,
              neg_inv: jax.Array | None = None,
              parity: jax.Array | None = None) -> jax.Array:
    """One full red-black SOR sweep (even half then odd half)."""
    if neg_inv is None:
        neg_inv = _neg_inv_diag(p.shape, p.dtype)
    if parity is None:
        parity = _parity(p.shape)
    w = jnp.asarray(omega, p.dtype)
    one_m_w = jnp.asarray(1.0 - omega, p.dtype)
    for color in (0, 1):
        p_new = one_m_w * p + w * _gs_update(p, d, neg_inv, dx)
        p = jnp.where(parity == color, p_new, p)
    return p


def sor_solve(d: jax.Array, dx: float = 1.0, iters: int = 10,
              omega: float = 1.96, p0: jax.Array | None = None) -> jax.Array:
    """Solve lap(p) = d: matches ``poisson_solve`` (``poisson.cpp:114-125``)
    including the zero initialization."""
    p = jnp.zeros_like(d) if p0 is None else p0
    neg_inv = _neg_inv_diag(d.shape, d.dtype)
    parity = _parity(d.shape)
    for _ in range(iters):
        p = sor_sweep(p, d, omega, dx, neg_inv, parity)
    return p


def jacobi_solve(d: jax.Array, dx: float = 1.0, iters: int = 20,
                 omega: float = 1.0, p0: jax.Array | None = None) -> jax.Array:
    """Order-free (damped) Jacobi alternative — the A/B and correctness
    safety net for SOR (BASELINE config 2); absent from the reference."""
    p = jnp.zeros_like(d) if p0 is None else p0
    neg_inv = _neg_inv_diag(d.shape, d.dtype)
    w = jnp.asarray(omega, d.dtype)
    one_m_w = jnp.asarray(1.0 - omega, d.dtype)
    for _ in range(iters):
        p = one_m_w * p + w * _gs_update(p, d, neg_inv, dx)
    return p


def sor_solve_adaptive(d: jax.Array, dx: float = 1.0, max_iters: int = 50,
                       omega: float = 1.96, tol: float = 1e-3,
                       check_every: int = 2,
                       p0: jax.Array | None = None):
    """Residual-targeted RB-SOR: sweep in chunks of ``check_every`` and
    early-exit once the on-device residual L2 norm drops below ``tol``
    (VERDICT r4 next #9).

    The fixed-``iters`` solve (the reference hardcodes 10, ``.ino:275``)
    spends the same budget on a quiet fluid as on a violently forced one;
    this spends sweeps where the divergence actually is.  The loop is a
    ``lax.while_loop`` — one compiled program, no host round trips; the
    residual check costs one extra stencil pass per chunk (amortize with
    ``check_every``).  Returns ``(p, iters_done, residual_l2)`` so callers
    can log the adaptive behavior (``iters_done``/``residual_l2`` are
    traced scalars).
    """
    # check_every < 1 would run zero sweeps per iteration and spin the
    # while_loop forever on device (no host interrupt under jit)
    check_every = max(1, int(check_every))
    p = jnp.zeros_like(d) if p0 is None else p0
    neg_inv = _neg_inv_diag(d.shape, d.dtype)
    parity = _parity(d.shape)
    tol2 = jnp.asarray(tol, jnp.float32) ** 2

    def res2(p):
        r = poisson_residual(p, d, dx).astype(jnp.float32)
        return jnp.mean(r * r)

    def cond(carry):
        _, it, r2 = carry
        return (it < max_iters) & (r2 > tol2)

    def body(carry):
        p, it, _ = carry
        n = jnp.minimum(check_every, max_iters - it)
        # check_every is a static python int; run the chunk unrolled and
        # mask the tail sweeps (cheaper than a nested dynamic loop)
        for m in range(check_every):
            p_new = sor_sweep(p, d, omega, dx, neg_inv, parity)
            p = jnp.where(m < n, p_new, p)
        return p, it + n, res2(p)

    p, it, r2 = jax.lax.while_loop(cond, body, (p, jnp.int32(0), res2(p)))
    return p, it, jnp.sqrt(r2)


def poisson_residual(p: jax.Array, d: jax.Array, dx: float = 1.0) -> jax.Array:
    """Pointwise residual of the discrete system: nbr_sum - a_ii*p - dx*d
    (zero when p solves the reference's update equations exactly)."""
    a = neighbor_count(p.shape, p.dtype)
    return neighbor_sum(p) - a * p - jnp.asarray(dx, p.dtype) * d


def poisson_solve(d: jax.Array, cfg) -> jax.Array:
    """Solver dispatch by ``cfg.solver``."""
    if cfg.solver == "sor":
        return sor_solve(d, cfg.dx, cfg.sor_iters, cfg.omega)
    if cfg.solver == "sor_adaptive":
        p, _, _ = sor_solve_adaptive(d, cfg.dx, cfg.sor_iters, cfg.omega,
                                     tol=cfg.sor_tol,
                                     check_every=cfg.sor_check_every)
        return p
    if cfg.solver == "jacobi":
        # Jacobi diverges for omega > 1 (no Gauss-Seidel coupling to damp the
        # over-relaxation), so the SOR omega is capped at 1 here.
        return jacobi_solve(d, cfg.dx, cfg.sor_iters, min(cfg.omega, 1.0))
    if cfg.solver == "multigrid":
        from .multigrid import multigrid_solve
        return multigrid_solve(d, cfg.dx, cycles=cfg.mg_cycles,
                               levels=cfg.mg_levels, omega=cfg.omega)
    raise ValueError(f"unknown solver {cfg.solver!r}")
