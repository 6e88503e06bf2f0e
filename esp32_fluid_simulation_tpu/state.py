"""Simulation state and impulse containers.

The reference keeps exactly two persistent fields — ``velocity_field``
(``Vector2<float>[N_COLS*N_ROWS]``, ``.ino:54``) and ``color_field``
(``Vector3<UQ32>``, ``.ino:55``); pressure and divergence are recomputed
every frame (``.ino:272-278``).  Here the state is a pytree threaded through
a pure ``step`` function: double-buffering, ``SWAP``, and the per-frame
``new[]``/``delete[]`` (``.ino:252-287``) all disappear behind XLA buffer
donation.

Layout is channels-first (``[C, H, W]``) so the trailing two axes are the
grid: contiguous rows of one channel rather than a size-2/3 trailing
channel axis.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import SimConfig


class SimState(NamedTuple):
    """Persistent per-frame state (a jax pytree).

    velocity: ``[ndim, *shape]`` — channel 0 along axis 0 (reference ``v.x``),
              channel 1 along axis 1 (``v.y``), channel 2 along axis 2 in 3D.
    color:    ``[3, *shape]`` dye RGB in [0, 1] (the reference's
              ``Vector3<UQ32>`` unit-scale fixed point, ``uq32.h:8-16``).
    step:     scalar int32 frame counter.
    """

    velocity: jax.Array
    color: jax.Array
    step: jax.Array


class Impulses(NamedTuple):
    """A fixed-length batch of velocity impulses (the drag queue reborn).

    The reference drains a 10-deep FreeRTOS queue of ``struct drag`` each
    frame and pokes single cells (``.ino:44-49, 264-269``).  Here the host
    passes a static-length array batch; inactive slots are masked.  ``pos``
    indices are in *sim* frame (axis-0 index, axis-1 index) — the graphics→sim
    x/y swap (``.ino:258-267``) happens in ``io_host.touch``.
    """

    pos: jax.Array       # int32 [K, ndim] cell indices
    velocity: jax.Array  # f32   [K, ndim] velocity to write (cells/s)
    active: jax.Array    # bool  [K]

    @classmethod
    def none(cls, cfg: SimConfig) -> "Impulses":
        k, nd = cfg.max_impulses, cfg.ndim
        return cls(
            pos=jnp.zeros((k, nd), jnp.int32),
            velocity=jnp.zeros((k, nd), cfg.jdtype),
            active=jnp.zeros((k,), jnp.bool_),
        )

    @classmethod
    def from_lists(cls, cfg: SimConfig, pos, vel) -> "Impulses":
        """Build a padded batch from python lists of (pos, velocity) tuples.

        Padding happens host-side in numpy: ``jnp.at[:n].set`` would
        jit-compile a fresh tiny program for every distinct ``n``, stalling
        an interactive first drag on a compile."""
        import numpy as np
        k, nd = cfg.max_impulses, cfg.ndim
        n = min(len(pos), k)
        p = np.zeros((k, nd), np.int32)
        v = np.zeros((k, nd), np.float32)   # cast to cfg.jdtype below
        a = np.zeros((k,), np.bool_)
        if n:
            p[:n] = np.asarray(pos[:n], np.int32)
            v[:n] = np.asarray(vel[:n])
            a[:n] = True
        return cls(pos=jnp.asarray(p), velocity=jnp.asarray(v, cfg.jdtype),
                   active=jnp.asarray(a))
