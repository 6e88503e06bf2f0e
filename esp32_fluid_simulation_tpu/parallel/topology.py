"""Device-mesh topology helpers.

The reference's only "topology" is two ESP32 cores exchanging FreeRTOS
semaphores (``.ino:243-245``); the device equivalent of scaling the domain
is a ``jax.sharding.Mesh`` whose axes partition the grid, with XLA
collectives over the device interconnect doing the strip exchanges
(SURVEY.md §5 "long-context" analogue: halo exchange is the grid world's
ring attention).

Axis convention: mesh axes ``("batch", "x", "y")`` — ``batch`` for vmapped
ensembles (data parallel), ``x``/``y`` partition the trailing two spatial
axes of every field (spatial parallel).  Any axis may have size 1.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh


BATCH_AXIS = "batch"
X_AXIS = "x"
Y_AXIS = "y"


def grid_axes():
    return (X_AXIS, Y_AXIS)


def make_mesh(devices: Optional[Sequence] = None,
              batch: int = 1,
              grid_shape: Optional[tuple] = None) -> Mesh:
    """Build a ``(batch, x, y)`` mesh over ``devices``.

    If ``grid_shape`` is None, the non-batch devices are factored as close to
    square as possible (halo surface scales with perimeter).
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n % batch:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    spatial = n // batch
    if grid_shape is None:
        gx = int(math.sqrt(spatial))
        while spatial % gx:
            gx -= 1
        grid_shape = (gx, spatial // gx)
    gx, gy = grid_shape
    if batch * gx * gy != n:
        raise ValueError(f"batch*gx*gy={batch*gx*gy} != n_devices={n}")
    arr = np.asarray(devices).reshape(batch, gx, gy)
    return Mesh(arr, (BATCH_AXIS, X_AXIS, Y_AXIS))
