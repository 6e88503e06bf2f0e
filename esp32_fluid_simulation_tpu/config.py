"""Simulation configuration.

The reference fixes every parameter at compile time with ``#define``s
(``ESP32-fluid-simulation.ino:14-41``): ``SCALING 4`` derives the grid
(``N_ROWS/N_COLS``, ``.ino:36-38``), ``DT (1/30.0f)`` (``.ino:16``), and the
solver parameters ``iters=10, omega=1.96`` are literals at the call site
(``.ino:275``).  The JAX equivalent is a frozen (hashable) dataclass
whose fields become *static* arguments of ``jax.jit`` — every distinct config
compiles one specialized XLA program, exactly like the reference's
compile-time specialization, but selectable at runtime.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import jax.numpy as jnp

# Reference constants (ESP32-fluid-simulation.ino:15-16, 24-26, 36-38).
REF_SCALING = 4
REF_SCREEN_HEIGHT = 240
REF_SCREEN_WIDTH = 320
REF_N_ROWS = REF_SCREEN_HEIGHT // REF_SCALING + 1  # 61 (incl. lerp endpoint)
REF_N_COLS = REF_SCREEN_WIDTH // REF_SCALING + 1   # 81
REF_DT = 1.0 / 30.0
REF_SOR_ITERS = 10
REF_SOR_OMEGA = 1.96

# Options that once selected a hand-written kernel.  The XLA-compiled ops
# are now the only implementation, so these names are refused with the
# replacement spelled out rather than silently mapped to another path.
REMOVED_FIELDS = {
    "advect_impl": "drop it: advection always runs the XLA-compiled op",
    "advect_max_disp": "drop it: the single-device advection has no CFL "
                       "clamp (the sharded step takes max_disp as an "
                       "argument of make_sharded_step)",
    "advect_sample_dtype": "drop it: store the dye as bfloat16 with "
                           "color_dtype instead",
}
REMOVED_SOLVERS = {
    "sor_pallas": "use solver='sor' (same red-black SOR)",
    "fused_pallas": "use solver='sor' (same divergence -> red-black SOR "
                    "-> gradient projection)",
}


def reject_removed_fields(fields, removed: dict) -> None:
    """Raise ``ValueError`` naming the replacement for a removed field."""
    for name in fields:
        if name in removed:
            raise ValueError(
                f"config field {name!r} was removed; {removed[name]}")


_DTYPES = {
    "float32": jnp.float32,
    "bfloat16": jnp.bfloat16,
    "float64": jnp.float64,
}


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation parameters (hashable; feeds ``jax.jit`` specialization).

    ``shape`` is the node-grid shape ``(H, W)`` for 2D or ``(D, H, W)`` for 3D.
    Axis 0 is the reference's ``i`` axis (bounded by ``dim_x = N_ROWS``) and
    axis 1 its ``j`` axis (``dim_y = N_COLS``); velocity channel 0 moves along
    axis 0, channel 1 along axis 1 (see ``vector.h`` / ``advect.h:81``).
    """

    shape: Tuple[int, ...] = (REF_N_ROWS, REF_N_COLS)
    dt: float = REF_DT
    dx: float = 1.0
    sor_iters: int = REF_SOR_ITERS
    omega: float = REF_SOR_OMEGA
    solver: str = "sor"          # sor | sor_adaptive | jacobi | multigrid
    # sor_adaptive (residual-targeted solve): early-exit once the residual
    # L2 drops below sor_tol, checking every sor_check_every sweeps;
    # sor_iters becomes the budget CAP instead of the fixed count.
    sor_tol: float = 1e-3
    sor_check_every: int = 2
    advector: str = "semilag"    # semilag | rk2 | maccormack
    vorticity_eps: float = 0.0   # >0 enables vorticity confinement
    dtype: str = "float32"       # compute dtype for fields
    color_dtype: str = "float32"  # dye storage dtype (bf16 halves HBM traffic)
    scaling: int = REF_SCALING   # render upscale factor
    max_impulses: int = 16       # static impulse-buffer length per step
    mg_levels: int = 0           # 0 = auto for multigrid solver
    mg_cycles: int = 2           # V-cycles per projection (multigrid solver)
    # Tiled-domain mode (BASELINE config 4 as one grid): the grid is a
    # supergrid of independent (mh, mw) member domains — every boundary
    # condition (advect clamps/no-slip, reflected-ghost divergence, Neumann
    # a_ii and zero-ghost sums, gradient clamp) acts per member tile.
    # None = one domain (the normal sim).
    domain_tile: Tuple[int, int] | None = None

    def __new__(cls, *args, **kwargs):
        # runs before the generated __init__, so a removed field name gets
        # its ValueError instead of the generic unexpected-keyword TypeError
        reject_removed_fields(kwargs, REMOVED_FIELDS)
        return super().__new__(cls)

    def __post_init__(self):
        if len(self.shape) not in (2, 3):
            raise ValueError(f"shape must be 2D or 3D, got {self.shape}")
        if self.solver in REMOVED_SOLVERS:
            raise ValueError(f"solver {self.solver!r} was removed; "
                             f"{REMOVED_SOLVERS[self.solver]}")
        if self.solver not in ("sor", "sor_adaptive", "jacobi", "multigrid"):
            raise ValueError(f"unknown solver {self.solver!r}")
        if self.advector not in ("semilag", "rk2", "maccormack"):
            raise ValueError(f"unknown advector {self.advector!r}")
        if self.dtype not in _DTYPES or self.color_dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}/{self.color_dtype!r}")
        if self.solver == "sor_adaptive" and (
                self.sor_check_every < 1 or self.sor_tol <= 0.0):
            raise ValueError(
                "sor_adaptive needs sor_check_every >= 1 and sor_tol > 0 "
                f"(got {self.sor_check_every}, {self.sor_tol}); "
                "check_every=0 would spin the on-device while_loop forever")
        if self.domain_tile is not None:
            object.__setattr__(self, "domain_tile",
                               tuple(self.domain_tile))
            if self.ndim != 2:
                raise ValueError("domain_tile requires a 2D grid")
            mh, mw = self.domain_tile
            if self.shape[0] % mh or self.shape[1] % mw:
                raise ValueError(
                    f"domain_tile {self.domain_tile} must divide the grid "
                    f"{self.shape}")
            if self.advector != "semilag" or self.solver not in (
                    "sor", "jacobi"):
                raise ValueError(
                    "domain_tile supports advector='semilag' with "
                    "solver='sor'/'jacobi'")
            if self.vorticity_eps > 0.0:
                raise ValueError("domain_tile does not support vorticity "
                                 "confinement yet")

    # -- derived -----------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def jdtype(self):
        return _DTYPES[self.dtype]

    @property
    def jcolor_dtype(self):
        return _DTYPES[self.color_dtype]

    @property
    def render_shape(self) -> Tuple[int, int]:
        """Pixel shape after upscale: the last node row/col are lerp endpoints
        only (``.ino:36-38,115``), so output is ``(H-1)*s × (W-1)*s``."""
        h, w = self.shape[-2], self.shape[-1]
        s = self.scaling
        return ((h - 1) * s, (w - 1) * s)

    @property
    def clamps_dye(self) -> bool:
        """True when ``step`` clamps the dye to [0, 1] every step (semilag /
        rk2 — see ``models.stable_fluids.step``), i.e. stepped color is
        always in range."""
        return self.advector in ("semilag", "rk2")

    # -- (de)serialization (the reference's off-device harness kept a
    #    ``sim_params.json``, ``.gitignore:8``) ---------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "SimConfig":
        d = json.loads(s)
        d["shape"] = tuple(d["shape"])
        return cls(**d)


def reference_config(**overrides) -> SimConfig:
    """The exact reference workload (BASELINE config 1)."""
    return SimConfig(**overrides)
