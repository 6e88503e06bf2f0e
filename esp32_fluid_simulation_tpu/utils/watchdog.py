"""Failure detection and elastic recovery.

The reference has none (crashes acknowledged in ``README.md:11``); SOR with
omega=1.96 can go unstable if forcing violates its assumptions.  Here: an
on-device finiteness check fused into the step, with ``lax.cond``-style recovery to the initial state on divergence — the
structural analogue of a supervisor restarting a crashed task.  Fault
injection (salting the state with NaN/Inf) is exercised in
``tests/test_model.py::test_watchdog_detects_and_resets``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import SimConfig
from ..state import SimState, Impulses
from ..models.stable_fluids import step, init_state


def make_guarded_step(cfg: SimConfig, donate: bool = True):
    """Jitted step that detects non-finite state after the update and resets
    to the initial condition (velocity zero, sector dye) in that case.

    Returns ``(new_state, was_reset: bool[])``.  The reset state is a traced
    constant (recomputed on device), so no host round-trip is involved.
    """
    fresh = init_state(cfg)

    def guarded(state: SimState, impulses: Impulses):
        new = step(state, impulses, cfg)
        ok = jnp.all(jnp.isfinite(new.velocity)) & jnp.all(
            jnp.isfinite(new.color))

        def keep(s):
            return s

        def reset(s):
            return SimState(velocity=jnp.zeros_like(s.velocity),
                            color=fresh.color.astype(s.color.dtype),
                            step=s.step)

        out = jax.lax.cond(ok, keep, reset, new)
        return out, ~ok

    return jax.jit(guarded, donate_argnums=(0,) if donate else ())
