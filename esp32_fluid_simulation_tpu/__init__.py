"""esp32_fluid_simulation_tpu — a real-time fluid-simulation framework with
the capabilities of colonelwatch/ESP32-fluid-simulation, re-designed from
scratch for JAX/XLA on an accelerator.

Layer map (the accelerator rendition of SURVEY.md §1):

  L0  array conventions      channels-first float fields (``state.py``)
  L1  iteration runtime      XLA fusion + masked stencils
  L2  numerical ops          ``ops/`` (advect, fd, poisson, multigrid)
  L3  application runtime    ``models/`` step functions, ``render/``,
                             ``io_host/`` host pipeline, ``parallel/`` meshes
"""

from .config import SimConfig, reference_config
from .state import SimState, Impulses
from .models import (init_state, step, make_step, step_render,
                     make_step_render, make_step_with_metrics,
                     make_multi_step, stack_schedule)
from .render import render_rgb565, render_rgb8

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "reference_config",
    "SimState",
    "Impulses",
    "init_state",
    "step",
    "make_step",
    "step_render",
    "make_step_render",
    "make_step_with_metrics",
    "make_multi_step",
    "stack_schedule",
    "render_rgb565",
    "render_rgb8",
]
