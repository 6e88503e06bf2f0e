"""Roofline estimator: speed-of-light step time for a config on a device.

The simulation is HBM-bandwidth-bound (stencils and gathers do a handful of
flops per float); the roofline is therefore bytes-per-step / HBM bandwidth.
This module itemizes the per-step traffic of each stage of the composed
step (every op round-trips its operands through HBM) and converts to an
ideal FPS — the yardstick a measured stage time is divided into.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from ..config import SimConfig


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    hbm_bytes_per_s: float   # peak HBM bandwidth
    hbm_bytes: float         # device memory
    source: str


# Keyed by ``jax.devices()[0].device_kind``.  A device that is not listed
# is an error: dividing by another card's peak would be a wrong number.
DEVICE_SPECS = {
    "NVIDIA H100 80GB HBM3": DeviceSpec(
        hbm_bytes_per_s=3.35e12, hbm_bytes=80e9,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM5 part"),
}


def device_spec(device_kind: str) -> DeviceSpec:
    """Peak rates for ``device_kind``; raises ``KeyError`` if unknown."""
    try:
        return DEVICE_SPECS[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak rates recorded for device_kind {device_kind!r}; add "
            f"it to DEVICE_SPECS with its source") from None


def _bytes(cfg: SimConfig, channels: int = 1) -> int:
    n = 1
    for s in cfg.shape:
        n *= s
    itemsize = 2 if cfg.dtype == "bfloat16" else 4
    return n * channels * itemsize


def step_traffic_bytes(cfg: SimConfig) -> Dict[str, float]:
    """Estimated HBM bytes per composed step, itemized per stage."""
    nd = cfg.ndim
    vel = _bytes(cfg, nd)
    scal = _bytes(cfg, 1)
    col_item = 2 if cfg.color_dtype == "bfloat16" else 4
    col = _bytes(cfg, 3) * col_item // (2 if cfg.dtype == "bfloat16" else 4)

    t = {}
    # advect: gathers read ~4 corners amortized to ~2-3x, plus the write
    t["advect_vel"] = vel * 3 + vel
    t["advect_color"] = vel + col * 3 + col
    # divergence (r vel, w div) + 2*iters half-sweeps (r p,d; w p) + grad
    t["projection"] = (vel + scal) \
        + 2 * cfg.sor_iters * (3 * scal) + (vel + scal + vel)
    # render: read color (+ write uint16 pixels)
    px = 1
    for s in cfg.render_shape:
        px *= s
    t["render"] = col * 2.5 + px * 2
    return t


def speed_of_light(cfg: SimConfig, device_kind: str) -> Dict[str, float]:
    """Ideal step time / FPS on ``device_kind`` for this config."""
    spec = device_spec(device_kind)
    traffic = step_traffic_bytes(cfg)
    total = sum(traffic.values())
    ms = total / spec.hbm_bytes_per_s * 1e3
    return {
        "device_kind": device_kind,
        "bytes_per_step": total,
        "ideal_ms_per_step": ms,
        "ideal_fps": 1e3 / ms if ms > 0 else float("inf"),
        "per_stage_bytes": traffic,
    }
