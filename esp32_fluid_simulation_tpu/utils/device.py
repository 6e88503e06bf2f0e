"""What the program runs on: the JAX device and, on a GPU, the card."""

from __future__ import annotations

import subprocess

import jax


def device_info() -> dict:
    """Platform, kind and count of the default backend's devices."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of each card, one line each, as nvidia-smi
    reports them (a card below its maximum limit runs slower under load,
    so every timing is reported beside this)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
