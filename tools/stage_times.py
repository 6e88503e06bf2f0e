"""Time each stage of the plain (XLA-compiled) step on one GPU.

Every stage is jitted alone at the production width and timed over a
window of calls that ends in ``block_until_ready``, compilation outside the
window.  Bytes are computed from shapes: each input read once and each
output written once, except the projection, whose 2*iters red-black
half-sweeps each read p and div and write p (the composed traffic the
plain version moves; see ``utils/roofline.py``).  Achieved bandwidth is
bytes / time, beside the card's peak from ``utils/roofline.DEVICE_SPECS``
and a plain device-to-device copy measured in the same process.

  python tools/stage_times.py [--grid 4096] [--grid3d 256] [--out FILE.json]
"""

import argparse
import dataclasses
import functools
import json
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from esp32_fluid_simulation_tpu import (SimConfig, init_state, make_step,
                                        make_step_render)
from esp32_fluid_simulation_tpu.models.smoke3d import (SmokeConfig,
                                                       init_smoke,
                                                       make_smoke_step)
from esp32_fluid_simulation_tpu.models.stable_fluids import (_project,
                                                             apply_impulses)
from esp32_fluid_simulation_tpu.io_host.touch import scripted_swirl
from esp32_fluid_simulation_tpu.ops.advect import advect
from esp32_fluid_simulation_tpu.ops.poisson import sor_solve
from esp32_fluid_simulation_tpu.render import render_rgb565
from esp32_fluid_simulation_tpu.utils.compile_cache import (
    enable_compile_cache)
from esp32_fluid_simulation_tpu.utils.device import (
    device_info, gpu_name_and_power_limit)
from esp32_fluid_simulation_tpu.utils.profiling import (compile_timed,
                                                        seconds_per_call)
from esp32_fluid_simulation_tpu.utils.roofline import (device_spec,
                                                       step_traffic_bytes)


def time_call(fn, *args, n=20):
    """(compile s, seconds per call, compiled) of jitted ``fn`` over ``n``
    calls on the same arguments."""
    compiled, c_s = compile_timed(fn, *args)
    per, _ = seconds_per_call(lambda _: compiled(*args), None, n)
    return c_s, per, compiled


def entry_ops(compiled):
    """Opcodes of the ENTRY computation of the optimized HLO (what runs
    as kernels), without parameters, tuples and bitcasts."""
    text = compiled.as_text()
    entry = text[text.index("ENTRY"):]
    entry = entry[:entry.index("\n}")]
    ops = re.findall(r"=\s*\S+\s+([a-z\-]+)\(", entry)
    return [o for o in ops if o not in ("parameter", "tuple",
                                        "get-tuple-element", "bitcast")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=4096)
    ap.add_argument("--grid3d", type=int, default=256)
    ap.add_argument("--out", default=None,
                    help="also write the rows as JSON to this file")
    args = ap.parse_args(argv)
    if jax.default_backend() != "gpu":
        sys.exit(f"stage_times: JAX found no GPU "
                 f"(backend {jax.default_backend()!r})")
    enable_compile_cache()
    info = device_info()
    card = gpu_name_and_power_limit()
    peak = device_spec(info["kind"]).hbm_bytes_per_s
    print(f"gpu: {card}\ndevice: {info}", flush=True)

    n = args.grid
    cfg = dataclasses.replace(
        SimConfig.from_json(open(os.path.join(
            os.path.dirname(__file__), "..", "examples",
            "config0_4096_production.json")).read()),
        shape=(n, n))
    cells = n * n
    state = init_state(cfg)
    key = jax.random.PRNGKey(0)
    vel = 30.0 * jax.random.normal(key, (2, n, n), jnp.float32)
    dye = state.color
    imp = scripted_swirl(cfg, 3)
    div = jax.random.normal(key, (n, n), jnp.float32)
    vbytes, dbytes = 8 * cells, 6 * cells        # f32 x2, bf16 x3
    px4 = ((n - 1) * 4) ** 2

    rows = {}

    def row(name, fn, args_, nbytes, reps=20, show_ops=False):
        c_s, per, compiled = time_call(fn, *args_, n=reps)
        r = {"ms": per * 1e3, "compile_s": c_s, "bytes": nbytes,
             "achieved_gb_per_s": nbytes / per / 1e9,
             "share_of_peak": nbytes / per / peak}
        if show_ops:
            r["entry_ops"] = entry_ops(compiled)
        rows[name] = r
        print(f"{name}: {per * 1e3:.3f} ms, {nbytes / 1e6:.1f} MB, "
              f"{nbytes / per / 1e9:.1f} GB/s = "
              f"{100 * r['share_of_peak']:.1f}% of {peak / 1e12:.2f} TB/s, "
              f"compile {c_s:.2f} s"
              + (f", entry ops {r['entry_ops']}" if show_ops else ""),
              flush=True)

    big = jnp.zeros((4 * cells,), jnp.float32)
    row("copy_f32_x+1 (reference)", jax.jit(lambda x: x + 1.0), (big,),
        2 * 16 * cells)
    del big
    row("advect_velocity (2ch f32, no-slip)",
        jax.jit(lambda v: advect(v, v, cfg.dt, no_slip=True)), (vel,),
        2 * vbytes)
    row("impulse_scatter",
        jax.jit(apply_impulses), (vel, imp), 2 * vbytes)
    row("advect_dye (3ch bf16, clip)",
        jax.jit(lambda c, v: jnp.clip(advect(c, v, cfg.dt, no_slip=False),
                                      0.0, 1.0)),
        (dye, vel), vbytes + 2 * dbytes)
    proj_bytes = step_traffic_bytes(cfg)["projection"]
    row("projection (div -> 10 RB-SOR sweeps -> grad)",
        jax.jit(functools.partial(_project, cfg=cfg)), (vel,), proj_bytes)
    row("sor_solve (10 sweeps)",
        jax.jit(lambda d: sor_solve(d, cfg.dx, cfg.sor_iters, cfg.omega)),
        (div,), 2 * cfg.sor_iters * 3 * 4 * cells)
    row("render_rgb565 s=1",
        jax.jit(functools.partial(render_rgb565, s=1)),
        (dye,), dbytes + 2 * (n - 1) ** 2, show_ops=True)
    row("render_rgb565 s=4",
        jax.jit(functools.partial(render_rgb565, s=4)),
        (dye,), dbytes + 2 * px4, reps=10, show_ops=True)
    step_bytes = (2 * vbytes + 2 * vbytes + vbytes + 2 * dbytes + proj_bytes)
    row("step (make_step)", make_step(cfg, donate=False), (state, imp),
        step_bytes)
    row("step+render s=1 (make_step_render)",
        make_step_render(cfg, donate=False), (state, imp),
        step_bytes + dbytes + 2 * (n - 1) ** 2)
    del vel, dye, div, state

    m = args.grid3d
    scfg = SmokeConfig(shape=(m, m, m))
    sst = init_smoke(scfg)
    for _ in range(3):
        sst = make_smoke_step(scfg, donate=False)(sst)
    c3 = m ** 3
    # advect vel (r+w 3ch f32) and rho, temp (r+w bf16 each, r vel),
    # projection composed like 2D with a 3D velocity
    smoke_bytes = (2 * 12 * c3 + 2 * (12 * c3 + 4 * c3)
                   + (12 * c3 + 4 * c3) + 2 * scfg.sor_iters * 3 * 4 * c3
                   + (12 * c3 + 4 * c3 + 12 * c3))
    row(f"smoke3d step {m}^3 (make_smoke_step)",
        make_smoke_step(scfg, donate=False), (sst,), smoke_bytes, reps=10)

    stats = jax.devices()[0].memory_stats() or {}
    out = {"gpu": card, "device": info, "grid": n, "grid3d": m,
           "peak_hbm_bytes_per_s": peak, "stages": rows,
           "projection_share_of_step": (
               rows["projection (div -> 10 RB-SOR sweeps -> grad)"]["ms"]
               / rows["step (make_step)"]["ms"]),
           "peak_bytes_in_use": stats.get("peak_bytes_in_use")}
    print(f"projection share of the {n}^2 step: "
          f"{100 * out['projection_share_of_step']:.1f}%")
    print(f"peak_bytes_in_use: {out['peak_bytes_in_use']}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
