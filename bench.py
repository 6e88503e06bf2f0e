"""Benchmark harness — prints ONE JSON line.

Headline metric: end-to-end sim+render frames/sec at 4096^2 on one GPU (the
production config, ``examples/config0_4096_production.json``; the
reference achieves 28-30 FPS at 80x60 on an ESP32, which is the
``vs_baseline`` denominator).  Extra rows ride in ``detail``: the
reference grid per frame and as a scan rollout, the 4x render, bf16
velocity, 8192^2, the SOR A/B, the config-2/3/4 workloads, us per RB-SOR
sweep and the 256^3 plume.  Each row is defined by its workload alone.

Timing: every row compiles and warms up first, then times a window of
steps that ends in ``block_until_ready``.  The output names the device it
ran on; without a GPU the bench exits non-zero.  ``BENCH_SMOKE=1`` is a
CPU rehearsal at tiny shapes whose output is labelled ``cpu``.
"""

import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

from esp32_fluid_simulation_tpu.utils.profiling import seconds_per_call


def _window(one, state, n):
    """Seconds per call of ``one(state) -> state`` over ``n`` calls, after
    one warm-up call (which compiles)."""
    return seconds_per_call(one, state, n)[0]


def bench_step_fps(cfg, n=20, render=False, render_s=1):
    from esp32_fluid_simulation_tpu import (init_state, make_step,
                                            make_step_render, render_rgb565)
    from esp32_fluid_simulation_tpu.io_host.touch import scripted_swirl

    # A rotating schedule of HOST-side (numpy) impulse batches: every frame
    # uploads a fresh batch through the jitted signature, exactly like a
    # real driver (run.py / the shell).  A single closed-over device batch
    # would be a trace-time constant — no per-step host->device transfer,
    # and the apply scatter partially foldable.
    imps = [jax.tree_util.tree_map(np.asarray, scripted_swirl(cfg, t))
            for t in range(8)]
    if render and render_s == cfg.scaling:
        fn = make_step_render(cfg, donate=False)
    else:
        step = make_step(cfg, donate=False)

        @jax.jit
        def fn(st, imp):
            # ONE device program per frame (the jitted step and render
            # inline into the outer jit).  The frame is a program OUTPUT:
            # consuming one pixel inside the program would let XLA
            # dead-code-eliminate the render down to that pixel.
            st = step(st, imp)
            if not render:
                return st, ()
            return st, render_rgb565(st.color, s=render_s)

    frame = [0]

    def one(carry):
        st, _ = fn(carry[0], imps[frame[0] % len(imps)])
        frame[0] += 1
        return st, _

    return 1.0 / _window(one, (init_state(cfg), ()), n)


def bench_ensemble_steps(n_members=256, shape=(256, 256), n=10):
    """BASELINE config 4: whole-ensemble steps/sec through the public
    batched step (member-stack layout at the API boundary)."""
    from esp32_fluid_simulation_tpu import SimConfig
    from esp32_fluid_simulation_tpu.models.ensemble import (
        init_ensemble, make_ensemble_step, stack_impulses)
    from esp32_fluid_simulation_tpu.io_host.touch import scripted_swirl

    cfg = SimConfig(shape=shape, scaling=1, color_dtype="bfloat16")
    fn = make_ensemble_step(cfg, donate=False)
    imp = stack_impulses([scripted_swirl(cfg, 7 * m)
                          for m in range(n_members)])
    return 1.0 / _window(lambda st: fn(st, imp),
                         init_ensemble(cfg, n_members), n)


def bench_smoke3d_steps(shape=(256, 256, 256), n=6, tuned=True):
    """BASELINE config 5 (3D half): smoke plume steps/sec on one device.

    ``tuned=False`` measures the pure-default ``SmokeConfig(shape=...)`` —
    the config a first-time user gets; the tuned row runs 6 SOR sweeps."""
    from esp32_fluid_simulation_tpu.models.smoke3d import (
        SmokeConfig, init_smoke, make_smoke_step)
    cfg = (SmokeConfig(shape=shape, solver="sor", sor_iters=6,
                       scalar_dtype="bfloat16")
           if tuned else SmokeConfig(shape=shape))
    fn = make_smoke_step(cfg, donate=False)
    st = init_smoke(cfg)
    for _ in range(2):
        st = fn(st)   # spin up the plume
    return 1.0 / _window(fn, st, n)


def bench_ref_scan_steps(n=300, rounds=3):
    """Reference-grid steps/sec via the scan-compiled multi-step runner."""
    from esp32_fluid_simulation_tpu import (SimConfig, init_state,
                                            make_multi_step, stack_schedule)
    from esp32_fluid_simulation_tpu.io_host.touch import scripted_swirl
    cfg = SimConfig()
    sched = stack_schedule([scripted_swirl(cfg, t) for t in range(n)])
    fn = make_multi_step(cfg, donate=False)
    return n / _window(lambda st: fn(st, sched), init_state(cfg), rounds)


def bench_ensemble_scan_steps(n_members=256, shape=(256, 256), n_steps=10,
                              rounds=3):
    """BASELINE config 4 through the public rollout API
    (``make_ensemble_multi_step``): member-stack layout at the boundary,
    supergrid inside the scan."""
    from esp32_fluid_simulation_tpu import SimConfig
    from esp32_fluid_simulation_tpu.models.ensemble import (
        init_ensemble, make_ensemble_multi_step, stack_impulses)
    from esp32_fluid_simulation_tpu.models.stable_fluids import stack_schedule
    from esp32_fluid_simulation_tpu.io_host.touch import scripted_swirl

    cfg = SimConfig(shape=shape, scaling=1, color_dtype="bfloat16")
    run = make_ensemble_multi_step(cfg, donate=False)
    sched = stack_schedule([
        stack_impulses([scripted_swirl(cfg, 7 * m + t)
                        for m in range(n_members)])
        for t in range(n_steps)])
    return n_steps / _window(lambda st: run(st, sched),
                             init_ensemble(cfg, n_members), rounds)


def bench_tiled_ensemble_steps(n_members=256, shape=(256, 256), n=10):
    """BASELINE config 4 on the tiled-domain supergrid (SimConfig
    .domain_tile) with the state kept in supergrid layout across steps.

    Forcing is IDENTICAL to ``bench_ensemble_steps`` (every member swirled
    each step), so the two rows differ only in state layout."""
    from esp32_fluid_simulation_tpu import SimConfig
    from esp32_fluid_simulation_tpu.models.stable_fluids import (
        init_state, _step_tiled)
    from esp32_fluid_simulation_tpu.models.ensemble import (
        tiled_ensemble_config, stack_impulses, _apply_member_impulses)
    from esp32_fluid_simulation_tpu.io_host.touch import scripted_swirl

    member = SimConfig(shape=shape, scaling=1, color_dtype="bfloat16")
    cfg, gh, gw = tiled_ensemble_config(member, n_members)
    h, w = shape
    imp = stack_impulses([scripted_swirl(member, 7 * m)
                          for m in range(n_members)])
    fn = jax.jit(lambda s: _step_tiled(
        s, None, cfg, apply_fn=lambda v: _apply_member_impulses(
            v, imp=imp, gh=gh, gw=gw, mh=h, mw=w)))
    return 1.0 / _window(fn, init_state(cfg), n)


def bench_sor_sweep_us(shape=(4097, 4097), iters=10, n=10):
    from esp32_fluid_simulation_tpu.ops.poisson import sor_solve
    fn = jax.jit(lambda x: sor_solve(x, 1.0, iters, 1.96))
    d = jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32)
    return _window(fn, d, n) / iters * 1e6


def main():
    from esp32_fluid_simulation_tpu import SimConfig
    from esp32_fluid_simulation_tpu.utils.compile_cache import (
        enable_compile_cache)
    from esp32_fluid_simulation_tpu.utils.device import (
        device_info, gpu_name_and_power_limit)

    # BENCH_SMOKE=1: tiny shapes on the CPU, a rehearsal of the mechanics;
    # its numbers are CPU numbers and are labelled so.
    smoke = os.environ.get("BENCH_SMOKE") == "1"
    if not smoke and jax.default_backend() != "gpu":
        print(f"bench: JAX found no GPU (backend {jax.default_backend()!r});"
              f" BENCH_SMOKE=1 runs the CPU rehearsal", file=sys.stderr)
        sys.exit(1)
    enable_compile_cache()
    info = device_info()
    card = None if smoke else gpu_name_and_power_limit()

    def sim(shape, **kw):
        return SimConfig(shape=(256, 256) if smoke else shape, **kw)

    n_ref, n_big = (5, 3) if smoke else (50, 10)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", "config0_4096_production.json")) as f:
        production = SimConfig.from_json(f.read())
    big = dict(scaling=1, color_dtype="bfloat16")   # the production knobs
    results = {}

    # Reference workload (BASELINE config 1): 61x81 + 4x upscale to 320x240,
    # per frame and as one scan-compiled rollout (schedule uploaded once).
    results["ref_80x60_fps"] = bench_step_fps(SimConfig(), n=n_ref,
                                              render=True, render_s=4)
    results["ref_80x60_scan_steps_per_s"] = bench_ref_scan_steps(
        n=20 if smoke else 300)

    # Headline: the production config, measured 3x to record the spread.
    head = sim(production.shape, **big)
    runs = [bench_step_fps(head, n=n_big, render=True, render_s=1)
            for _ in range(1 if smoke else 3)]
    results["fps_4096"] = max(runs)
    results["fps_4096_min"] = min(runs)
    # The reference renders at 4x upscale: the same grid at s=4 writes
    # 16384^2 RGB565.
    r4x = sim(production.shape, **{**big, "scaling": 4})
    r4 = [bench_step_fps(r4x, n=max(3, n_big // 2), render=True, render_s=4)
          for _ in range(1 if smoke else 3)]
    results["fps_4096_render4x"] = max(r4)
    results["fps_4096_render4x_min"] = min(r4)
    # bf16 velocity end-to-end (physics-parity configs keep f32)
    results["fps_4096_bf16vel"] = bench_step_fps(
        sim(production.shape, dtype="bfloat16", **big), n=n_big,
        render=True, render_s=1)

    # 8192^2 on one device (config 5's 2D grid), f32 and bf16 velocity
    results["fps_8192"] = bench_step_fps(
        sim((8192, 8192), **big), n=max(3, n_big // 2), render=True,
        render_s=1)
    results["fps_8192_bf16vel"] = bench_step_fps(
        sim((8192, 8192), dtype="bfloat16", **big), n=max(3, n_big // 2),
        render=True, render_s=1)

    # Residual-targeted solve: fixed 10 sweeps vs adaptive (tol 1e-3,
    # residual check every 2 sweeps, cap 20) at 1024^2.
    results["fps_1024_sor_fixed10"] = bench_step_fps(
        sim((1024, 1024), scaling=1, solver="sor", sor_iters=10), n=n_big)
    results["fps_1024_sor_adaptive"] = bench_step_fps(
        sim((1024, 1024), scaling=1, solver="sor_adaptive", sor_iters=20,
            sor_tol=1e-3), n=n_big)

    # Config 2: 512^2 with vorticity confinement; its A/B is Jacobi vs
    # RB-SOR projection.
    results["fps_512_vort"] = bench_step_fps(
        sim((512, 512), vorticity_eps=2.0), n=n_big)
    results["fps_512_vort_jacobi"] = bench_step_fps(
        sim((512, 512), vorticity_eps=2.0, solver="jacobi"), n=n_big)

    # Config 3: 2048^2 MacCormack advection + multigrid projection.
    results["fps_2048_mc_mg"] = bench_step_fps(
        sim((2048, 2048), advector="maccormack", solver="multigrid",
            omega=1.3, color_dtype="bfloat16", scaling=1),
        n=n_big, render=True, render_s=1)

    # Config 4: the ensemble through the batched step, on the tiled
    # supergrid with supergrid-layout state, and as a scan rollout.
    ens = dict(n_members=4 if smoke else 256,
               shape=(64, 64) if smoke else (256, 256))
    results["ensemble_steps_per_s"] = bench_ensemble_steps(
        n=3 if smoke else 10, **ens)
    results["ensemble_tiled_steps_per_s"] = bench_tiled_ensemble_steps(
        n=3 if smoke else 10, **ens)
    results["ensemble_scan_steps_per_s"] = bench_ensemble_scan_steps(
        n_steps=2 if smoke else 10, **ens)

    results["us_per_sor_sweep_4096"] = bench_sor_sweep_us(
        shape=(257, 257) if smoke else (4097, 4097), n=3 if smoke else 10)

    # Config 5's 3D half on one device: the 256^3 plume, tuned and default.
    shape3 = (32, 32, 32) if smoke else (256, 256, 256)
    results["smoke3d_256_steps_per_s"] = bench_smoke3d_steps(shape=shape3)
    results["smoke3d_256_default_steps_per_s"] = bench_smoke3d_steps(
        shape=shape3, tuned=False)

    fps = results["fps_4096"]
    stats = jax.devices()[0].memory_stats() or {}
    print(json.dumps({
        "metric": "sim+render FPS at 4096^2 (one device)",
        "value": fps,
        "unit": "frames/sec",
        "vs_baseline": fps / 30.0,  # reference: 28-30 FPS
        "detail": results,
        "device": info,
        "gpu": card,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }))


if __name__ == "__main__":
    main()
