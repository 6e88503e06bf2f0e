"""Smoke run of the simulator's main path on an NVIDIA GPU.

Drives the entry points a user calls (``make_step``, ``make_step_render``,
the served shell, ``make_smoke_step``) at full width, compares each with a
plain reference, and prints timings, peak device memory and every error
beside its tolerance.  The last line of standard output is one JSON object
naming the device.  Exits non-zero, without that line, when JAX finds no
GPU or any phase fails.

  python chip_smoke.py          # phases 1-4 on one GPU
  python chip_smoke.py --four   # the sharded 8192^2 grid on four GPUs
"""

import argparse
import dataclasses
import functools
import json
import os
import socket
import sys
import threading
import time
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from esp32_fluid_simulation_tpu.utils.compile_cache import no_cache_writes
from esp32_fluid_simulation_tpu.utils.profiling import (compile_timed,
                                                        seconds_per_call)

# one bf16 ulp at the dye's unit scale: [0.5, 1) has ulp 2^-8.  Absolute,
# because the dye is a unit-range display quantity and relative ulps blow
# up near 0, where the two backends' backtrace fractions differ by a few
# f32 ulps.
DYE_TOL = 2.0 ** -8
# max |v - v_ref| / max |v_ref|.  The step has no matrix product, so TF32
# does not apply; the two compilers differ only in FMA contraction and
# summation order, which omega = 1.96 amplifies over 20 half-sweeps.
# 1e-4 leaves two orders of magnitude above that f32 drift.
VEL_TOL = 1e-4


def log(msg):
    print(msg, flush=True)


def check(name, value, tol):
    """Print ``value`` beside ``tol`` and fail unless ``0 <= value <= tol``."""
    ok = bool(np.isfinite(value)) and value <= tol
    log(f"  {name}: {value:.3e} (tolerance {tol:.3e}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name} = {value} exceeds {tol}")


def require(cond, what):
    log(f"  {what}: {'ok' if cond else 'FAILED'}")
    if not cond:
        raise AssertionError(what)


def timed_steps(name, fn, state, inputs, n, frame=False):
    """AOT-compile jitted ``fn`` for ``(state, *inputs[0])``, then time
    ``n`` calls ``state = fn(state, *inputs[t % len(inputs)])``; with
    ``frame`` ``fn`` returns ``(state, frame)``.  Returns the last output."""
    compiled, c_s = compile_timed(fn, state, *inputs[0])
    feed = (inputs[t % len(inputs)] for t in range(n))
    if frame:
        def one(c):
            return compiled(c[0], *next(feed))
        carry = (state, None)
    else:
        def one(c):
            return compiled(c, *next(feed))
        carry = state
    per, carry = seconds_per_call(one, carry, n, warmup=0)
    log(f"  {name}: compile {c_s:.2f} s, warm step {per * 1e3:.3f} ms "
        f"({n} steps in {per * n:.3f} s)")
    return carry


def peak_memory(tag):
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use after {tag}: "
        f"{stats.get('peak_bytes_in_use', 'not reported')}")


def host_impulses(cfg, n):
    """``n`` host-side (numpy) impulse batches of the scripted swirl."""
    from esp32_fluid_simulation_tpu.io_host.touch import scripted_swirl
    return [jax.tree_util.tree_map(np.asarray, scripted_swirl(cfg, t))
            for t in range(n)]


def compare_states(got, want, what):
    gv = np.asarray(got.velocity, np.float32)
    wv = np.asarray(want.velocity, np.float32)
    check(f"{what} velocity max|dv| / max|v|",
          float(np.max(np.abs(gv - wv)) / max(np.max(np.abs(wv)), 1e-30)),
          VEL_TOL)
    gc = np.asarray(got.color, np.float32)
    wc = np.asarray(want.color, np.float32)
    check(f"{what} dye max|d dye| (bf16 ulp at unit scale)",
          float(np.max(np.abs(gc - wc))), DYE_TOL)


# -- phase 1 ---------------------------------------------------------------
def phase_reference():
    """SimConfig() (61x81, 10 RB-SOR sweeps at omega 1.96) through
    make_step + render_rgb8(s=4), 90 scripted-swirl steps; 4 steps against
    the committed golden trajectory."""
    from esp32_fluid_simulation_tpu import (SimConfig, Impulses, init_state,
                                            make_step, render_rgb8)
    from esp32_fluid_simulation_tpu.io_host.touch import scripted_swirl
    log("phase 1: reference workload 61x81")
    cfg = SimConfig()
    imps = [scripted_swirl(cfg, t) for t in range(90)]
    state = timed_steps("step", make_step(cfg), init_state(cfg),
                        [(imp,) for imp in imps], len(imps))
    img = np.asarray(render_rgb8(state.color, s=4))
    col = np.asarray(state.color)
    require(img.shape == (3, 240, 320), f"frame shape {img.shape}")
    require(bool(np.isfinite(np.asarray(state.velocity)).all()
                 and np.isfinite(col).all()), "state finite")
    require(bool(col.min() >= 0.0 and col.max() <= 1.0),
            f"dye in [0, 1] (min {col.min():.4f}, max {col.max():.4f})")

    # tests/test_golden.py's schedule and tolerance (rtol 1e-4, atol 2e-4)
    with np.load(os.path.join(ROOT, "tests", "golden",
                              "ref_61x81_4steps.npz")) as z:
        want_v = np.moveaxis(z["velocity"], -1, 0)
        want_c = np.clip(np.moveaxis(z["color"], -1, 0), 0, 1)
    st = init_state(cfg)
    fn = make_step(cfg, donate=False)
    for t in range(4):
        sched = [((10 + t, 20), (120.0, -60.0)),
                 ((30, 40 + t), (-90.0, 150.0)), ((45, 60), (50.0, 50.0))]
        st = fn(st, Impulses.from_lists(cfg, [p for p, _ in sched],
                                        [v for _, v in sched]))
    for name, got, want in (("velocity", st.velocity, want_v),
                            ("dye", st.color, want_c)):
        err = np.abs(np.asarray(got) - want) / (2e-4 + 1e-4 * np.abs(want))
        check(f"golden {name} max |d| / (atol + rtol |want|)",
              float(err.max()), 1.0)
    peak_memory("phase 1")


# -- phase 2 ---------------------------------------------------------------
def phase_production(cfg):
    """The production grid: the GPU step against the same jitted step on
    the CPU, then make_step_render with a fresh host-side impulse batch
    uploaded every frame, at s=1 and at s=4."""
    from esp32_fluid_simulation_tpu import (init_state, make_step_render,
                                            render_rgb565)
    from esp32_fluid_simulation_tpu.models.stable_fluids import step
    h, w = cfg.shape
    log(f"phase 2: production grid {h}x{w}, dye {cfg.color_dtype}, "
        f"solver {cfg.solver}")
    imps = host_impulses(cfg, 8)

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    st_g = init_state(cfg)
    st_c = jax.device_put(st_g, cpu)
    step_fn = jax.jit(functools.partial(step, cfg=cfg))

    @jax.jit
    def cpu_reference_step(st, imp):
        return step(st, imp, cfg)

    for t in range(3):
        st_g = step_fn(st_g, jax.device_put(imps[t], gpu))
    with no_cache_writes():
        for t in range(3):
            st_c = cpu_reference_step(st_c, jax.device_put(imps[t], cpu))
    compare_states(st_g, st_c, "3 steps GPU vs CPU:")
    del st_g, st_c

    for s, n in ((1, 20), (4, 5)):
        cfg_s = dataclasses.replace(cfg, scaling=s)
        state, frame = timed_steps(
            f"step+render s={s}", make_step_render(cfg_s), init_state(cfg_s),
            [(imp,) for imp in imps], n, frame=True)
        require(frame.shape == ((h - 1) * s, (w - 1) * s)
                and frame.dtype == jnp.uint16,
                f"frame {frame.shape} {frame.dtype}")
        # an upscale pixel at a node is the node itself: the s=4 frame's
        # every 4th pixel is the s=1 render of the same dye, bit for bit
        ref = np.asarray(render_rgb565(state.color, s=1))
        got = np.asarray(frame[::s, ::s])
        require(bool(np.array_equal(got, ref)),
                f"s={s} frame at the nodes == render_rgb565(dye, s=1)")
        stride = max(1, h // 64)
        require(len(np.unique(ref[::stride, ::stride])) > 1,
                "frame not uniform")
        col = np.asarray(state.color, np.float32)
        require(bool(np.isfinite(np.asarray(state.velocity)).all()
                     and col.min() >= 0.0 and col.max() <= 1.0),
                "state finite, dye in [0, 1]")
        del state, frame
    peak_memory("phase 2")


# -- phase 3 ---------------------------------------------------------------
def _get(url, timeout=60.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.headers.get("Content-Type"), r.read()


def _stats(base):
    return json.loads(_get(base + "/stats")[1])


def _wait_for(pred, what, sim, deadline):
    """Poll ``pred()`` until true; fail on timeout or a stopped sim."""
    while not pred():
        if time.time() >= deadline or sim._stop.is_set():
            require(False, what)
        time.sleep(0.2)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_served(cfg):
    """io_host.server.serve in-process on the production config with a 4:1
    stream, driven over HTTP: drags in, a frame and the stats out."""
    from esp32_fluid_simulation_tpu.io_host.server import serve
    log(f"phase 3: served shell at {cfg.shape[0]}x{cfg.shape[1]}, "
        f"stream_decim 4")
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    sim, httpd = serve(cfg, port=port, fps=240.0, stream_decim=4)
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    try:
        deadline = time.time() + 600
        _wait_for(lambda: _stats(base)["steps"] >= 1, "sim thread stepping",
                  sim, deadline)
        log(f"  first step served {time.perf_counter() - t0:.2f} s after "
            f"start (compile included)")
        s0 = _stats(base)["steps"]
        for k in range(5):
            body = json.dumps({"from": [0.3 + 0.05 * k, 0.5],
                               "to": [0.35 + 0.05 * k, 0.55],
                               "ms": 16}).encode()
            req = urllib.request.Request(base + "/drag", data=body,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                require(r.status == 204, f"POST /drag {k} -> {r.status}")
        mime, frame = _get(base + "/frame")
        require(len(frame) > 0 and mime in ("image/jpeg",
                                            "image/x-portable-pixmap"),
                f"GET /frame: {len(frame)} bytes, {mime}")
        # a client fetching frames while the sim steps: the encoder's
        # device-to-host fetch runs beside the sim thread's dispatch
        watching = threading.Event()
        watching.set()

        def watch():
            while watching.is_set():
                _get(base + "/frame")

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        try:
            f0 = _stats(base)["frames_encoded"]
            _wait_for(lambda: _stats(base)["frames_encoded"] > f0,
                      "encoder serving the client", sim, deadline)
            a = _stats(base)
            _wait_for(lambda: (_stats(base)["frames_encoded"]
                               >= a["frames_encoded"] + 8
                               and _stats(base)["steps"] > a["steps"] + 64),
                      "8 frames encoded while the sim steps", sim, deadline)
            b = _stats(base)
        finally:
            watching.clear()
            watcher.join(timeout=30)
        log(f"  stats: steps {b['steps']}, sim_fps {b['sim_fps']}, "
            f"encode_fps {b['encode_fps']}, frames_encoded "
            f"{b['frames_encoded']}, frames_dropped {b['frames_dropped']}, "
            f"queue_dropped {b['queue_dropped']}")
        require(b["steps"] > s0 and b["sim_fps"] > 0,
                "steps advanced and sim_fps > 0")
        require(b["frames_encoded"] - a["frames_encoded"] >= 8
                and b["steps"] - a["steps"] > 64 and b["encode_fps"] > 0,
                f"{b['frames_encoded'] - a['frames_encoded']} frames encoded "
                f"for the client while the sim advanced "
                f"{b['steps'] - a['steps']} steps")
        log(f"  encoder: {b['encoder']}")
    finally:
        sim.stop()
        httpd.shutdown()
        httpd.server_close()
        http_thread.join(timeout=30)
    peak_memory("phase 3")


# -- phase 4 ---------------------------------------------------------------
def phase_plume(shape):
    """SmokeConfig(shape) through make_smoke_step: finite, and rising."""
    from esp32_fluid_simulation_tpu.models.smoke3d import (
        SmokeConfig, init_smoke, make_smoke_step)
    log(f"phase 4: 3D plume {shape}")
    cfg = SmokeConfig(shape=shape)
    st = timed_steps("smoke step", make_smoke_step(cfg), init_smoke(cfg),
                     [()], 30)
    rho = np.asarray(st.density, np.float32)
    v = np.asarray(st.velocity, np.float32)
    require(bool(np.isfinite(rho).all() and np.isfinite(v).all()),
            "state finite")
    # the source sphere's top is at axis-0 index (0.9 - 0.08) * D; smoke
    # must have risen above it (low indices are up) and move upward
    d = shape[0]
    src_top = int(0.9 * d - 0.08 * min(shape)) - 2
    require(float(rho[:src_top].sum()) > 0.0,
            f"smoke above the source (mass {float(rho[:src_top].sum()):.3f})")
    require(float((v[0] * rho).sum()) < 0.0, "net vertical motion is up")
    peak_memory("phase 4")


# -- --four ----------------------------------------------------------------
def phase_four(cfg, devices):
    """The sharded grid on a 2x2 mesh over four GPUs against the
    single-device step on the first of them."""
    from esp32_fluid_simulation_tpu import init_state
    from esp32_fluid_simulation_tpu.models.stable_fluids import step
    from esp32_fluid_simulation_tpu.parallel import (
        make_mesh, make_sharded_step, sharded_state_sharding)
    mesh = make_mesh(devices, batch=1)
    log(f"phase 5: sharded {cfg.shape[0]}x{cfg.shape[1]} on a "
        f"{mesh.shape['x']}x{mesh.shape['y']} mesh over {len(devices)} "
        f"devices")
    imps = host_impulses(cfg, 3)
    st0 = jax.device_put(init_state(cfg), devices[0])
    single = jax.jit(functools.partial(step, cfg=cfg))
    st_1 = st0
    for t in range(3):
        st_1 = single(st_1, jax.device_put(imps[t], devices[0]))
    sharded = make_sharded_step(cfg, mesh, donate=False)
    st_sh = jax.device_put(st0, sharded_state_sharding(cfg, mesh))
    t0 = time.perf_counter()
    for t in range(3):
        st_sh = sharded(st_sh, imps[t])
    jax.block_until_ready(st_sh)
    log(f"  first 3 sharded steps, compile and collective set-up "
        f"included: {time.perf_counter() - t0:.2f} s")
    compare_states(st_sh, st_1, "3 steps sharded vs single-device:")
    # already compiled: timed_steps' compile is a cache hit
    timed_steps("sharded step", sharded, st_sh, [(imp,) for imp in imps], 10)
    peak_memory("phase 5")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded 8192^2 grid on four GPUs "
                         "and its comparison")
    args = ap.parse_args(argv)

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(jax.devices()) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(jax.devices())}",
              file=sys.stderr)
        return 2

    from esp32_fluid_simulation_tpu import SimConfig
    from esp32_fluid_simulation_tpu.utils.compile_cache import (
        enable_compile_cache)
    from esp32_fluid_simulation_tpu.utils.device import (
        device_info, gpu_name_and_power_limit)

    enable_compile_cache()
    log(f"gpu: {gpu_name_and_power_limit()}")
    info = device_info()
    log(f"jax {jax.__version__}, devices: {info}")

    def example(name):
        with open(os.path.join(ROOT, "examples", name)) as f:
            return SimConfig.from_json(f.read())

    t_start = time.perf_counter()
    if args.four:
        phase_four(example("config5_8192_sharded.json"), jax.devices()[:4])
    else:
        production = example("config0_4096_production.json")
        phase_reference()
        phase_production(production)
        phase_served(production)
        phase_plume((256, 256, 256))
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
