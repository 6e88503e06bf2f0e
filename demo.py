"""Headless demo: run the reference dye-bed workload with scripted swirls
and write frames (PPM/PNG + optional GIF) — the visual counterpart of the
CYD's 320x240 display.

Usage:
  python demo.py                       # 2D dye bed, 150 frames -> demo_out/
  python demo.py --grid 512 512 --frames 300 --out ./out
  python demo.py --smoke3d             # 3D plume, writes mid-slice frames
  python demo.py --pipeline            # exercise the native host pipeline
"""

import argparse
import os

import numpy as np


def save_ppm(path, rgb):
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(rgb.tobytes())


def maybe_gif(out_dir, frames, fps=30):
    try:
        from PIL import Image
    except ImportError:
        return None
    imgs = [Image.fromarray(f) for f in frames]
    path = os.path.join(out_dir, "demo.gif")
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    return path


def run_2d(args):
    import jax
    from esp32_fluid_simulation_tpu import (SimConfig, init_state, make_step,
                                            render_rgb8)
    from esp32_fluid_simulation_tpu.io_host.touch import scripted_swirl

    h, w = args.grid
    cfg = SimConfig(shape=(h, w), scaling=args.scaling)
    state = init_state(cfg)
    step = make_step(cfg)
    print(f"compiling the {h}x{w} step...", flush=True)
    frames = []
    for t in range(args.frames):
        state = step(state, scripted_swirl(cfg, t, speed=args.speed))
        if t % args.every == 0:
            img = np.moveaxis(np.asarray(render_rgb8(state.color,
                                                     s=cfg.scaling)), 0, -1)
            frames.append(img)
            save_ppm(os.path.join(args.out, f"frame_{t:05d}.ppm"), img)
            if t == 0:
                print("first frame written (compile done)", flush=True)
    gif = maybe_gif(args.out, frames)
    print(f"wrote {len(frames)} frames to {args.out}"
          + (f" (+ {gif})" if gif else ""))


def run_smoke(args):
    import jax
    from esp32_fluid_simulation_tpu.models.smoke3d import (SmokeConfig,
                                                           init_smoke,
                                                           make_smoke_step)
    from esp32_fluid_simulation_tpu.render import render_smoke
    cfg = SmokeConfig(shape=tuple(args.grid3d))
    st = init_smoke(cfg)
    fn = make_smoke_step(cfg)
    # on-device view: step + MIP/slice render in one program, only uint8
    # pixels leave the device (render.smoke; mode from --smoke-view)
    mode = args.smoke_view
    view = jax.jit(lambda rho: render_smoke(rho, mode=mode, axis=2,
                                            fmt="rgb8"))
    frames = []
    for t in range(args.frames):
        st = fn(st)
        if t % args.every == 0:
            rgb = np.asarray(view(st.density.astype(np.float32)))
            frames.append(rgb)
            save_ppm(os.path.join(args.out, f"smoke_{t:05d}.ppm"), rgb)
    gif = maybe_gif(args.out, frames, fps=15)
    print(f"wrote {len(frames)} smoke {mode} views to {args.out}"
          + (f" (+ {gif})" if gif else ""))


def run_pipeline(args):
    from esp32_fluid_simulation_tpu import SimConfig
    from esp32_fluid_simulation_tpu.io_host.pipeline import SimPipeline

    frames = []

    def sink(rgb, n):
        frames.append(rgb)
        save_ppm(os.path.join(args.out, f"pipe_{n:05d}.ppm"), rgb)

    cfg = SimConfig()
    pipe = SimPipeline(cfg, sink, fps=min(60.0, 1.0 / cfg.dt * 2))
    pipe.push_drag(30, 40, 200.0, -150.0)
    n = pipe.run(args.frames)
    print(f"pipeline delivered {n} frames to {args.out} "
          f"(queue drops: {pipe.queue.dropped})")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, nargs=2, default=[61, 81])
    ap.add_argument("--grid3d", type=int, nargs=3, default=[48, 40, 40])
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--every", type=int, default=3)
    ap.add_argument("--scaling", type=int, default=4)
    ap.add_argument("--speed", type=float, default=300.0)
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--smoke3d", action="store_true")
    ap.add_argument("--smoke-view", choices=["mip", "slice"], default="mip",
                    help="3D view reduction (render.smoke): max-intensity "
                         "projection or mid-slice")
    ap.add_argument("--pipeline", action="store_true")
    args = ap.parse_args()
    from esp32_fluid_simulation_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    os.makedirs(args.out, exist_ok=True)
    if args.smoke3d:
        run_smoke(args)
    elif args.pipeline:
        run_pipeline(args)
    else:
        run_2d(args)


if __name__ == "__main__":
    main()
