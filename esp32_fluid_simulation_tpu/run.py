"""Headless simulation runner — the reference author's off-device workflow
(compile kernels for PC, dump field arrays, inspect, profile;
``.gitignore:3-11``) made first-class.

Usage:
  python -m esp32_fluid_simulation_tpu.run --steps 300
  python -m esp32_fluid_simulation_tpu.run --config sim_params.json \\
      --metrics metrics.jsonl --checkpoint-every 100 --dump-fields out/
  python -m esp32_fluid_simulation_tpu.run --resume ckpt.npz --steps 100
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import jax

from .config import SimConfig
from .state import Impulses
from .models.stable_fluids import init_state
from .models import make_step, make_step_with_metrics
from .render import render_rgb8
from .io_host.touch import scripted_swirl
from .utils.compile_cache import enable_compile_cache
from .utils.checkpoint import save_checkpoint, load_checkpoint, dump_arr
from .utils.metrics import MetricsLogger, summarize
from .utils.watchdog import make_guarded_step


def build_parser():
    ap = argparse.ArgumentParser(prog="esp32_fluid_simulation_tpu.run")
    ap.add_argument("--config", help="SimConfig JSON file (sim_params.json)")
    ap.add_argument("--grid", type=int, nargs=2, help="override grid shape")
    ap.add_argument("--solver", help="override solver")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--impulses", choices=["swirl", "none"], default="swirl")
    ap.add_argument("--impulse-speed", type=float, default=300.0)
    ap.add_argument("--metrics", help="JSONL metrics output path")
    ap.add_argument("--metrics-every", type=int, default=10)
    ap.add_argument("--checkpoint", default="",
                    help="checkpoint path (default <dump>/ckpt.npz)")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", help="resume from checkpoint path")
    ap.add_argument("--dump-fields", help="directory for sim_*.arr dumps")
    ap.add_argument("--dump-every", type=int, default=0)
    ap.add_argument("--frame", help="write final rendered frame (PPM)")
    ap.add_argument("--watchdog", action="store_true",
                    help="auto-reset on NaN/Inf divergence")
    ap.add_argument("--save-config", help="write resolved config JSON")
    ap.add_argument("--ensemble", type=int, default=0,
                    help="vmap-batched ensemble of N members (BASELINE "
                         "config 4); members diverge via per-member impulse "
                         "phases; --frame renders member 0")
    return ap


def run_ensemble(args, cfg):
    """BASELINE config 4: N independent sims in one vmapped XLA program."""
    from .models.ensemble import (init_ensemble, make_ensemble_step,
                                  stack_impulses)
    n = args.ensemble
    state = init_ensemble(cfg, n)

    def member_imps(t):
        return stack_impulses(
            [scripted_swirl(cfg, t + 7 * m, speed=args.impulse_speed)
             if args.impulses == "swirl" else Impulses.none(cfg)
             for m in range(n)])

    if args.steps > 1:
        # scan rollout: whole schedule uploads once, layout conversion paid
        # once per call instead of per step
        from .models.ensemble import make_ensemble_multi_step
        from .models.stable_fluids import stack_schedule
        run_fn = make_ensemble_multi_step(cfg, donate=False)
        sched = stack_schedule([member_imps(t) for t in range(args.steps)])
        state = run_fn(state, sched)
    else:
        step_fn = make_ensemble_step(cfg, donate=False)
        for t in range(args.steps):
            state = step_fn(state, member_imps(t))
    jax.block_until_ready(state.velocity)
    if args.frame:
        img = np.moveaxis(np.asarray(render_rgb8(state.color[0],
                                                 s=cfg.scaling)), 0, -1)
        h, w, _ = img.shape
        with open(args.frame, "wb") as f:
            f.write(f"P6\n{w} {h}\n255\n".encode())
            f.write(img.tobytes())
    print(json.dumps({"steps_done": args.steps, "ensemble": n,
                      "final_step": int(state.step[0])}))


def main(argv=None):
    args = build_parser().parse_args(argv)
    enable_compile_cache()

    if args.resume:
        if args.grid or args.solver or args.config:
            raise SystemExit(
                "--resume restores the checkpointed config; it cannot be "
                "combined with --config/--grid/--solver (the state shape "
                "would no longer match)")
        state, cfg = load_checkpoint(args.resume)
        start = int(state.step)
    else:
        if args.config:
            with open(args.config) as f:
                cfg = SimConfig.from_json(f.read())
        else:
            cfg = SimConfig()
        overrides = {}
        if args.grid:
            overrides["shape"] = tuple(args.grid)
        if args.solver:
            overrides["solver"] = args.solver
        if overrides:
            import dataclasses
            cfg = dataclasses.replace(cfg, **overrides)
        state = init_state(cfg)
        start = 0

    if args.watchdog and args.metrics:
        raise SystemExit("--watchdog and --metrics are mutually exclusive "
                         "(the guarded step does not produce metrics)")
    if args.ensemble >= 1:  # --ensemble 1 is a 1-member ensemble, not a no-op
        if args.resume or args.watchdog or args.metrics or args.dump_fields \
                or args.checkpoint_every:
            raise SystemExit("--ensemble runs the batched step only (no "
                             "resume/watchdog/metrics/dumps)")
        return run_ensemble(args, cfg)
    if args.save_config:
        with open(args.save_config, "w") as f:
            f.write(cfg.to_json())

    want_metrics = bool(args.metrics)
    if args.watchdog:
        step_fn = make_guarded_step(cfg, donate=False)
    elif want_metrics:
        step_fn = make_step_with_metrics(cfg, donate=False)
    else:
        step_fn = make_step(cfg, donate=False)

    logger = MetricsLogger(args.metrics, every=args.metrics_every) \
        if want_metrics else None
    dump_dir = args.dump_fields
    if dump_dir:
        os.makedirs(dump_dir, exist_ok=True)
    ckpt_path = args.checkpoint or (
        os.path.join(dump_dir, "ckpt.npz") if dump_dir else "ckpt.npz")

    resets = 0
    for t in range(start, start + args.steps):
        imp = (scripted_swirl(cfg, t, speed=args.impulse_speed)
               if args.impulses == "swirl" else Impulses.none(cfg))
        if args.watchdog:
            state, was_reset = step_fn(state, imp)
            resets += int(was_reset)
        elif want_metrics:
            state, metrics = step_fn(state, imp)
            logger.log(t + 1, metrics)
        else:
            state = step_fn(state, imp)

        done = t + 1
        if args.checkpoint_every and done % args.checkpoint_every == 0:
            save_checkpoint(ckpt_path, state, cfg)
        if dump_dir and args.dump_every and done % args.dump_every == 0:
            dump_arr(os.path.join(dump_dir, f"sim_velocity_{done:06d}.arr"),
                     state.velocity)
            dump_arr(os.path.join(dump_dir, f"sim_color_{done:06d}.arr"),
                     state.color)

    jax.block_until_ready(state.velocity)
    if args.checkpoint_every:
        save_checkpoint(ckpt_path, state, cfg)
    if args.frame:
        img = np.moveaxis(np.asarray(render_rgb8(state.color,
                                                 s=cfg.scaling)), 0, -1)
        h, w, _ = img.shape
        with open(args.frame, "wb") as f:
            f.write(f"P6\n{w} {h}\n255\n".encode())
            f.write(img.tobytes())

    out = {"steps_done": args.steps, "final_step": int(state.step)}
    if args.watchdog:
        out["watchdog_resets"] = resets
    if logger:
        out["metrics"] = summarize(logger.history).get("last", {})
        logger.close()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
