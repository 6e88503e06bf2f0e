"""Generate self-golden trajectories for the no-oracle paths.

MacCormack, RK2, vorticity confinement, multigrid and the 3D smoke plume
have no C++ arbiter (``advect.h``/``poisson.cpp`` cannot adjudicate them),
so a silent numerics drift would pass CI (VERDICT r2 missing #4).  These
goldens freeze each path's trajectory on the CPU backend — the same
backend CI runs on — so any change to their numerics fails
``tests/test_golden_paths.py`` until the golden is deliberately
regenerated.

Run from the repo root:  python tools/gen_golden_paths.py
"""

import os
import sys

import numpy as np  # noqa: E402
import jax  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from esp32_fluid_simulation_tpu import (SimConfig, Impulses, init_state,  # noqa: E402
                                        make_step)
from esp32_fluid_simulation_tpu.models.smoke3d import (SmokeConfig,  # noqa: E402
                                                       init_smoke,
                                                       make_smoke_step)

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "golden")
STEPS = 5


def schedule(cfg, t):
    return Impulses.from_lists(
        cfg,
        [(10 + t, 12), (30, 40 + t), (20, 55)],
        [(130.0, -70.0), (-80.0, 140.0), (60.0, 60.0)])


CONFIGS = {
    "maccormack": SimConfig(shape=(48, 64), advector="maccormack",
                            sor_iters=6),
    "rk2": SimConfig(shape=(48, 64), advector="rk2", sor_iters=6),
    "vorticity": SimConfig(shape=(48, 64), vorticity_eps=2.0, sor_iters=6),
    "multigrid": SimConfig(shape=(49, 65), solver="multigrid", omega=1.3),
}


def gen_2d(name, cfg):
    st = init_state(cfg)
    fn = make_step(cfg, donate=False)
    for t in range(STEPS):
        st = fn(st, schedule(cfg, t))
    np.savez_compressed(
        os.path.join(OUT, f"path_{name}.npz"),
        velocity=np.asarray(st.velocity),
        color=np.asarray(st.color, np.float32))
    print(f"{name}: |v|max={np.abs(np.asarray(st.velocity)).max():.4f}")


def gen_smoke():
    cfg = SmokeConfig(shape=(24, 24, 24), solver="multigrid", sor_iters=4)
    st = init_smoke(cfg)
    fn = make_smoke_step(cfg, donate=False)
    for _ in range(STEPS):
        st = fn(st)
    # scalars default to bfloat16 storage since r4 (b70f331) — save as
    # float32 (npz cannot hold ml_dtypes), exact cast, compared likewise
    np.savez_compressed(
        os.path.join(OUT, "path_smoke3d.npz"),
        velocity=np.asarray(st.velocity),
        density=np.asarray(st.density, np.float32),
        temperature=np.asarray(st.temperature, np.float32))
    print(f"smoke3d: rho_max={np.asarray(st.density, np.float32).max():.4f}")


def main():
    # Pin CPU only when RUN as a generator — at import time (the test module
    # shares CONFIGS/STEPS/schedule) this would silently force the whole
    # pytest process off the accelerator.  The goldens are CPU artifacts;
    # CI's conftest pins CPU for the comparison.
    jax.config.update("jax_platforms", "cpu")
    os.makedirs(OUT, exist_ok=True)
    for name, cfg in CONFIGS.items():
        gen_2d(name, cfg)
    gen_smoke()


if __name__ == "__main__":
    main()
