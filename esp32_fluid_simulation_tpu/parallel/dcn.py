"""Multi-host (DCN) leg of the communication backend (SURVEY §5).

The reference's comm backend is FreeRTOS queues + semaphores on shared SRAM
(``ESP32-fluid-simulation.ino:49,58-59``).  Scaled out, intra-step halo
traffic rides the device interconnect's collectives (``parallel/halo.py``);
when the device mesh spans MULTIPLE HOSTS the same ``shard_map`` program runs unchanged and XLA
routes the cross-process edges of each collective over DCN — the only new
ingredient is ``jax.distributed.initialize`` (multi-controller SPMD: every
process runs this same program and owns its local slice of every global
array).

This module makes that leg demonstrable WITHOUT a pod: ``run_dcn_dryrun``
spawns N coordinator-connected CPU processes (gloo TCP collectives — the
CPU stand-in for DCN), builds one global ``(batch, x, y)`` mesh spanning
all of them, runs the sharded fluid step for several steps, and asserts
each process's addressable shards match the single-device reference
trajectory bit-tightly.  The same worker code path is what a real
multi-host accelerator launch runs (swap the platform; drop the gloo
config).

Used by ``tests/test_dcn.py`` and ``__graft_entry__.dryrun_multichip``.
"""

from __future__ import annotations

import os
import subprocess
import sys


def dcn_worker_body(process_id: int, num_processes: int, port: int,
                    steps: int = 3) -> None:
    """Runs INSIDE each coordinator-connected process.

    Assumes ``jax.distributed.initialize`` has NOT yet run and the platform
    env (JAX_PLATFORMS=cpu + xla_force_host_platform_device_count) is set by
    the parent.  Builds the global mesh over all processes' devices, runs
    ``steps`` sharded fluid steps, and asserts this process's addressable
    shards equal the single-device trajectory (computed redundantly in
    every process — same program, same inputs, deterministic CPU numerics).
    """
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=num_processes,
                               process_id=process_id)

    import functools

    import numpy as np
    import jax.numpy as jnp  # noqa: F401

    from ..config import SimConfig
    from ..state import Impulses
    from ..models.stable_fluids import init_state, step
    from .topology import make_mesh
    from .sharded import make_sharded_step, sharded_state_sharding

    devs = jax.devices()
    n_local = len(jax.local_devices())
    assert len(devs) == num_processes * n_local, (len(devs), n_local)
    mesh = make_mesh(devs, batch=1)
    gx, gy = mesh.shape["x"], mesh.shape["y"]

    cfg = SimConfig(shape=(gx * 16, gy * 16), sor_iters=4)
    imp = Impulses.from_lists(
        cfg, [(cfg.shape[0] // 2, cfg.shape[1] // 2), (5, 7)],
        [(60.0, -40.0), (-30.0, 50.0)])

    # single-device reference trajectory, computed redundantly per process
    ref = init_state(cfg)
    ref_fn = jax.jit(functools.partial(step, cfg=cfg))
    for _ in range(steps):
        ref = ref_fn(ref, imp)
    ref_vel = np.asarray(ref.velocity)
    ref_col = np.asarray(ref.color, np.float32)

    # global sharded state: every leaf becomes a process-spanning global
    # array (each process materializes only its addressable shards)
    shardings = sharded_state_sharding(cfg, mesh)

    def globalize(x, sh):
        full = np.asarray(x)
        return jax.make_array_from_callback(full.shape, sh,
                                            lambda idx: full[idx])

    state = jax.tree.map(globalize, init_state(cfg), shardings)
    # impulses ride replicated (every process holds the same full copy)
    from jax.sharding import NamedSharding, PartitionSpec as P
    rep = NamedSharding(mesh, P())
    imp_g = jax.tree.map(functools.partial(globalize, sh=rep), imp)

    fn = make_sharded_step(cfg, mesh, max_disp=3, donate=False)
    for _ in range(steps):
        state = fn(state, imp_g)
    jax.block_until_ready(state.velocity)

    # each process checks ITS OWN shards against the reference slice — no
    # gather needed, and together the processes cover the whole domain
    def check(name, arr, want):
        worst = 0.0
        for s in arr.addressable_shards:
            got = np.asarray(s.data, np.float32)
            worst = max(worst, float(np.max(np.abs(
                got - want[s.index].astype(np.float32)))))
        assert worst < 1e-4, (name, worst)
        return worst

    wv = check("velocity", state.velocity, ref_vel)
    wc = check("color", state.color, ref_col)
    n_shards = len(state.velocity.addressable_shards)
    print(f"dcn proc {process_id}/{num_processes}: {steps} sharded steps "
          f"over a {gx}x{gy} mesh spanning {num_processes} processes OK "
          f"({n_shards} local shards; max|dvel|={wv:.2e}, "
          f"max|dcolor|={wc:.2e} vs single-device)", flush=True)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_dcn_dryrun(num_processes: int = 2, devices_per_process: int = 4,
                   port: int | None = None, steps: int = 3,
                   timeout: float = 600.0) -> str:
    """Spawn the multi-process mesh from a normal single-process session.

    Returns the concatenated child stdout (the per-process OK lines).
    Raises on any child failure with that child's output attached.
    """
    if port is None:
        port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if not f.startswith("--xla_force_host_platform_device_count"))
    env["XLA_FLAGS"] = (
        flags +
        f" --xla_force_host_platform_device_count={devices_per_process}"
    ).strip()
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")

    procs = []
    for pid in range(num_processes):
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "esp32_fluid_simulation_tpu.parallel.dcn",
             str(pid), str(num_processes), str(port), str(steps)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    fail = None
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            fail = fail or f"dcn child {pid} timed out:\n{out}"
            continue
        outs.append(out)
        if p.returncode != 0:
            fail = fail or (f"dcn child {pid} rc={p.returncode}:\n{out}")
    if fail:
        raise RuntimeError(fail)
    joined = "".join(outs)
    ok_lines = [ln for ln in joined.splitlines() if "sharded steps" in ln]
    if len(ok_lines) != num_processes:
        raise RuntimeError(f"expected {num_processes} OK lines, got "
                           f"{len(ok_lines)}:\n{joined}")
    return joined


if __name__ == "__main__":
    _pid, _np, _port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    _steps = int(sys.argv[4]) if len(sys.argv) > 4 else 3
    dcn_worker_body(_pid, _np, _port, steps=_steps)
