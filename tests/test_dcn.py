"""Multi-host (DCN) communication-backend dryrun (SURVEY §5).

The sharded step's collectives must work when the mesh SPANS PROCESSES —
the CPU stand-in for a multi-host device mesh
(``jax.distributed.initialize`` + gloo TCP collectives standing in for
DCN).  The worker asserts numeric
parity of every process's addressable shards against the single-device
trajectory, so this pins the cross-process halo exchange end to end.

Subprocess-based: the coordinator + 2 workers cannot share this pytest
process (jax.distributed is once-per-process), so the test execs
``esp32_fluid_simulation_tpu.parallel.dcn`` children.
"""

from esp32_fluid_simulation_tpu.parallel.dcn import run_dcn_dryrun


def test_two_process_mesh_matches_single_device():
    out = run_dcn_dryrun(num_processes=2, devices_per_process=4, steps=3)
    ok = [ln for ln in out.splitlines() if "sharded steps" in ln]
    assert len(ok) == 2
    for ln in ok:
        assert "spanning 2 processes OK" in ln
