"""Test harness config: force the CPU backend with 8 virtual devices so
sharding/halo-exchange tests run without a device mesh (SURVEY.md §4.3), and
keep numerics deterministic.  Must run before jax is imported anywhere."""

import os

# The suite runs on the CPU.  On a machine with a card,
# `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/` runs the
# card-only tests (marked `gpu`; they skip without a card).
if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX finds none."""
    import jax
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("card-only test: JAX found no GPU")
    return gpus[0]


# -- two-tier suite: `-m "not slow"` is the fast lane (~2-3 min signal);
# CI/full runs execute everything.  Centralized here instead of scattering
# markers (the list is tuned from `--durations` data; VERDICT r2 weak #7).
_SLOW = {
    ("test_models_extra.py", "test_smoke_bf16_scalars"),
    ("test_cli.py", "test_cli_checkpoint_resume"),
    ("test_cli.py", "test_cli_conflicting_flags_rejected"),
    ("test_cli.py", "test_cli_ensemble"),
    ("test_golden_paths.py", "test_path_matches_golden"),
    ("test_golden_paths.py", "test_smoke3d_matches_golden"),
    ("test_model.py", "test_solver_variants_agree_loosely"),
    ("test_models_extra.py", "test_checked_step_localizes_nan"),
    ("test_models_extra.py", "test_ensemble_members_independent"),
    ("test_models_extra.py", "test_ensemble_auto_tiled_matches_vmap"),
    ("test_models_extra.py", "test_smoke_divergence_controlled"),
    ("test_models_extra.py", "test_smoke_plume_rises"),
    ("test_multigrid.py", "test_multigrid_in_step"),
    ("test_parity.py", "test_full_step_parity"),
    ("test_parity.py", "test_fuzzed_step_parity"),
    ("test_parity.py", "test_projection_reduces_divergence"),
    ("test_sharded.py", "test_sharded_maccormack_matches_single_device"),
    ("test_sharded.py", "test_sharded_multigrid_matches_single_device"),
    ("test_sharded.py", "test_sharded_sor_halo_depths_exact"),
    ("test_sharded.py", "test_sharded_step_matches_single_device"),
    ("test_sharded.py", "test_sharded_vorticity_matches_single_device"),
    ("test_sharded_smoke.py", "test_sharded_smoke_matches_single_device"),
    ("test_sharded_smoke.py",
     "test_sharded_smoke_bf16_default_matches_single_device"),
    ("test_sharded_smoke.py",
     "test_sharded_smoke_multigrid_matches_single_device"),
    ("test_model.py", "test_maccormack_and_vorticity_step_runs"),
    ("test_model.py", "test_watchdog_detects_and_resets"),
    ("test_model.py", "test_step_donation_and_counter"),
    ("test_cli.py", "test_cli_watchdog"),
    ("test_cli.py", "test_cli_config_save_and_load"),
    ("test_cli.py", "test_cli_metrics_and_dumps"),
    ("test_cli.py", "test_cli_basic_run_and_frame"),
    ("test_multigrid.py", "test_multigrid_3d"),
    ("test_multigrid.py", "test_multigrid_beats_sor_at_equal_ish_work"),
    ("test_models_extra.py", "test_tiled_domain_matches_vmapped_members"),
    ("test_models_extra.py", "test_smoke_with_vorticity_confinement"),
    ("test_sharded_smoke.py", "test_sharded_smoke_vorticity_matches_single_device"),
    ("test_sharded.py", "test_sharded_jacobi_matches_single_device"),
    ("test_dcn.py", "test_two_process_mesh_matches_single_device"),
    ("test_sharded.py", "test_batched_spatial_mesh_runs"),
}

# whole files where every parity test is a multi-second CPU-mesh compile;
# keep only the cheap guard tests in the fast lane
_SLOW_FILES = {
    "test_sharded3d.py": {"test_sharded3d_rejects_unsupported"},
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.name.split("[")[0]
        fname = item.path.name if hasattr(item, "path") else ""
        fast_exempt = _SLOW_FILES.get(fname)
        if (fname, base) in _SLOW or (fast_exempt is not None
                                      and base not in fast_exempt):
            item.add_marker(pytest.mark.slow)
