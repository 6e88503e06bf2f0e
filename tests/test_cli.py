"""CLI runner tests: config round-trip, checkpoints/resume, metrics, dumps,
watchdog — the reference author's dev-harness workflow (SURVEY.md §4)."""

import json
import os

import numpy as np
import pytest

from esp32_fluid_simulation_tpu.run import main as run_main
from esp32_fluid_simulation_tpu.utils.checkpoint import (load_checkpoint,
                                                         load_arr)


def test_cli_basic_run_and_frame(tmp_path, capsys):
    frame = str(tmp_path / "last.ppm")
    run_main(["--grid", "17", "25", "--steps", "5", "--frame", frame])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["final_step"] == 5
    assert os.path.getsize(frame) > 100


def test_cli_config_save_and_load(tmp_path, capsys):
    cfg_path = str(tmp_path / "sim_params.json")
    run_main(["--grid", "17", "25", "--solver", "jacobi", "--steps", "2",
              "--save-config", cfg_path])
    capsys.readouterr()
    run_main(["--config", cfg_path, "--steps", "2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["final_step"] == 2
    with open(cfg_path) as f:
        saved = json.load(f)
    assert saved["solver"] == "jacobi" and saved["shape"] == [17, 25]


def test_cli_checkpoint_resume(tmp_path, capsys):
    ck = str(tmp_path / "ckpt.npz")
    run_main(["--grid", "17", "25", "--steps", "6",
              "--checkpoint", ck, "--checkpoint-every", "3"])
    capsys.readouterr()
    state, cfg = load_checkpoint(ck)
    assert int(state.step) == 6
    run_main(["--resume", ck, "--steps", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["final_step"] == 10


def test_cli_metrics_and_dumps(tmp_path, capsys):
    mpath = str(tmp_path / "metrics.jsonl")
    dump = str(tmp_path / "fields")
    run_main(["--grid", "17", "25", "--steps", "6", "--metrics", mpath,
              "--metrics-every", "2", "--dump-fields", dump,
              "--dump-every", "3"])
    capsys.readouterr()
    rows = [json.loads(l) for l in open(mpath)]
    assert len(rows) == 3
    assert {"div_pre_max", "div_post_max", "poisson_residual_l2",
            "max_speed", "finite"} <= set(rows[0])
    assert all(r["finite"] for r in rows)
    v = load_arr(os.path.join(dump, "sim_velocity_000006.arr"))
    assert v.shape == (2, 17, 25) and np.isfinite(v).all()


def test_cli_watchdog(tmp_path, capsys):
    run_main(["--grid", "17", "25", "--steps", "4", "--watchdog"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["watchdog_resets"] == 0


def test_roofline_estimates():
    from esp32_fluid_simulation_tpu.utils.roofline import speed_of_light
    from esp32_fluid_simulation_tpu import SimConfig
    cfg = SimConfig(shape=(4096, 4096), scaling=1)
    h100 = speed_of_light(cfg, "NVIDIA H100 80GB HBM3")
    assert h100["ideal_fps"] > 60
    assert h100["bytes_per_step"] == sum(h100["per_stage_bytes"].values())
    # the projection's 2*iters half-sweeps dominate the composed traffic
    stages = h100["per_stage_bytes"]
    assert max(stages, key=stages.get) == "projection"
    bf16 = speed_of_light(SimConfig(shape=(4096, 4096), scaling=1,
                                    color_dtype="bfloat16"),
                          "NVIDIA H100 80GB HBM3")
    assert bf16["bytes_per_step"] < h100["bytes_per_step"]


def test_cli_conflicting_flags_rejected(tmp_path):
    import pytest
    ck = str(tmp_path / "c.npz")
    run_main(["--grid", "17", "25", "--steps", "2", "--checkpoint", ck,
              "--checkpoint-every", "2"])
    with pytest.raises(SystemExit):
        run_main(["--resume", ck, "--grid", "33", "41", "--steps", "1"])
    with pytest.raises(SystemExit):
        run_main(["--grid", "17", "25", "--steps", "1", "--watchdog",
                  "--metrics", str(tmp_path / "m.jsonl")])


def test_cli_ensemble(tmp_path, capsys):
    """BASELINE config 4 through the CLI: a vmapped ensemble run."""
    frame = str(tmp_path / "member0.ppm")
    run_main(["--grid", "17", "25", "--steps", "3", "--ensemble", "4",
              "--frame", frame])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["final_step"] == 3 and out["ensemble"] == 4
    assert os.path.getsize(frame) > 100


def test_cli_ensemble_rejects_incompatible_flags(tmp_path):
    import pytest
    with pytest.raises(SystemExit):
        run_main(["--grid", "17", "25", "--steps", "1", "--ensemble", "4",
                  "--watchdog"])


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3"])
def test_device_peak_table_known_kind(kind):
    from esp32_fluid_simulation_tpu.utils.roofline import device_spec
    spec = device_spec(kind)
    assert spec.hbm_bytes_per_s == 3.35e12 and spec.hbm_bytes == 80e9
    assert spec.source


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB"])
def test_device_peak_table_unknown_kind_raises(kind):
    from esp32_fluid_simulation_tpu import SimConfig
    from esp32_fluid_simulation_tpu.utils.roofline import speed_of_light
    with pytest.raises(KeyError, match="no peak rates"):
        speed_of_light(SimConfig(), kind)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    import jax
    from esp32_fluid_simulation_tpu.utils import compile_cache as cc
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert cc.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: the code sets no other directory
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    import jax
    from esp32_fluid_simulation_tpu.utils import compile_cache as cc
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cc.enable_compile_cache() == cc.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == cc.DEFAULT_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cc.DEFAULT_DIR == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_off_on_cpu(monkeypatch):
    import jax
    from esp32_fluid_simulation_tpu.utils import compile_cache as cc
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert jax.default_backend() == "cpu"
    assert cc.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_chip_scripts_refuse_cpu(script):
    """Without a GPU both exit non-zero and print no result line."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("BENCH_SMOKE", None)
    out = subprocess.run([sys.executable, script], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout and '"value"' not in out.stdout
