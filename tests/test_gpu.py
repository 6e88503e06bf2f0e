"""Card-only tests: the compiled GPU program against the CPU one.

They skip without a GPU; on a machine with one run
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``."""

import functools

import numpy as np
import jax
import pytest

from esp32_fluid_simulation_tpu import SimConfig, init_state, render_rgb565
from esp32_fluid_simulation_tpu.models.stable_fluids import step
from esp32_fluid_simulation_tpu.io_host.touch import scripted_swirl


@pytest.mark.gpu
@pytest.mark.parametrize("color_dtype", ["float32", "bfloat16"])
def test_step_on_gpu_matches_cpu(gpu_device, color_dtype):
    cfg = SimConfig(shape=(256, 256), scaling=1, color_dtype=color_dtype)
    cpu = jax.devices("cpu")[0]
    fn = jax.jit(functools.partial(step, cfg=cfg))
    st_g = jax.device_put(init_state(cfg), gpu_device)
    st_c = jax.device_put(st_g, cpu)
    for t in range(3):
        imp = jax.tree_util.tree_map(np.asarray, scripted_swirl(cfg, t))
        st_g = fn(st_g, jax.device_put(imp, gpu_device))
        st_c = fn(st_c, jax.device_put(imp, cpu))
    vg, vc = np.asarray(st_g.velocity), np.asarray(st_c.velocity)
    assert np.abs(vg - vc).max() <= 1e-4 * np.abs(vc).max()
    cg = np.asarray(st_g.color, np.float32)
    cc = np.asarray(st_c.color, np.float32)
    assert np.abs(cg - cc).max() <= 2.0 ** -8
    np.testing.assert_array_equal(
        np.asarray(render_rgb565(jax.device_put(st_c.color, gpu_device),
                                 s=1)),
        np.asarray(render_rgb565(st_c.color, s=1)))
