"""Preset registry + scene-matrix end-to-end smoke tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from libclsph_tpu.core.params import derive_parameters
from libclsph_tpu.core.state import init_state
from libclsph_tpu.engine.step import StepConfig, substep_jit
from libclsph_tpu.models.presets import (
    MUCUS,
    PRESETS,
    WATER,
    get_preset,
    simulation_config,
)
from libclsph_tpu.ops import collisions as C
from libclsph_tpu.scene.scene import Scene


class TestPresetRegistry:
    def test_all_presets_derive(self):
        for name, preset in PRESETS.items():
            p = preset.parameters()
            assert p.h > 0, name
            assert p.particles_count > 0

    def test_benchmark_matrix_covered(self):
        # the five scene x fluid workloads (+ the emitter-free
        # monkeybox stand-in kept for CLI-only runs)
        assert set(PRESETS) == {
            "dam-break-cube",
            "water-box-64k",
            "mucus-cone",
            "shower-monkey-256k",
            "monkeybox-256k",
            "river-1m",
        }
        # the shower workload is the shower.obj emitter onto monkey.obj
        assert PRESETS["shower-monkey-256k"].scene == "monkey.obj"
        assert "emitter_run" in PRESETS["shower-monkey-256k"].description

    def test_unknown_preset(self):
        with pytest.raises(KeyError):
            get_preset("nope")

    def test_preset_scenes_loadable(self):
        for name, preset in PRESETS.items():
            if preset.scene:
                p = preset.parameters()
                s = Scene.load(preset.scene, p.h * 2, scenes_dir="scenes")
                assert s.face_count > 0, name


def run_scene_steps(fluid, scene_name, n, steps=15):
    params = derive_parameters(
        dict(fluid), simulation_config(particles_count=n)
    )
    scene = Scene.load(scene_name, params.h * 2, scenes_dir="scenes")
    dev_scene = C.build_device_scene(scene)
    state = init_state(params)
    cfg = StepConfig(neighbor_impl="tiles")
    dt = jnp.float32(params.max_dt)
    for _ in range(steps):
        state, dt, ovf = substep_jit(state, dt, params, dev_scene, cfg)
    pos = np.asarray(state.position)
    rho = np.asarray(state.density)
    assert np.isfinite(pos).all()
    assert np.isfinite(rho).all() and rho.min() > 0
    return pos


class TestSceneMatrix:
    def test_mucus_cone(self):
        """Stiff-EOS high-viscosity fluid into the cone scene."""
        pos = run_scene_steps(MUCUS, "cone.obj", 512)
        assert pos[:, 1].min() > -3.0  # stays around the funnel

    def test_water_monkeybox(self):
        """Obstacle + container scene (mesh-collision heavy)."""
        pos = run_scene_steps(WATER, "monkeybox.obj", 512)
        assert np.abs(pos[:, 0]).max() < 3.0

    def test_water_river(self):
        pos = run_scene_steps(WATER, "river.obj", 256, steps=10)
        assert np.isfinite(pos).all()
