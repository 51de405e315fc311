"""Engine orchestration: frame loop, callbacks, checkpoint resume, CLI."""

import json
import os

import numpy as np
import pytest

from libclsph_tpu.engine.simulation import SPHSimulation
from libclsph_tpu.engine.step import StepConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_configs(tmp_path, n=512, sim_time=0.034, serialize=False, write_all=False):
    (tmp_path / "fluid_properties").mkdir(exist_ok=True)
    (tmp_path / "simulation_properties").mkdir(exist_ok=True)
    fluid = dict(
        fluid_density=998.29,
        dynamic_viscosity=3.5,
        restitution=0,
        k=100,
        surface_tension_threshold=7.065,
        surface_tension=0.0728,
        particles_inside_influence_radius=20,
    )
    sim = dict(
        particles_count=n,
        particle_mass=0.05,
        simulation_time=sim_time,
        target_fps=60,
        simulation_scale=0.1,
        write_all_frames=write_all,
        serialize=serialize,
        constant_acceleration=dict(x=0, y=-9.8, z=0),
    )
    fp = tmp_path / "fluid_properties" / "water.json"
    sp = tmp_path / "simulation_properties" / "test.json"
    fp.write_text(json.dumps(fluid))
    sp.write_text(json.dumps(sim))
    return str(fp), str(sp)


def make_sim(tmp_path, **kw):
    fp, sp = write_configs(tmp_path, **kw)
    sim = SPHSimulation(step_config=StepConfig(neighbor_impl="tiles"))
    sim.load_settings(fp, sp)
    sim.checkpoint_path = str(tmp_path / "last_frame.npz")
    return sim


class TestSimulation:
    def test_two_frames_with_callbacks(self, tmp_path):
        sim = make_sim(tmp_path, n=256, sim_time=0.034)
        events = []
        saved = []

        def pre(arrays, p, full):
            events.append(("pre", full))
            return False

        def save(arrays, p):
            saved.append(arrays["position"].copy())

        def post(arrays, p, full):
            events.append(("post", full))
            return False

        sim.pre_frame, sim.save_frame, sim.post_frame = pre, save, post
        sim.simulate()
        # 3 frames (0, 1/60, 2/60 < 0.034) + the initial save
        # (sph_simulation.cpp:370-372)
        assert len(saved) == 4
        assert events == [("pre", True), ("post", True)] * 3
        assert np.isfinite(saved[-1]).all()
        # fluid fell under gravity between frames
        assert saved[-1][:, 1].mean() < saved[0][:, 1].mean()

    def test_pre_frame_mutation_written_back(self, tmp_path):
        sim = make_sim(tmp_path, n=256, sim_time=0.017)
        sentinel = np.float32(123.456)

        def pre(arrays, p, full):
            arrays["velocity"][:] = 0.0
            arrays["position"][:, 0] += 0.001
            return True

        sim.pre_frame = pre
        sim.simulate()
        assert sim.state is not None

    def test_serialize_and_resume(self, tmp_path):
        sim = make_sim(tmp_path, n=256, sim_time=0.017, serialize=True)
        sim.save_frame = lambda arrays, p: None
        sim.simulate()
        assert os.path.exists(sim.checkpoint_path)
        final_pos = np.asarray(sim.state.position)

        # new simulation resumes from the checkpoint
        sim2 = make_sim(tmp_path, n=256, sim_time=0.017, serialize=True)
        state = sim2.init_particles()
        np.testing.assert_allclose(
            np.asarray(state.position), final_pos, rtol=1e-6
        )

    def test_stale_checkpoint_rejected(self, tmp_path):
        sim = make_sim(tmp_path, n=256, sim_time=0.017, serialize=True)
        sim.save_frame = lambda arrays, p: None
        sim.simulate()
        sim3 = make_sim(tmp_path, n=128, sim_time=0.017)
        with pytest.raises(RuntimeError):
            sim3.init_particles()

    def test_write_intermediate_frames_path(self, tmp_path):
        sim = make_sim(tmp_path, n=256, sim_time=0.017, write_all=True)
        saves = []
        sim.save_frame = lambda arrays, p: saves.append(1)
        sim.simulate()
        # initial save + one per substep: at least a few substeps/frame
        assert len(saves) >= 3


class TestCLI:
    def test_cli_end_to_end(self, tmp_path, monkeypatch):
        from libclsph_tpu import cli

        import shutil

        write_configs(tmp_path, n=256, sim_time=0.017)
        shutil.copytree(os.path.join(REPO, "scenes"), tmp_path / "scenes")
        monkeypatch.chdir(tmp_path)
        code = cli.main(
            [
                "water",
                "test",
                "cube",
                str(tmp_path) + "/out_",
                "--root",
                str(tmp_path),
            ]
        )
        assert code == 0
        frames = os.listdir(str(tmp_path) + "/out_frames")
        assert "frame0000001.geo" in frames

    def test_cli_bad_fluid(self, tmp_path, capsys):
        from libclsph_tpu import cli

        code = cli.main(["nope", "nope", "cube", "x_", "--root", str(tmp_path)])
        assert code == -1


class TestCLIMesh:
    def test_cli_mesh_run(self, tmp_path, monkeypatch):
        import shutil

        from libclsph_tpu import cli

        write_configs(tmp_path, n=256, sim_time=0.017)
        shutil.copytree(os.path.join(REPO, "scenes"), tmp_path / "scenes")
        monkeypatch.chdir(tmp_path)
        code = cli.main(
            [
                "water", "test", "cube", str(tmp_path) + "/m_",
                "--root", str(tmp_path),
                "--mesh", "8", "--block-size", "32", "--max-candidates", "48",
            ]
        )
        assert code == 0
        assert "frame0000001.geo" in os.listdir(str(tmp_path) + "/m_frames")

    def test_cli_mesh_too_many(self, tmp_path):
        from libclsph_tpu import cli

        write_configs(tmp_path, n=256)
        code = cli.main(
            ["water", "test", "cube", "x_", "--root", str(tmp_path), "--mesh", "99"]
        )
        assert code == -1


class TestCLILegacyImport:
    def test_import_legacy_checkpoint(self, tmp_path, monkeypatch):
        import shutil

        import numpy as np

        from libclsph_tpu import cli
        from libclsph_tpu.io.legacy import write_legacy_checkpoint

        write_configs(tmp_path, n=256, sim_time=0.017, serialize=True)
        shutil.copytree(os.path.join(REPO, "scenes"), tmp_path / "scenes")
        monkeypatch.chdir(tmp_path)

        # craft a reference-format checkpoint with a recognizable state
        rng = np.random.default_rng(5)
        pos = (rng.random((256, 3)).astype(np.float32) - 0.5) * 0.2
        pos[:, 1] += 0.8  # hover noticeably above the default lattice
        arrays = {
            "position": pos,
            "velocity": np.zeros((256, 3), np.float32),
            "intermediate_velocity": np.zeros((256, 3), np.float32),
            "acceleration": np.zeros((256, 3), np.float32),
            "density": np.full(256, 998.0, np.float32),
            "pressure": np.zeros(256, np.float32),
            "grid_index": np.zeros(256, np.uint32),
        }
        write_legacy_checkpoint(str(tmp_path / "last_frame.bin"), arrays)

        code = cli.main(
            [
                "water", "test", "cube", str(tmp_path) + "/L_",
                "--root", str(tmp_path),
                "--import-legacy", str(tmp_path / "last_frame.bin"),
            ]
        )
        assert code == 0
        # first saved frame = the imported state (mean y near 0.8)
        first = open(str(tmp_path) + "/L_frames/frame0000001.geo").read()
        ys = [float(l.split()[1]) for l in first.splitlines()[8 : 8 + 256]]
        assert 0.7 < sum(ys) / len(ys) < 0.9


class TestCapacityAutotune:
    def test_engine_recovers_from_overflow(self, tmp_path):
        """Start with a deliberately tiny candidate capacity: the engine
        must detect overflow, grow it, re-run the frame, and produce
        correct physics (same digest as a roomy-capacity run)."""
        sim = make_sim(tmp_path, n=512, sim_time=0.017)
        sim.step_config = StepConfig(neighbor_impl="tiles", max_candidates=2)
        sim.simulate()
        tight = np.asarray(sim.state.position)
        assert sim.capacity_retries >= 1  # it actually grew

        sim2 = make_sim(tmp_path, n=512, sim_time=0.017)
        sim2.step_config = StepConfig(neighbor_impl="tiles", max_candidates=64)
        sim2.simulate()
        roomy = np.asarray(sim2.state.position)

        order1 = np.lexsort(np.round(tight, 6).T)
        order2 = np.lexsort(np.round(roomy, 6).T)
        np.testing.assert_allclose(tight[order1], roomy[order2], atol=1e-5)

    def test_engine_gives_up_eventually(self, tmp_path):
        """Degenerate distributions terminate with a clear error, not an
        infinite grow loop."""
        from libclsph_tpu.engine.simulation import MAX_CAPACITY_RETRIES

        sim = make_sim(tmp_path, n=256, sim_time=0.017)
        sim.capacity_retries = MAX_CAPACITY_RETRIES + 1
        with pytest.raises(RuntimeError):
            sim._grow_capacity()


class TestSortInterval:
    """sort_interval > 1: skipped substeps reuse the previous Morton
    order; candidates are geometric so physics must be unchanged (up
    to f32 summation order)."""

    def _setup(self, n=512):
        import jax.numpy as jnp
        from tests.conftest import make_params
        from libclsph_tpu.core.state import init_state

        params = make_params(n=n)
        return params, init_state(params), jnp.float32(params.max_dt)

    @staticmethod
    def _by_pos(state):
        p = np.round(np.asarray(state.position, np.float64), 6)
        return np.lexsort(p.T)

    def test_frame_jit_matches_every_substep_sort(self):
        import jax.numpy as jnp
        from libclsph_tpu.engine.step import frame_jit

        params, state, dt = self._setup()
        timeleft = jnp.float32(4.5 * float(params.max_dt))
        base = StepConfig(neighbor_impl="tiles", block_size=64,
                          max_candidates=48)
        skip = StepConfig(neighbor_impl="tiles", block_size=64,
                          max_candidates=48, sort_interval=3)
        s1, _, tl1, f1 = frame_jit(state, dt, timeleft, params, None, base)
        s2, _, tl2, f2 = frame_jit(state, dt, timeleft, params, None, skip)
        assert int(f1) == 0 and int(f2) == 0
        assert float(tl1) == pytest.approx(float(tl2), abs=1e-7)
        o1, o2 = self._by_pos(s1), self._by_pos(s2)
        np.testing.assert_allclose(
            np.asarray(s1.position)[o1], np.asarray(s2.position)[o2],
            atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(s1.density)[o1], np.asarray(s2.density)[o2],
            rtol=1e-5,
        )

    def test_static_skip_matches_sorted(self):
        """One substep from an already-sorted state: do_sort=False must
        give the same physics as do_sort=True. Results differ only by
        the re-sort's permutation and f32 summation order."""
        from libclsph_tpu.engine.step import substep_jit

        params, state, dt = self._setup()
        cfg = StepConfig(neighbor_impl="tiles", block_size=64,
                         max_candidates=48)
        # first substep sorts; its output is Morton-ordered
        state, dt, _ = substep_jit(state, dt, params, None, cfg)
        s_a, dt_a, _ = substep_jit(state, dt, params, None, cfg,
                                   do_sort=True)
        s_b, dt_b, _ = substep_jit(state, dt, params, None, cfg,
                                   do_sort=False)
        o_a, o_b = self._by_pos(s_a), self._by_pos(s_b)
        np.testing.assert_allclose(
            np.asarray(s_a.position)[o_a], np.asarray(s_b.position)[o_b],
            atol=1e-6,
        )
        np.testing.assert_allclose(
            np.asarray(s_a.density)[o_a], np.asarray(s_b.density)[o_b],
            rtol=1e-5,
        )
        assert float(dt_a) == pytest.approx(float(dt_b), rel=1e-6)

    def test_exact_impl_rejected(self):
        from libclsph_tpu.engine.step import substep_jit

        params, state, dt = self._setup(n=256)
        cfg = StepConfig(neighbor_impl="exact")
        with pytest.raises(ValueError, match="sort skipping"):
            substep_jit(state, dt, params, None, cfg, do_sort=False)
