"""Density / pressure / force passes vs the independent NumPy oracle,
for both neighbour backends, plus physical invariants."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libclsph_tpu.core.state import ParticleState
from libclsph_tpu.engine.step import StepConfig, substep_jit
from libclsph_tpu.ops import grid as grid_ops
from libclsph_tpu.ops import integrate as integrate_ops

from conftest import WATER, MUCUS, make_params
import oracle


def random_cloud(rng, params, n, spread=2.0):
    """A random blob scaled so particles have O(n_neighbors) neighbours."""
    side = (params.initial_volume) ** (1 / 3) * spread
    pos = (rng.random((n, 3)) - 0.5) * side
    vel = (rng.random((n, 3)) - 0.5) * 2.0
    return pos.astype(np.float32), vel.astype(np.float32)


def make_state(pos, vel):
    n = pos.shape[0]
    return ParticleState(
        position=jnp.asarray(pos),
        velocity=jnp.asarray(vel),
        intermediate_velocity=jnp.asarray(vel),
        acceleration=jnp.zeros((n, 3), jnp.float32),
        density=jnp.zeros((n,), jnp.float32),
        pressure=jnp.zeros((n,), jnp.float32),
        grid_index=jnp.zeros((n,), jnp.uint32),
    )


def run_density_forces(state, params, impl):
    """Drive one substep with dt tiny and adaptive off; recover the
    density/pressure/accel the pass computed."""
    cfg = StepConfig(neighbor_impl=impl, adaptive_dt=False)
    out, _, overflow = substep_jit(state, jnp.float32(1e-9), params, None, cfg)
    assert not bool(overflow), "neighbour capacity overflow in test setup"
    return out


def match_order(pos):
    """Permutation that orders rows by (quantized) position.

    Quantising before lexsort keeps tie-breaking stable between the
    pre-step positions and positions advected by the 1e-9 dummy dt
    (which can turn an exact 0.0 into -1e-24 and flip sort order).
    """
    import numpy as _np

    q = _np.round(_np.asarray(pos, dtype=_np.float64), 6)
    return _np.lexsort(q.T)


def oracle_density_forces(pos, vel, params):
    rho, p = oracle.density_pressure(
        pos.astype(np.float64),
        params.particle_mass,
        params.h,
        params.fluid_density,
        params.K,
    )
    acc = oracle.accelerations(
        pos.astype(np.float64),
        vel.astype(np.float64),
        rho,
        p,
        params.particle_mass,
        params.h,
        params.dynamic_viscosity,
        params.surface_tension,
        params.surface_tension_threshold,
        np.asarray(params.constant_acceleration),
    )
    return rho, p, acc


@pytest.mark.parametrize("impl", ["exact", "tiles"])
@pytest.mark.parametrize("fluid", [WATER, MUCUS])
def test_density_forces_match_oracle(rng, impl, fluid):
    params = make_params(fluid, n=300)
    pos, vel = random_cloud(rng, params, 300)
    state = make_state(pos, vel)

    out = run_density_forces(state, params, impl)
    rho_o, p_o, acc_o = oracle_density_forces(pos, vel, params)

    # substep sorted the particles — match rows via position ordering
    order_sim = match_order(out.position)
    # positions moved by <= |v|*1e-9; sort original positions identically
    order_ref = match_order(pos)

    rho_sim = np.asarray(out.density)[order_sim]
    rho_ref = rho_o[order_ref]
    rms = np.sqrt(np.mean((rho_sim - rho_ref) ** 2)) / np.mean(rho_ref)
    assert rms < 1e-4, f"density RMS err {rms}"

    p_sim = np.asarray(out.pressure)[order_sim]
    np.testing.assert_allclose(p_sim, p_o[order_ref], rtol=5e-3, atol=1e-3)

    acc_sim = np.asarray(out.acceleration)[order_sim]
    acc_ref = acc_o[order_ref]
    scale = np.abs(acc_ref).max()
    np.testing.assert_allclose(acc_sim, acc_ref, atol=2e-3 * scale)


@pytest.mark.parametrize("impl", ["exact", "tiles"])
def test_lattice_density_forces_match_oracle(impl):
    # The structured (degenerate-geometry) case: the init lattice, with
    # many exactly-equal distances and particles on cell boundaries.
    params = make_params(WATER, n=216)
    from libclsph_tpu.core.state import init_state

    state = init_state(params)
    pos = np.asarray(state.position)
    vel = np.zeros_like(pos)

    out = run_density_forces(state, params, impl)
    rho_o, p_o, acc_o = oracle_density_forces(pos, vel, params)

    order_sim = match_order(out.position)
    order_ref = match_order(pos)
    rho_sim = np.asarray(out.density)[order_sim]
    rho_ref = rho_o[order_ref]
    rms = np.sqrt(np.mean((rho_sim - rho_ref) ** 2)) / np.mean(rho_ref)
    assert rms < 1e-4


def test_exact_vs_tiles_identical(rng):
    params = make_params(WATER, n=2000)
    pos, vel = random_cloud(rng, params, 2000)
    state = make_state(pos, vel)
    out_e = run_density_forces(state, params, "exact")
    out_t = run_density_forces(state, params, "tiles")
    order_e = match_order(out_e.position)
    order_t = match_order(out_t.position)
    np.testing.assert_allclose(
        np.asarray(out_e.density)[order_e],
        np.asarray(out_t.density)[order_t],
        rtol=2e-6,
    )
    acc_e = np.asarray(out_e.acceleration)[order_e]
    acc_t = np.asarray(out_t.acceleration)[order_t]
    scale = np.abs(acc_e).max()
    np.testing.assert_allclose(acc_e, acc_t, atol=1e-5 * scale)


class TestGrid:
    def test_sorted_cell_ranges_cover_all(self, rng, water_params):
        pos = (rng.random((500, 3)).astype(np.float32) - 0.5) * 3
        grid = grid_ops.compute_bounds(jnp.asarray(pos), water_params)
        codes = grid_ops.locate_in_grid(jnp.asarray(pos), grid)
        sorted_codes = jnp.sort(codes)
        start, end = grid_ops.cell_ranges(sorted_codes, sorted_codes)
        counts = np.asarray(end - start)
        # every particle's own cell range contains it
        assert (counts >= 1).all()
        # total unique coverage equals N
        u, c = np.unique(np.asarray(sorted_codes), return_counts=True)
        s2, e2 = grid_ops.cell_ranges(sorted_codes, jnp.asarray(u))
        np.testing.assert_array_equal(np.asarray(e2 - s2), c)

    def test_bounds_padding(self, water_params):
        pos = jnp.asarray([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0]], jnp.float32)
        g = grid_ops.compute_bounds(pos, water_params)
        cell = water_params.cell_side
        np.testing.assert_allclose(
            np.asarray(g.min_point), [0 - 2 * cell, 0 - 2 * cell, 0 - 2 * cell],
            rtol=1e-6,
        )
        np.testing.assert_allclose(
            np.asarray(g.max_point), [1 + 2 * cell, 2 + 2 * cell, 3 + 2 * cell],
            rtol=1e-6,
        )
        # particles never land in coord 0 cells (reference relies on this)
        codes = grid_ops.locate_in_grid(pos, g)
        from libclsph_tpu.core import morton

        x, y, z = morton.decode(codes)
        assert (np.asarray(x) >= 1).all()


class TestIntegrate:
    def test_leapfrog_matches_oracle(self, rng):
        pos = rng.random((10, 3))
        vin = rng.random((10, 3))
        acc = rng.random((10, 3))
        dt = 0.01
        adv = integrate_ops.advect(
            jnp.asarray(pos, jnp.float32),
            jnp.asarray(vin, jnp.float32),
            jnp.asarray(acc, jnp.float32),
            jnp.float32(dt),
        )
        vel, inter = integrate_ops.reconstruct_velocities(
            jnp.asarray(vin, jnp.float32), adv.next_velocity
        )
        o_pos, o_vel, o_next = oracle.leapfrog(pos, vin, acc, dt)
        np.testing.assert_allclose(np.asarray(adv.new_position), o_pos, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(vel), o_vel, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(inter), o_next, rtol=1e-5)

    def test_time_step_matches_oracle(self, rng, water_params):
        vel = rng.random((50, 3)) * 3
        acc = rng.random((50, 3)) * 20
        dt = integrate_ops.compute_time_step(
            jnp.asarray(vel, jnp.float32),
            jnp.asarray(acc, jnp.float32),
            water_params,
        )
        o = oracle.time_step(
            vel, acc, water_params.h, integrate_ops.DT_MIN, water_params.max_dt
        )
        assert float(dt) == pytest.approx(o, rel=1e-4)

    def test_time_step_clamps(self, water_params):
        # huge accel -> floor; zero accel/vel -> ceiling
        dt_lo = integrate_ops.compute_time_step(
            jnp.zeros((1, 3)), jnp.full((1, 3), 1e12), water_params
        )
        assert float(dt_lo) == pytest.approx(integrate_ops.DT_MIN)
        dt_hi = integrate_ops.compute_time_step(
            jnp.zeros((1, 3)), jnp.zeros((1, 3)), water_params
        )
        assert float(dt_hi) == pytest.approx(water_params.max_dt)


class TestInvariants:
    def test_momentum_conservation_no_gravity(self, rng):
        """Pressure+viscosity are antisymmetric pairwise: with gravity
        and surface tension off, total momentum change is ~0."""
        params = make_params(
            dict(WATER, surface_tension=0.0),
            n=500,
            constant_acceleration=dict(x=0, y=0, z=0),
        )
        pos, vel = random_cloud(rng, params, 500)
        state = make_state(pos, vel)
        out = run_density_forces(state, params, "tiles")
        acc = np.asarray(out.acceleration, dtype=np.float64)
        rho = np.asarray(out.density, dtype=np.float64)
        # force_i = m * acc_i (equal masses): sum of forces ~ 0
        total_f = (acc * params.particle_mass).sum(axis=0)
        scale = np.abs(acc * params.particle_mass).sum(axis=0).max()
        assert np.abs(total_f).max() < 1e-3 * scale

    def test_rest_density_near_reference(self):
        """A big uniform lattice interior should sit near rho0 by
        construction of h (n_neighbors inside the support radius)."""
        params = make_params(WATER, n=4096)
        from libclsph_tpu.core.state import init_state

        state = init_state(params)
        out = run_density_forces(state, params, "tiles")
        rho = np.asarray(out.density)
        # interior particles: top quartile of density
        interior = np.quantile(rho, 0.9)
        assert 0.5 * params.fluid_density < interior < 1.5 * params.fluid_density


class TestHierarchicalCandidates:
    def test_matches_dense(self, rng):
        """Two-level candidate search covers the dense search's
        candidate sets. Since its level 2 tests member-UNION boxes
        (the flat 128-lane refine pack holds one lo/hi per member
        block, not the 4 split boxes), it may add a few conservative
        extras — supersets never change the physics (kernel cutoffs
        zero them, and the subblock refine stage prunes most before
        the kernels); the inflation must stay small."""
        from libclsph_tpu.ops import tiles as T
        from libclsph_tpu.core.state import init_state

        params = make_params(WATER, n=64 * 64)
        state = init_state(params)
        # jiggle so blocks aren't degenerate
        pos = np.asarray(state.position) + rng.normal(0, 1e-3, (params.particles_count, 3)).astype(np.float32)
        grid = grid_ops.compute_bounds(jnp.asarray(pos), params)
        codes = grid_ops.locate_in_grid(jnp.asarray(pos), grid)
        order = np.argsort(np.asarray(codes), kind="stable")
        pos_sorted = jnp.asarray(pos[order])

        blocked_pos = pos_sorted.reshape(-1, 64, 3)
        real = jnp.ones(blocked_pos.shape[:2], bool)
        bmin, bmax = T.split_block_bounds(blocked_pos, real)

        cand_d, count_d, ovf_d = T.candidate_blocks(bmin, bmax, params.h, 512)
        cand_h, count_h, ovf_h = T.candidate_blocks_hierarchical(
            bmin, bmax, params.h, 512, super_cand=64
        )
        assert not bool(ovf_d) and not bool(ovf_h)
        nb = bmin.shape[0]
        extras = 0
        for i in range(nb):
            sd = set(np.asarray(cand_d[i, : int(count_d[i])]).tolist())
            sh = set(np.asarray(cand_h[i, : int(count_h[i])]).tolist())
            assert sd <= sh, (i, sd - sh)  # never misses a candidate
            extras += len(sh - sd)
        assert extras <= 0.3 * int(np.sum(np.asarray(count_d))), extras


class TestDiagnostics:
    def test_neighbor_stats(self, rng):
        from libclsph_tpu.utils.diagnostics import neighbor_stats, density_summary

        params = make_params(WATER, n=1000)
        pos = (rng.random((1000, 3)).astype(np.float32) - 0.5) * 0.5
        stats = neighbor_stats(jnp.asarray(pos), params, block_size=64)
        assert int(stats.count_max) >= 1
        assert float(stats.count_mean) <= float(stats.count_max)
        assert not bool(stats.overflowed)
        assert int(stats.occupancy_max) >= 1

        s = density_summary(np.full(100, 998.0, np.float32), params)
        assert s["frac_within_10pct_rest"] == 1.0
        assert not s["any_nonfinite"]


@pytest.mark.parametrize("n", [100, 129, 2049])
def test_odd_particle_counts(n, interpret_kernels):
    """Non-power-of-two and sub-block counts pad correctly through the
    whole substep (both block backends)."""
    from libclsph_tpu.core.state import init_state

    params = make_params(WATER, n=n)
    state = init_state(params)
    dt = jnp.float32(params.max_dt)
    for impl in ["tiles", "fused"]:
        cfg = StepConfig(neighbor_impl=impl)
        s2, _, _ = substep_jit(state, dt, params, None, cfg)
        assert np.isfinite(np.asarray(s2.position)).all()
        assert s2.position.shape[0] == n
        assert float(s2.density.min()) > 0


def test_grid_dim_guard(rng):
    """An exploded domain (extent > 1024 Morton cells) must raise the
    FLAG_GRID_DIM bit instead of silently aliasing cell codes — the
    analog of the reference's hard abort (sph_simulation.cpp:722-724)."""
    from libclsph_tpu.engine.step import FLAG_GRID_DIM

    params = make_params(WATER, n=256)
    pos, vel = random_cloud(rng, params, 256)
    # one runaway particle stretches the grid past the 10-bit limit
    pos[0] = (2000.0 * params.cell_side, 0.0, 0.0)
    state = make_state(pos, vel)
    cfg = StepConfig(neighbor_impl="tiles", adaptive_dt=False)
    _, _, flags = substep_jit(state, jnp.float32(1e-9), params, None, cfg)
    assert int(flags) & FLAG_GRID_DIM

    # a healthy domain does not raise it
    pos2, vel2 = random_cloud(rng, params, 256)
    _, _, flags2 = substep_jit(
        make_state(pos2, vel2), jnp.float32(1e-9), params, None, cfg
    )
    assert not (int(flags2) & FLAG_GRID_DIM)


def test_engine_raises_on_grid_explosion():
    """SPHSimulation._needs_rerun raises on FLAG_GRID_DIM."""
    from libclsph_tpu.engine.simulation import SPHSimulation
    from libclsph_tpu.engine.step import FLAG_CAPACITY, FLAG_GRID_DIM

    sim = SPHSimulation()
    with pytest.raises(RuntimeError, match="1024"):
        sim._needs_rerun(FLAG_GRID_DIM)
    assert sim._needs_rerun(0) is False


def test_scatter_compaction_matches_sort(rng, monkeypatch):
    """LIBCLSPH_TPU_COMPACT=scatter keeps the same LIVE ID SET per row
    as the sort implementation (order differs by design: encounter
    order vs ascending), is live-first, and preserves self-priority
    under truncation."""
    from libclsph_tpu.ops import tiles as tiles_ops

    nb, K = 64, 96
    sent = tiles_ops.REFINE_SENTINEL
    ids = rng.integers(0, 500, (nb, K)).astype(np.int32)
    ids = np.where(rng.random((nb, K)) < 0.6, sent, ids)
    # de-dup live ids per row (real refine lists are duplicate-free)
    for r in range(nb):
        live = ids[r] != sent
        vals, idx = np.unique(ids[r][live], return_index=True)
        row = np.full(K, sent, np.int32)
        row[np.flatnonzero(live)[idx]] = vals
        ids[r] = row
    self_lo = rng.integers(0, 480, nb).astype(np.int32)
    width = 16

    def run(impl, cap):
        monkeypatch.setenv("LIBCLSPH_TPU_COMPACT", impl)
        out = tiles_ops._self_priority_sort(
            jnp.asarray(ids), jnp.asarray(self_lo), width, cap
        )
        return np.asarray(jax.jit(lambda x: x)(out))

    # no truncation: identical live sets, scatter is live-first
    cap = K
    a = run("sort", cap)
    b = run("scatter", cap)
    for r in range(nb):
        sa = set(a[r][a[r] != sent].tolist())
        sb = set(b[r][b[r] != sent].tolist())
        assert sa == sb, r
        nlive = len(sb)
        assert (b[r][:nlive] != sent).all() and (b[r][nlive:] == sent).all()

    # truncation: every self id still survives in both
    cap_t = 8
    bt = run("scatter", cap_t)
    at = run("sort", cap_t)
    for r in range(nb):
        selfs = {
            v
            for v in ids[r].tolist()
            if v != sent and self_lo[r] <= v < self_lo[r] + width
        }
        if len(selfs) <= cap_t:
            assert selfs <= set(bt[r].tolist()), r
            assert selfs <= set(at[r].tolist()), r
