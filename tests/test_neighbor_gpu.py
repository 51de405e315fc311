"""The fused GPU density/force kernels (ops/pallas/neighbor_gpu.py).

CPU tests run the kernels in Pallas interpret mode against the XLA
tiles passes and the float64 oracle, and cover the wrappers' edge
cases. The gpu-marked tests run the same comparisons with the kernels
compiled for the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from chip_smoke import sorted_blocks
from conftest import WATER, make_params
from libclsph_tpu.core.state import ParticleState, init_state
from libclsph_tpu.engine import step as step_mod
from libclsph_tpu.ops import interactions
from libclsph_tpu.ops import tiles as tiles_ops
from libclsph_tpu.ops.pallas import neighbor_gpu as ng

B = 128
SHAPES = [ng.DENSITY_SHAPE, ng.FORCE_SHAPE]


def cloud_state(params, n, seed=0, spread=1.5):
    rng = np.random.default_rng(seed)
    side = params.initial_volume ** (1 / 3) * spread
    pos = ((rng.random((n, 3)) - 0.5) * side).astype(np.float32)
    vel = ((rng.random((n, 3)) - 0.5) * 2.0).astype(np.float32)
    return ParticleState(
        position=jnp.asarray(pos), velocity=jnp.asarray(vel),
        intermediate_velocity=jnp.asarray(vel),
        acceleration=jnp.zeros((n, 3), jnp.float32),
        density=jnp.zeros((n,), jnp.float32),
        pressure=jnp.zeros((n,), jnp.float32),
        grid_index=jnp.zeros((n,), jnp.uint32),
    )


def make_case(kind):
    """(params, blocked, real, cand, count) for a named state."""
    if kind == "lattice":  # the dam-break's initial cube lattice
        params = make_params(WATER, n=2048)
        state = init_state(params)
    elif kind == "cloud":  # free-space random cloud
        params = make_params(WATER, n=2048)
        state = cloud_state(params, 2048)
    else:  # n not a multiple of the block or of any tile
        params = make_params(WATER, n=1000)
        state = cloud_state(params, 1000, seed=1)
    return (params,) + sorted_blocks(state, params, B, 64)


def with_rho(blocked, rho, real, params):
    p = jnp.where(real, interactions.tait_pressure(rho, params), 0.0)
    return blocked._replace(
        density=rho.reshape(blocked.density.shape),
        pressure=p.reshape(blocked.pressure.shape),
    )


def tiles_passes(params, blocked, real, cand, count):
    cfg = tiles_ops.TileConfig(block_size=blocked.position.shape[1],
                               max_candidates=cand.shape[1])
    terms = params.precomputed()
    with jax.default_matmul_precision("highest"):
        rho = tiles_ops.density_pass(blocked, cand, count, params, terms, cfg)
        acc = tiles_ops.force_pass(
            with_rho(blocked, rho, real, params), cand, count, params,
            terms, cfg,
        )
    return rho, acc


def kernel_passes(params, blocked, real, cand, count, interpret=True,
                  shapes=(ng.DENSITY_SHAPE, ng.FORCE_SHAPE)):
    terms = params.precomputed()
    pack = ng.pack_density(blocked)
    rho = ng.fused_density(pack, pack, cand, count, params, terms,
                           interpret=interpret, shape=shapes[0])
    rho = jnp.where(real, rho, params.fluid_density)
    fpack = ng.pack_forces(with_rho(blocked, rho, real, params),
                           params.particle_mass)
    acc = ng.fused_forces(fpack, rho, fpack, cand, count, params, terms,
                          interpret=interpret, shape=shapes[1])
    return rho, acc


def rel_rms(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.sqrt(np.sum((a - b) ** 2) / np.sum(b**2))


@pytest.mark.parametrize("shape", SHAPES, ids=["density_shape", "force_shape"])
@pytest.mark.parametrize("kind", ["lattice", "cloud", "odd_n"])
def test_density_matches_tiles(kind, shape):
    params, blocked, real, cand, count = make_case(kind)
    pack = ng.pack_density(blocked)
    rho = ng.fused_density(pack, pack, cand, count, params,
                           params.precomputed(), interpret=True, shape=shape)
    rho_t, _ = tiles_passes(params, blocked, real, cand, count)
    m = np.asarray(real)
    assert rel_rms(np.asarray(rho)[m], np.asarray(rho_t)[m]) < 2e-6


@pytest.mark.parametrize("shape", SHAPES, ids=["density_shape", "force_shape"])
@pytest.mark.parametrize("kind", ["lattice", "cloud", "odd_n"])
def test_forces_match_tiles(kind, shape):
    params, blocked, real, cand, count = make_case(kind)
    rho_t, acc_t = tiles_passes(params, blocked, real, cand, count)
    fpack = ng.pack_forces(with_rho(blocked, rho_t, real, params),
                           params.particle_mass)
    acc = ng.fused_forces(fpack, rho_t, fpack, cand, count, params,
                          params.precomputed(), interpret=True, shape=shape)
    m = np.asarray(real)
    assert rel_rms(np.asarray(acc)[m], np.asarray(acc_t)[m]) < 1e-5


@pytest.mark.parametrize("which", ["density", "forces"])
def test_matches_oracle(which):
    """Both passes against the O(N^2) float64 oracle (tests/oracle.py)
    on a free-space cloud."""
    params = make_params(WATER, n=300)
    params, blocked, real, cand, count = (params,) + sorted_blocks(
        cloud_state(params, 300, seed=3, spread=1.0), params, B, 64
    )
    rho, acc = kernel_passes(params, blocked, real, cand, count)
    m = np.asarray(real)
    pos = np.asarray(blocked.position).reshape(-1, 3)[m].astype(np.float64)
    vel = np.asarray(blocked.velocity).reshape(-1, 3)[m].astype(np.float64)
    rho_o, p_o = oracle.density_pressure(
        pos, params.particle_mass, params.h, params.fluid_density, params.K
    )
    if which == "density":
        assert rel_rms(np.asarray(rho)[m], rho_o) < 1e-5
        return
    acc_o = oracle.accelerations(
        pos, vel, rho_o, p_o, params.particle_mass, params.h,
        params.dynamic_viscosity, params.surface_tension,
        params.surface_tension_threshold,
        np.asarray(params.constant_acceleration),
    )
    assert rel_rms(np.asarray(acc)[m], acc_o) < 1e-4


def test_count_zero_reads_nothing():
    """Rows with no live candidate slot: zero density sum, and the
    acceleration is gravity alone."""
    params, blocked, real, cand, count = make_case("cloud")
    zero = jnp.zeros_like(count)
    terms = params.precomputed()
    pack = ng.pack_density(blocked)
    raw = ng.fused_density(pack, pack, cand, zero, params, terms,
                           interpret=True)
    np.testing.assert_array_equal(np.asarray(raw), 0.0)
    rho0 = jnp.full(real.shape, params.fluid_density, jnp.float32)
    fpack = ng.pack_forces(with_rho(blocked, rho0, real, params),
                           params.particle_mass)
    acc = ng.fused_forces(fpack, rho0, fpack, cand, zero, params, terms,
                          interpret=True)
    g = np.broadcast_to(np.asarray(params.constant_acceleration, np.float32),
                        acc.shape)
    np.testing.assert_array_equal(np.asarray(acc), g)


def test_full_slots_match_tiles():
    """Every slot live: the all-pairs candidate table (each block's
    list is every block) gives the tiles result."""
    params, blocked, real, _, _ = make_case("cloud")
    nb = blocked.position.shape[0]
    own = jnp.arange(nb, dtype=jnp.int32)[:, None]
    others = jnp.arange(nb, dtype=jnp.int32)[None, :]
    # own block first, like candidate_blocks; then all the others
    cand = jnp.where(others == 0, own, jnp.where(others <= own, others - 1, others))
    count = jnp.full((nb,), nb, jnp.int32)
    rho, acc = kernel_passes(params, blocked, real, cand, count)
    rho_t, acc_t = tiles_passes(params, blocked, real, cand, count)
    m = np.asarray(real)
    assert rel_rms(np.asarray(rho)[m], np.asarray(rho_t)[m]) < 2e-6
    assert rel_rms(np.asarray(acc)[m], np.asarray(acc_t)[m]) < 1e-5


def test_dead_slots_are_never_read():
    """Slots at or past count may hold the hierarchical search's
    REFINE_SENTINEL or stale ids: the results do not change."""
    params, blocked, real, cand, count = make_case("odd_n")
    slot = jnp.arange(cand.shape[1], dtype=jnp.int32)[None, :]
    dead = slot >= count[:, None]
    junk = jnp.where(dead, tiles_ops.REFINE_SENTINEL, cand)
    stale = jnp.where(dead, 0, cand)
    base = kernel_passes(params, blocked, real, cand, count)
    for table in (junk, stale):
        out = kernel_passes(params, blocked, real, table, count)
        for a, b in zip(out, base):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_coincident_particles_take_the_singular_branch():
    """Distinct particles at one position: the spiky r -> 0 branch
    (smoothing.cl:21-29), matched against tiles and the oracle."""
    params = make_params(WATER, n=300)
    state = cloud_state(params, 300, seed=5, spread=1.0)
    pos = state.position.at[1].set(state.position[0])
    pos = pos.at[2].set(state.position[0])
    state = state.replace(position=pos)
    blocked, real, cand, count = sorted_blocks(state, params, B, 64)
    rho, acc = kernel_passes(params, blocked, real, cand, count)
    _, acc_t = tiles_passes(params, blocked, real, cand, count)
    m = np.asarray(real)
    assert rel_rms(np.asarray(acc)[m], np.asarray(acc_t)[m]) < 1e-5
    p = np.asarray(blocked.position).reshape(-1, 3)[m].astype(np.float64)
    v = np.asarray(blocked.velocity).reshape(-1, 3)[m].astype(np.float64)
    rho_o, p_o = oracle.density_pressure(
        p, params.particle_mass, params.h, params.fluid_density, params.K
    )
    acc_o = oracle.accelerations(
        p, v, rho_o, p_o, params.particle_mass, params.h,
        params.dynamic_viscosity, params.surface_tension,
        params.surface_tension_threshold,
        np.asarray(params.constant_acceleration),
    )
    assert rel_rms(np.asarray(acc)[m], acc_o) < 1e-4


def test_ids_are_exact_int32():
    """Self-exclusion compares int32 ids: offsets past 2^24, where
    float32 ids would merge neighbours, give identical results."""
    params, blocked, real, cand, count = make_case("cloud")
    far = blocked._replace(gid=blocked.gid + (1 << 25) + 1)
    base = kernel_passes(params, blocked, real, cand, count)
    out = kernel_passes(params, far, real, cand, count)
    for a, b in zip(out, base):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ids = jax.lax.bitcast_convert_type(ng.pack_density(far)[:, ng.ID],
                                       jnp.int32)
    want = jnp.where(far.real, far.gid, ng.NONREAL_ID)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(want))


@pytest.mark.parametrize(
    "shape", [ng.KernelShape(24, 32, 2, 2), ng.KernelShape(32, 48, 2, 2)],
    ids=["query_tile", "cand_tile"],
)
def test_bad_tile_rejected(shape):
    params, blocked, real, cand, count = make_case("lattice")
    pack = ng.pack_density(blocked)
    with pytest.raises(ValueError, match="power of two"):
        ng.fused_density(pack, pack, cand, count, params,
                         params.precomputed(), interpret=True, shape=shape)


def test_tiles_clip_to_narrow_blocks():
    """Blocks narrower than the tuned tiles (64 < 128) still match."""
    params = make_params(WATER, n=1024)
    blocked, real, cand, count = sorted_blocks(
        cloud_state(params, 1024, seed=2), params, 64, 64
    )
    rho, acc = kernel_passes(params, blocked, real, cand, count)
    rho_t, acc_t = tiles_passes(params, blocked, real, cand, count)
    m = np.asarray(real)
    assert rel_rms(np.asarray(rho)[m], np.asarray(rho_t)[m]) < 2e-6
    assert rel_rms(np.asarray(acc)[m], np.asarray(acc_t)[m]) < 1e-5


def test_engine_glue_matches_tiles(interpret_kernels):
    """engine.step's fused passes (packing, padding masks, pressure)
    against its tiles passes on the same padded sorted state."""
    params = make_params(WATER, n=1000)
    state = cloud_state(params, 1000, seed=4)
    blocked, real, _, _ = sorted_blocks(state, params, B, 64)
    n = blocked.real.size
    padded = ParticleState(
        position=blocked.position.reshape(n, 3),
        velocity=blocked.velocity.reshape(n, 3),
        intermediate_velocity=blocked.velocity.reshape(n, 3),
        acceleration=jnp.zeros((n, 3)), density=jnp.zeros(n),
        pressure=jnp.zeros(n), grid_index=jnp.zeros(n, jnp.uint32),
    )
    got, want = (
        step_mod._density_forces_blocks(
            padded, real, params, step_mod.StepConfig(neighbor_impl=impl)
        )
        for impl in ("fused", "tiles")
    )
    m = np.asarray(real)
    for a, b in zip(got[:3], want[:3]):
        assert rel_rms(np.asarray(a)[m], np.asarray(b)[m]) < 1e-5
    assert int(got[3]) == int(want[3]) == 0


def test_substep_fused_matches_tiles(interpret_kernels):
    params = make_params(WATER, n=1024)
    state = cloud_state(params, 1024, seed=6)
    outs = []
    for impl in ("tiles", "fused"):
        cfg = step_mod.StepConfig(neighbor_impl=impl, adaptive_dt=False)
        out, dt, flags = step_mod.substep_jit(
            state, jnp.float32(1e-9), params, None, cfg
        )
        assert not int(flags)
        o = np.lexsort(np.round(np.asarray(out.position, np.float64), 6).T)
        outs.append((np.asarray(out.density)[o],
                     np.asarray(out.acceleration)[o]))
    assert rel_rms(outs[1][0], outs[0][0]) < 2e-6
    assert rel_rms(outs[1][1], outs[0][1]) < 1e-5


# ------------------------------------------------------------- on the card
@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["lattice", "cloud", "odd_n"])
def test_compiled_kernels_match_tiles(gpu, kind):
    params, blocked, real, cand, count = make_case(kind)
    rho, acc = jax.jit(
        lambda *a: kernel_passes(params, *a, interpret=False)
    )(blocked, real, cand, count)
    rho_t, _ = tiles_passes(params, blocked, real, cand, count)
    _, acc_t = tiles_passes(params, with_rho(blocked, rho, real, params),
                            real, cand, count)
    m = np.asarray(real)
    assert rel_rms(np.asarray(rho)[m], np.asarray(rho_t)[m]) < 2e-5
    assert rel_rms(np.asarray(acc)[m], np.asarray(acc_t)[m]) < 1e-4


@pytest.mark.gpu
def test_compiled_fused_substep(gpu):
    params = make_params(WATER, n=4096)
    state = init_state(params)
    cfg = step_mod.StepConfig()
    assert cfg.neighbor_impl == "fused"
    out, dt, flags = step_mod.substep_jit(
        state, jnp.float32(params.max_dt), params, None, cfg
    )
    assert not int(flags)
    assert np.isfinite(np.asarray(out.position)).all()
    assert float(dt) > 0.0


@pytest.mark.gpu
def test_compiled_fused_under_shard_map(gpu):
    """The fused kernels inside the sharded substep on a 1-card mesh
    match the single-card substep."""
    from libclsph_tpu.parallel.mesh import make_mesh, particle_sharding
    from libclsph_tpu.parallel.sharded_step import (
        make_sharded_substep, pad_for_mesh,
    )

    params = make_params(WATER, n=4096)
    cfg = step_mod.StepConfig(adaptive_dt=False)
    state = init_state(params)
    dt = jnp.float32(1e-9)
    s1, _, f1 = step_mod.substep_jit(state, dt, params, None, cfg)
    mesh = make_mesh(jax.devices()[:1])
    sp = jax.tree.map(lambda a: jax.device_put(a, particle_sharding(mesh)),
                      pad_for_mesh(state, params, mesh, cfg))
    s2, _, f2 = make_sharded_substep(mesh, params, None, cfg)(sp, dt)
    assert not int(f1) and not int(f2)
    pos2 = np.asarray(s2.position)
    keep = np.abs(pos2).max(axis=1) < 1e30

    def order(p):
        return np.lexsort(np.round(np.asarray(p, np.float64), 6).T)

    o1, o2 = order(s1.position), order(pos2[keep])
    assert rel_rms(np.asarray(s2.density)[keep][o2],
                   np.asarray(s1.density)[o1]) < 2e-5
    assert rel_rms(np.asarray(s2.acceleration)[keep][o2],
                   np.asarray(s1.acceleration)[o1]) < 1e-4
