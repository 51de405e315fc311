"""The SPH substep as a single jitted device program.

Functional equivalent of simulate_single_frame
(``libclsph/sph_simulation.cpp:200-263``) with its kernel-by-kernel
pipeline (bounds -> locate -> sort -> density/pressure -> forces ->
adaptive-dt advect+collide) fused into ONE traced function: the
reference performs 4+ blocking device->host reduction reads per substep
(findMinMaxPosition :202, computeTimeStep :259); here everything,
including the dt retry loop (:252-260), runs on device and only the
final dt scalar ever needs to reach the host.

Three neighbour backends:
* ``exact`` — per-particle 27-cell gather (ops/neighbors.py),
  reference-structure parity. CPU correctness oracle only: its
  irregular (N, 27*cap) gathers grow to tens of GB at bench scale;
* ``tiles`` — Morton block tiles in plain XLA (ops/tiles.py);
* ``fused`` — the same block candidates feeding the fused GPU density
  and force kernels (ops/pallas/neighbor_gpu.py).

``StepConfig``'s default backend comes from libclsph_tpu/platform.py.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from .. import platform
from ..core.params import SimulationParameters
from ..core.state import ParticleState
from ..ops import collisions as collisions_ops
from ..ops import grid as grid_ops
from ..ops import integrate as integrate_ops
from ..ops import interactions as interactions_ops
from ..core import morton
from ..ops import neighbors as neighbors_ops
from ..ops import tiles as tiles_ops
from ..ops.pallas import neighbor_gpu

# Bits of the substep's device status flag (int32):
FLAG_CAPACITY = 1  # block-level candidate / exact-path cell capacity
FLAG_GRID_DIM = 2  # a grid axis reached the 10-bit Morton limit (1024)
FLAG_EXCHANGE = 4  # ring halo_hops too small: a needed shard is out of reach


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static knobs of the substep pipeline."""

    # 'tiles' | 'fused' | 'exact'; default: platform.neighbor_impl()
    neighbor_impl: str = dataclasses.field(
        default_factory=platform.neighbor_impl
    )
    cell_capacity: int = 96  # exact path: max particles per grid cell
    block_size: int = 128  # tiles/fused: particles per block
    max_candidates: int = 64  # tiles/fused: candidate blocks per block
    # Re-sort particles every k-th substep instead of every substep
    # (frame_jit fast path + bench; 1 = reference behaviour). Safe for
    # tiles/fused: candidates are geometric (block boxes from CURRENT
    # positions, recomputed every substep) and every pair term carries
    # the hard r<h cutoff, so a stale ORDER only costs pruning
    # efficiency — particles drift ~1e-3 cell/substep, so locality is
    # intact for small k and capacity flags catch the pathological
    # case. Skipped substeps save the key sort + full-state permute.
    # Not supported for the 'exact' impl (needs sorted codes).
    sort_interval: int = 1
    adaptive_dt: bool = True
    # frame_jit dispatch bound: a stiff impact can floor the adaptive
    # dt at DT_MIN (1e-5 s), blowing a frame up to ~1.7k substeps; the
    # engine loops frame_jit until the frame's time budget is spent, at
    # most this many substeps per dispatch, so no single dispatch runs
    # for minutes.
    substeps_per_dispatch: int = 64

    def tile_config(self) -> tiles_ops.TileConfig:
        return tiles_ops.TileConfig(
            block_size=self.block_size,
            max_candidates=self.max_candidates,
        )


def _density_forces_exact(
    state: ParticleState,
    sorted_codes: jnp.ndarray,
    params: SimulationParameters,
    config: StepConfig,
):
    terms = params.precomputed()
    idx, valid = neighbors_ops.neighbor_indices(sorted_codes, config.cell_capacity)

    c_pos = neighbors_ops.gather_candidates(state.position, idx)
    density = interactions_ops.density_sum(state.position, c_pos, valid, params, terms)
    pressure = interactions_ops.tait_pressure(density, params)

    n = state.n
    is_self = idx == jnp.arange(n, dtype=jnp.int32)[:, None]
    f = interactions_ops.force_sums(
        state.position,
        state.velocity,
        density,
        pressure,
        c_pos,
        neighbors_ops.gather_candidates(state.velocity, idx),
        neighbors_ops.gather_candidates(density, idx),
        neighbors_ops.gather_candidates(pressure, idx),
        valid,
        is_self,
        params,
        terms,
    )
    accel = interactions_ops.combine_forces(f, density, params)
    overflow = neighbors_ops.max_cell_occupancy(sorted_codes) > config.cell_capacity
    return density, pressure, accel, overflow.astype(jnp.int32) * FLAG_CAPACITY


def block_passes(
    blocked: tiles_ops.BlockedFields,
    cand: jnp.ndarray,
    count: jnp.ndarray,
    params: SimulationParameters,
    config: StepConfig,
    cand_fields: Optional[tiles_ops.BlockedFields] = None,
    force_fields=None,
):
    """Density, pressure and acceleration of the query ``blocked`` over
    their candidate lists, by ``config.neighbor_impl``: the XLA tiles
    passes or the fused GPU kernels (ops/pallas/neighbor_gpu.py).

    ``cand_fields`` is the block table ``cand`` indexes (default:
    ``blocked``); ``force_fields(blocked)`` rebuilds it with the fresh
    density/pressure for the force pass (default: ``blocked`` itself).
    The sharded step passes its exchanged tables here. Returns flat
    (n,), (n,), (n, 3); padding rows carry rest density and zero
    pressure.
    """
    terms = params.precomputed()
    cfg = config.tile_config()
    real = blocked.real.reshape(-1)
    cf = blocked if cand_fields is None else cand_fields
    if config.neighbor_impl == "fused":
        density = neighbor_gpu.fused_density(
            neighbor_gpu.pack_density(blocked), neighbor_gpu.pack_density(cf),
            cand, count, params, terms,
        )
    else:
        density = tiles_ops.density_pass(
            blocked, cand, count, params, terms, cfg, cand_fields=cf
        )
    density = jnp.where(real, density, params.fluid_density)
    pressure = interactions_ops.tait_pressure(density, params)
    pressure = jnp.where(real, pressure, 0.0)

    blocked = blocked._replace(
        density=density.reshape(blocked.density.shape),
        pressure=pressure.reshape(blocked.pressure.shape),
    )
    cf = blocked if force_fields is None else force_fields(blocked)
    if config.neighbor_impl == "fused":
        mass = params.particle_mass
        accel = neighbor_gpu.fused_forces(
            neighbor_gpu.pack_forces(blocked, mass), density,
            neighbor_gpu.pack_forces(cf, mass), cand, count, params, terms,
        )
    else:
        accel = tiles_ops.force_pass(
            blocked, cand, count, params, terms, cfg, cand_fields=cf
        )
    return density, pressure, accel


def _density_forces_blocks(
    state: ParticleState,
    real: jnp.ndarray,
    params: SimulationParameters,
    config: StepConfig,
):
    """Block candidate search on the sorted, padded state, then
    :func:`block_passes`."""
    blocked = tiles_ops.make_blocked(
        state.position,
        state.velocity,
        state.density,
        state.pressure,
        real,
        config.block_size,
    )
    bmin, bmax = tiles_ops.split_block_bounds(blocked.position, blocked.real)
    cand, count, overflow = tiles_ops.candidate_blocks_auto(
        bmin, bmax, params.h, config.max_candidates
    )
    density, pressure, accel = block_passes(blocked, cand, count, params, config)
    return density, pressure, accel, overflow.astype(jnp.int32) * FLAG_CAPACITY


def _advect_collide(
    state: ParticleState,
    scene: Optional[collisions_ops.DeviceScene],
    dt: jnp.ndarray,
    params: SimulationParameters,
):
    """advection_collision (sphb.cl:177-223): leapfrog + DF response +
    half-step velocity reconstruction."""
    adv = integrate_ops.advect(
        state.position, state.intermediate_velocity, state.acceleration, dt
    )
    resp = collisions_ops.handle_collisions(
        scene,
        adv.old_position,
        adv.new_position,
        adv.next_velocity,
        params.restitution,
        dt,
    )
    velocity, intermediate = integrate_ops.reconstruct_velocities(
        state.intermediate_velocity, resp.next_velocity
    )
    return state.replace(
        position=resp.position,
        velocity=velocity,
        intermediate_velocity=intermediate,
    )


def substep(
    state: ParticleState,
    dt: jnp.ndarray,
    params: SimulationParameters,
    scene: Optional[collisions_ops.DeviceScene],
    config: StepConfig,
    do_sort=True,
):
    """One SPH substep. Returns (new_state, dt_next, flags).

    ``do_sort``: True (default) re-sorts by Morton code; False (static)
    or a traced bool scalar (frame_jit with config.sort_interval > 1)
    skips/gates the sort, reusing the previous substep's order — see
    StepConfig.sort_interval for why that is physics-exact.

    ``flags`` (device int32 scalar) is a bitfield:
    * FLAG_CAPACITY — the static neighbour capacity (tile candidate cap
      / exact-path cell capacity) truncated real neighbours this step;
      the engine responds by re-running the frame at a larger capacity
      (see engine/simulation.py autotune).
    * FLAG_GRID_DIM — a grid axis reached morton.MAX_GRID_DIM cells, so
      Morton codes would alias and neighbour physics would silently go
      wrong. The reference hard-aborts on this
      (sph_simulation.cpp:722-724); the engine raises.

    Note: like the reference (which ping-pongs buffers and never
    un-sorts), the returned state is in Morton-sorted order — particle
    identity across steps is not preserved. SPH fields are symmetric
    under permutation so dynamics are unaffected; exporters that need
    stable IDs can track the permutation via ``state.grid_index``.
    """
    n = params.particles_count

    # ---- grid bounds + cell assignment (on-device findMinMaxPosition)
    grid = grid_ops.compute_bounds(state.position, params)
    codes = grid_ops.locate_in_grid(state.position, grid)
    # 10-bit Morton limit guard (sph_simulation.cpp:722-724); also
    # flags a grid that outgrew a reduced radix key width
    grid_bad = jnp.any(grid.grid_size >= morton.MAX_GRID_DIM) | (
        grid_ops.grid_exceeds_sort_bits(grid.grid_size)
    )

    if config.neighbor_impl != "exact":
        # pad to a whole number of blocks; sentinels sort last
        np_ = tiles_ops.padded_count(n, config.block_size)
        pad = np_ - n
        if pad:
            far = grid.max_point + 1000.0 * params.h
            state = jax.tree.map(
                lambda a: jnp.concatenate(
                    [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], axis=0
                ),
                state,
            )
            state = state.replace(
                position=state.position.at[n:].set(far),
            )
            codes = jnp.concatenate(
                [codes, jnp.full((pad,), tiles_ops.SENTINEL_CODE, jnp.uint32)]
            )

    # ---- sort by Morton code (replaces the radix-sort pipeline)
    def sort_lean(st, cs):
        # tiles/fused: permute only the fields the rest of the substep
        # READS (position, velocity, intermediate_velocity) — density,
        # pressure and acceleration are rebuilt from scratch by the
        # density/force passes before anything consumes them, so
        # permuting them is pure gather traffic (~20 B/particle
        # read+write per sort substep at 1M)
        sorted_cs, order = jax.lax.sort_key_val(
            cs, jnp.arange(cs.shape[0], dtype=jnp.int32)
        )
        return st.replace(
            position=jnp.take(st.position, order, axis=0),
            velocity=jnp.take(st.velocity, order, axis=0),
            intermediate_velocity=jnp.take(
                st.intermediate_velocity, order, axis=0
            ),
            grid_index=sorted_cs,
        )

    if do_sort is True:
        if config.neighbor_impl == "exact":
            state, sorted_codes, _ = grid_ops.sort_by_cell(state, codes)
        else:
            state = sort_lean(state, codes)
            sorted_codes = state.grid_index
    else:
        if config.neighbor_impl == "exact":
            raise ValueError(
                "sort skipping needs geometric candidates; the 'exact' "
                "impl requires sorted codes every substep"
            )
        sorted_codes = None
        if do_sort is False:  # statically skipped (bench rows)
            state = state.replace(grid_index=codes)
        else:  # traced scalar: gate the sort on device
            state = jax.lax.cond(
                do_sort,
                sort_lean,
                lambda s, c: s.replace(grid_index=c),
                state, codes,
            )

    # ---- density + pressure, forces
    if config.neighbor_impl in ("tiles", "fused"):
        real = jnp.arange(state.n, dtype=jnp.int32) < jnp.int32(n)
        density, pressure, accel, cap_flags = _density_forces_blocks(
            state, real, params, config
        )
    else:
        density, pressure, accel, cap_flags = _density_forces_exact(
            state, sorted_codes, params, config
        )
    state = state.replace(density=density, pressure=pressure, acceleration=accel)

    if config.neighbor_impl != "exact":
        # drop sentinel tail before integration
        state = jax.tree.map(lambda a: a[:n], state)

    # ---- adaptive-dt advect + collide (sph_simulation.cpp:246-262)
    def advance(dt_try):
        new_state = _advect_collide(state, scene, dt_try, params)
        dt_next = integrate_ops.compute_time_step(
            new_state.velocity, new_state.acceleration, params
        )
        return new_state, dt_next

    first_state, first_dt = advance(dt)
    if config.adaptive_dt:

        def cond(carry):
            _, dt_used, dt_new = carry
            return dt_used - dt_new > integrate_ops.DT_RETRY_EPS

        def body(carry):
            _, _, dt_new = carry
            st, dt_next = advance(dt_new)
            return st, dt_new, dt_next

        final_state, _, dt_out = jax.lax.while_loop(
            cond, body, (first_state, dt, first_dt)
        )
    else:
        final_state, dt_out = first_state, first_dt

    flags = cap_flags + grid_bad.astype(jnp.int32) * FLAG_GRID_DIM
    return final_state, dt_out, flags


# NOTE: no donate_argnums here — the engine's capacity-overflow retry
# re-runs a frame from the same input state, which donation would free.
@partial(jax.jit, static_argnames=("params", "config", "do_sort"))
def substep_jit(state, dt, params, scene, config, do_sort=True):
    return substep(state, dt, params, scene, config, do_sort=do_sort)


@partial(jax.jit, static_argnames=("params", "config"))
def frame_jit(state, dt, timeleft, params, scene, config):
    """A frame's substep loop on device (sph_simulation.cpp:384-409).

    Carries (state, dt, timeleft, flags, n); loops until the frame time
    budget is exhausted OR config.substeps_per_dispatch substeps ran
    (bounding the dispatch — see StepConfig), clamping dt to timeleft
    exactly like the host loop (:391-394). Returns (state, dt,
    timeleft, flags); the engine re-dispatches while timeleft > 0.
    ``flags`` ORs the per-substep status bitfields.
    """
    cap = jnp.int32(config.substeps_per_dispatch)
    interval = int(config.sort_interval)

    def cond(carry):
        _, _, timeleft, _, n = carry
        return (timeleft > 0.0) & (n < cap)

    def body(carry):
        st, dt_cur, timeleft, flags, n = carry
        # re-sort on the dispatch's first substep, then every k-th
        do_sort = True if interval <= 1 else (n % interval == 0)
        st, dt_next, step_flags = substep(
            st, dt_cur, params, scene, config, do_sort=do_sort
        )
        timeleft = timeleft - dt_next
        dt_next = jnp.where(timeleft < dt_next, timeleft, dt_next)
        return st, dt_next, timeleft, flags | step_flags, n + 1

    state, dt, timeleft, flags, _ = jax.lax.while_loop(
        cond, body, (state, dt, timeleft, jnp.int32(0), jnp.int32(0))
    )
    return state, dt, timeleft, flags
