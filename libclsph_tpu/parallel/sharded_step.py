"""Multi-device SPH substep via ``shard_map`` over a device mesh.

New capability over the strictly single-device reference (SURVEY.md
§2.3): spatial (Morton-range) data decomposition across devices.

Per-shard algorithm (axis "dp"):

1.  Global bounds via ``lax.pmin``/``lax.pmax`` (the distributed
    findMinMaxPosition, sph_simulation.cpp:634-728 — two blocking host
    reads there, two collectives here).
2.  Local Morton sort of the shard's particles. Shards are seeded with
    a host-side global Morton partition (parallel/mesh.py), so each
    shard stays spatially compact and its tiles coherent.
3.  Neighbour search, two exchange strategies (see _local_substep):
    ``all_gather`` gathers every shard's block tables (simple, traffic
    ~N per step); ``halo`` publishes only each shard's *surface*
    blocks, so traffic scales with the boundary area instead of the
    volume. Both are validated equivalent to the single-device step.
4.  Adaptive-dt (sph_simulation.cpp:246-262) with ``lax.pmax`` over
    shard-local maxima inside the on-device retry loop, so all devices
    agree on dt with zero host synchronisation.

The density and force passes are the single-device ones
(engine/step.py): the plain-XLA tiles passes or the fused GPU kernels,
reading the exchanged candidate table.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import morton
from ..core.params import SimulationParameters
from ..core.state import ParticleState
from ..engine.step import (
    FLAG_CAPACITY,
    FLAG_EXCHANGE,
    FLAG_GRID_DIM,
    StepConfig,
    _advect_collide,
    block_passes,
)
from ..ops import collisions as collisions_ops
from ..ops import grid as grid_ops
from ..ops import integrate as integrate_ops
from ..ops import tiles as tiles_ops
from .mesh import AXIS


def _compact_mask(mask: jnp.ndarray, cap: int):
    """Indices of True entries, padded to ``cap`` slots.

    Returns (idx (cap,) int32, valid (cap,) bool, overflow () bool).
    """
    nb = mask.shape[0]
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    total = pos[-1] + 1
    ok = mask & (pos < cap)
    slot = jnp.where(ok, pos, cap)
    idx = jnp.zeros((cap + 1,), jnp.int32).at[slot].set(
        jnp.arange(nb, dtype=jnp.int32), mode="drop"
    )[:cap]
    valid = jnp.arange(cap, dtype=jnp.int32) < total
    return idx, valid, total > cap


def _local_substep(
    state: ParticleState,
    dt: jnp.ndarray,
    params: SimulationParameters,
    scene: Optional[collisions_ops.DeviceScene],
    config: StepConfig,
    n_shards: int,
    exchange: str = "all_gather",
    halo_max: int = 0,
    halo_hops: int = 1,
    do_sort=True,
):
    """Body run per shard under shard_map. state arrays are the local
    shard (n_local = padded_n / n_shards rows).

    ``exchange``:
    * ``all_gather`` — every shard gathers every block (simple,
      bandwidth ~N per step);
    * ``halo`` — each shard publishes only its *surface* blocks (those
      whose dilated AABB reaches another shard's spatial region) via
      all_gather; traffic ~ boundary area instead of volume.
      ``halo_max`` bounds the per-shard surface set (overflow reported
      like the candidate cap);
    * ``ring`` — point-to-point ppermute exchange of surface blocks
      over the Morton ring, ``halo_hops`` hops in each direction;
      traffic independent of n_shards. Raises FLAG_EXCHANGE when a
      spatially-neighbouring shard is out of hop range.

    Cadence (StepConfig.sort_interval, the sharded twin of
    engine.step.substep's): ``do_sort`` True sorts locally, False
    statically skips, a traced bool gates on device. Sound because shard
    ownership is static (particles never migrate between shards — the
    halo machinery covers cross-shard neighbours).
    """
    cfg = config.tile_config()
    n_local = state.position.shape[0]
    shard = jax.lax.axis_index(AXIS)

    # ---- 1. global bounds (pmin/pmax over real particles only);
    # sentinel padding rows are detected by their far-away positions
    # (pad_for_mesh places them at 1e32)
    big = jnp.float32(3.0e38)
    valid = jnp.isfinite(state.position).all(axis=1) & (
        jnp.abs(state.position).max(axis=1) < 1.0e30
    )
    local_min = jnp.min(
        jnp.where(valid[:, None], state.position, big), axis=0
    )
    local_max = jnp.max(
        jnp.where(valid[:, None], state.position, -big), axis=0
    )
    pos_min = jax.lax.pmin(local_min, AXIS)
    pos_max = jax.lax.pmax(local_max, AXIS)
    cell = jnp.float32(params.cell_side)
    gmin = pos_min - 2.0 * cell
    gmax = pos_max + 2.0 * cell
    grid = grid_ops.GridInfo(
        min_point=gmin,
        max_point=gmax,
        grid_size=((gmax - gmin) / cell).astype(jnp.int32),
        cell_side=cell,
    )
    # 10-bit Morton limit guard (sph_simulation.cpp:722-724); also
    # flags a grid that outgrew a reduced radix key width
    grid_bad = jnp.any(grid.grid_size >= morton.MAX_GRID_DIM) | (
        grid_ops.grid_exceeds_sort_bits(grid.grid_size)
    )

    # ---- 2. local Morton sort
    if do_sort is True:
        codes = grid_ops.locate_in_grid(state.position, grid)
        codes = jnp.where(valid, codes, tiles_ops.SENTINEL_CODE)
        state_s, _, order = grid_ops.sort_by_cell(state, codes)
        valid_s = jnp.take(valid, order, axis=0)
    elif do_sort is False:  # statically skipped
        state_s, valid_s = state, valid
    else:  # traced scalar: gate the sort on device
        codes = grid_ops.locate_in_grid(state.position, grid)
        codes = jnp.where(valid, codes, tiles_ops.SENTINEL_CODE)
        state_s = jax.lax.cond(
            do_sort,
            lambda s, c: grid_ops.sort_by_cell(s, c)[0],
            lambda s, c: s.replace(grid_index=c),
            state, codes,
        )
        # recompute validity in whichever order the branch produced
        valid_s = jnp.isfinite(state_s.position).all(axis=1) & (
            jnp.abs(state_s.position).max(axis=1) < 1.0e30
        )

    # ---- 3. blocked fields + global candidate table
    blocked = tiles_ops.make_blocked(
        state_s.position,
        state_s.velocity,
        state_s.density,
        state_s.pressure,
        valid_s,
        cfg.block_size,
        gid_offset=shard * n_local,
    )
    bmin, bmax = tiles_ops.split_block_bounds(blocked.position, blocked.real)

    # all-gather block tables (full tables only in all_gather mode;
    # halo/ring modes exchange surface blocks below)
    gather = lambda a: jax.lax.all_gather(a, AXIS, tiled=True)
    if exchange not in ("halo", "ring"):
        g_bmin = gather(bmin)
        g_bmax = gather(bmax)
        g_blocked_pos = gather(blocked.position)
        g_real = gather(blocked.real)
        g_gid = gather(blocked.gid)

    nb_local = bmin.shape[0]
    exchange_bad = jnp.asarray(False)

    if exchange == "ring":
        # -------- ppermute ring halo exchange (SURVEY §2.3 plan) ------
        # Point-to-point neighbour exchange: each shard sends ONE
        # fixed-size surface-block packet per hop per direction over
        # the Morton ring, so per-step traffic is O(halo_hops *
        # halo_max) — independent of n_shards (the all_gather modes
        # broadcast O(n_shards * size)). Shards outside hop range that
        # would have contributed raise FLAG_EXCHANGE (increase
        # halo_hops), checked conservatively against shard AABBs.
        s_n = n_shards
        hdil = jnp.float32(params.h)
        # forward/backward hop budgets with disjoint reach (full ring
        # coverage when 2*halo_hops >= S-1)
        r_fwd = min(halo_hops, s_n // 2)
        r_bwd = min(halo_hops, s_n - 1 - r_fwd)

        fwd_perm = [(i, (i + 1) % s_n) for i in range(s_n)]
        bwd_perm = [(i, (i - 1) % s_n) for i in range(s_n)]

        def ring_exchange(payload):
            """2R point-to-point sends; hop k forward delivers shard
            (me-k)'s packet, backward (me+k)'s — a fixed, deterministic
            order both the box table and the field tables share."""
            received = []
            buf = payload
            for _ in range(r_fwd):
                buf = jax.lax.ppermute(buf, AXIS, fwd_perm)
                received.append(buf)
            buf = payload
            for _ in range(r_bwd):
                buf = jax.lax.ppermute(buf, AXIS, bwd_perm)
                received.append(buf)
            return received

        self_index = jnp.arange(nb_local, dtype=jnp.int32)
        inf = jnp.float32(3.0e38)
        sh_min = gather(local_min[None, :])  # (S, 3) — tiny
        sh_max = gather(local_max[None, :])
        jidx = jnp.arange(s_n, dtype=jnp.int32)
        fwd_d = jnp.mod(jidx - shard, s_n)
        bwd_d = jnp.mod(shard - jidx, s_n)
        near = ((fwd_d >= 1) & (fwd_d <= r_fwd)) | (
            (bwd_d >= 1) & (bwd_d <= r_bwd)
        )
        sh_overlap = jnp.all(
            (local_min[None, :] - hdil <= sh_max)
            & (local_max[None, :] + hdil >= sh_min),
            axis=-1,
        )
        exchange_bad = jnp.any(sh_overlap & ~near & (jidx != shard))

        # surface blocks: dilated split boxes reaching a near shard
        near_lo = jnp.where(near[:, None], sh_min, inf)
        near_hi = jnp.where(near[:, None], sh_max, -inf)
        reach = jnp.any(
            jnp.all(
                (bmin[:, :, None, :] - hdil <= near_hi[None, None, :, :])
                & (bmax[:, :, None, :] + hdil >= near_lo[None, None, :, :]),
                axis=-1,
            ),
            axis=(1, 2),
        )
        surf_idx, surf_valid, surf_ovf = _compact_mask(reach, halo_max)

        boxes = ring_exchange(
            dict(
                bmin=jnp.where(
                    surf_valid[:, None, None],
                    jnp.take(bmin, surf_idx, axis=0), inf,
                ),
                bmax=jnp.where(
                    surf_valid[:, None, None],
                    jnp.take(bmax, surf_idx, axis=0), -inf,
                ),
            )
        )
        comb_bmin = jnp.concatenate(
            [bmin] + [b["bmin"] for b in boxes], axis=0
        )
        comb_bmax = jnp.concatenate(
            [bmax] + [b["bmax"] for b in boxes], axis=0
        )
        cand, count, cand_ovf = tiles_ops.candidate_blocks(
            bmin, bmax, params.h, cfg.max_candidates,
            comb_bmin, comb_bmax, self_index=self_index,
        )
        overflow = cand_ovf | surf_ovf

        def take_blocks(a):
            return jnp.take(a, surf_idx, axis=0)

        def combined_fields(blk):
            recv = ring_exchange(
                dict(
                    position=take_blocks(blk.position),
                    velocity=take_blocks(blk.velocity),
                    density=take_blocks(blk.density),
                    pressure=take_blocks(blk.pressure),
                    real=take_blocks(blk.real) & surf_valid[:, None],
                    gid=take_blocks(blk.gid),
                )
            )
            cat = lambda k: jnp.concatenate(
                [getattr(blk, k)] + [r[k] for r in recv], axis=0
            )
            return tiles_ops.BlockedFields(
                position=cat("position"),
                velocity=cat("velocity"),
                density=cat("density"),
                pressure=cat("pressure"),
                real=cat("real"),
                gid=cat("gid"),
            )

        pos_fields = combined_fields(blocked)
        force_fields = combined_fields
    elif exchange == "halo":
        # -------- surface-block halo exchange --------
        self_index = jnp.arange(nb_local, dtype=jnp.int32)
        inf = jnp.float32(3.0e38)
        row_shard = jnp.arange(n_shards * halo_max, dtype=jnp.int32) // halo_max
        mine = row_shard == shard
        # shard spatial boxes (from the real-particle bounds above)
        sh_min = gather(local_min[None, :])  # (n_shards, 3)
        sh_max = gather(local_max[None, :])
        # does block b's dilated bbox reach any REMOTE shard's box?
        hdil = jnp.float32(params.h)
        other = jnp.arange(n_shards) != shard  # (n_shards,)
        # bmin/bmax are (nb_l, 2, 3) split boxes
        reach = jnp.any(
            other[None, None, :]
            & jnp.all(
                (bmin[:, :, None, :] - hdil <= sh_max[None, None, :, :])
                & (bmax[:, :, None, :] + hdil >= sh_min[None, None, :, :]),
                axis=-1,
            ),
            axis=(1, 2),
        )  # (nb_l,)
        surf_idx, surf_valid, surf_ovf = _compact_mask(reach, halo_max)

        s_bmin = jnp.where(
            surf_valid[:, None, None], jnp.take(bmin, surf_idx, axis=0),
            inf,
        )
        s_bmax = jnp.where(
            surf_valid[:, None, None], jnp.take(bmax, surf_idx, axis=0),
            -inf,
        )
        g_s_bmin = gather(s_bmin)  # (n_shards*halo_max, 2, 3)
        g_s_bmax = gather(s_bmax)
        # my own surface rows must not duplicate my local blocks
        g_s_bmin = jnp.where(mine[:, None, None], inf, g_s_bmin)
        g_s_bmax = jnp.where(mine[:, None, None], -inf, g_s_bmax)

        comb_bmin = jnp.concatenate([bmin, g_s_bmin], axis=0)
        comb_bmax = jnp.concatenate([bmax, g_s_bmax], axis=0)
        cand, count, cand_ovf = tiles_ops.candidate_blocks(
            bmin, bmax, params.h, cfg.max_candidates,
            comb_bmin, comb_bmax, self_index=self_index,
        )
        overflow = cand_ovf | surf_ovf

        def take_blocks(a):
            return jnp.take(a, surf_idx, axis=0)

        def combined_fields(blk):
            surf = tiles_ops.BlockedFields(
                position=gather(take_blocks(blk.position)),
                velocity=gather(take_blocks(blk.velocity)),
                density=gather(take_blocks(blk.density)),
                pressure=gather(take_blocks(blk.pressure)),
                real=gather(take_blocks(blk.real) & surf_valid[:, None]),
                gid=gather(take_blocks(blk.gid)),
            )
            # invalidate my own rows in the gathered table
            surf = surf._replace(real=surf.real & ~mine[:, None])
            return tiles_ops.BlockedFields(
                *[
                    jnp.concatenate([lo, hi], axis=0)
                    for lo, hi in zip(blk, surf)
                ]
            )

        pos_fields = combined_fields(blocked)
        force_fields = combined_fields
    else:
        self_index = shard * nb_local + jnp.arange(nb_local, dtype=jnp.int32)
        cand, count, overflow = tiles_ops.candidate_blocks(
            bmin, bmax, params.h, cfg.max_candidates, g_bmin, g_bmax,
            self_index=self_index,
        )

        pos_fields = tiles_ops.BlockedFields(
            position=g_blocked_pos,
            velocity=g_blocked_pos,  # unused in density
            density=g_real.astype(jnp.float32),  # unused in density
            pressure=g_real.astype(jnp.float32),  # unused
            real=g_real,
            gid=g_gid,
        )

        def force_fields(blk):
            return tiles_ops.BlockedFields(
                position=g_blocked_pos,
                velocity=gather(blk.velocity),
                density=gather(blk.density),
                pressure=gather(blk.pressure),
                real=g_real,
                gid=g_gid,
            )

    # ---- density + forces over the exchanged candidate tables
    density, pressure, accel = block_passes(
        blocked, cand, count, params, config,
        cand_fields=pos_fields, force_fields=force_fields,
    )
    cap_flags = overflow.astype(jnp.int32) * FLAG_CAPACITY
    accel = jnp.where(valid_s[:, None], accel, 0.0)

    state_s = state_s.replace(
        density=density, pressure=pressure, acceleration=accel
    )

    # ---- 4. adaptive-dt advect+collide with global pmax agreement
    def global_dt(velocity, acceleration):
        mv2 = jnp.max(
            jnp.where(valid_s, jnp.sum(velocity * velocity, axis=-1), 0.0)
        )
        ma2 = jnp.max(
            jnp.where(valid_s, jnp.sum(acceleration * acceleration, axis=-1), 0.0)
        )
        mv2 = jax.lax.pmax(mv2, AXIS)
        ma2 = jax.lax.pmax(ma2, AXIS)
        max_vel = jnp.sqrt(mv2)
        max_accel = jnp.maximum(jnp.sqrt(ma2), 1e-12)
        dt_new = (jnp.sqrt(2.0 * max_accel * params.h + mv2) - max_vel) / (
            2.0 * max_accel
        )
        return jnp.clip(dt_new, integrate_ops.DT_MIN, params.max_dt)

    def advance(dt_try):
        new_state = _advect_collide(state_s, scene, dt_try, params)
        # freeze sentinels in place
        new_state = jax.tree.map(
            lambda new, old: jnp.where(
                valid_s.reshape((-1,) + (1,) * (new.ndim - 1)), new, old
            ),
            new_state,
            state_s,
        )
        return new_state, global_dt(new_state.velocity, new_state.acceleration)

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

    flags = (
        cap_flags
        + grid_bad.astype(jnp.int32) * FLAG_GRID_DIM
        + exchange_bad.astype(jnp.int32) * FLAG_EXCHANGE
    )
    # cross-shard combine must be a bitwise OR, not a plain max: two
    # shards flagging DIFFERENT bits (e.g. CAPACITY=1 on one, EXCHANGE=4
    # on another) would lose the smaller bit under pmax of the packed
    # field. pmax per bit == OR.
    bit = jnp.arange(8, dtype=jnp.int32)
    bits = jax.lax.pmax((flags >> bit) & 1, AXIS)
    flags = jnp.sum(bits << bit)
    return final_state, dt_out, flags


def _local_frame(
    state: ParticleState,
    dt: jnp.ndarray,
    timeleft: jnp.ndarray,
    params: SimulationParameters,
    scene: Optional[collisions_ops.DeviceScene],
    config: StepConfig,
    n_shards: int,
    exchange: str,
    halo_max: int,
    halo_hops: int,
):
    """A frame's substep loop on device under shard_map — the sharded
    twin of engine.step.frame_jit (sph_simulation.cpp:384-409): carries
    (state, dt, timeleft, flags, k) through a lax.while_loop whose body
    is the full _local_substep (collectives included), bounded by
    config.substeps_per_dispatch. The host fetches ONE scalar per
    dispatch instead of one dt per substep.

    Honours StepConfig.sort_interval like frame_jit: re-sorts run on
    the dispatch's first substep and every k-th after it."""
    cap = jnp.int32(config.substeps_per_dispatch)
    interval = int(config.sort_interval)
    run = partial(
        _local_substep, params=params, scene=scene, config=config,
        n_shards=n_shards, exchange=exchange, halo_max=halo_max,
        halo_hops=halo_hops,
    )

    def cond(carry):
        _, _, tl, _, k = carry
        return (tl > 0.0) & (k < cap)

    def body(carry):
        st, dt_cur, tl, flags, k = carry
        do_sort = True if interval <= 1 else (k % interval == 0)
        st, dt_next, step_flags = run(st, dt_cur, do_sort=do_sort)
        tl = tl - dt_next
        dt_next = jnp.where(tl < dt_next, tl, dt_next)
        return st, dt_next, tl, flags | step_flags, k + 1

    state, dt, timeleft, flags, _ = jax.lax.while_loop(
        cond, body, (state, dt, timeleft, jnp.int32(0), jnp.int32(0))
    )
    return state, dt, timeleft, flags


def make_sharded_frame(
    mesh: Mesh,
    params: SimulationParameters,
    scene: Optional[collisions_ops.DeviceScene],
    config: StepConfig,
    exchange: str = "all_gather",
    halo_max: int = 0,
    halo_hops: int = 1,
):
    """Build the jitted sharded FRAME dispatch (see :func:`_local_frame`);
    call as ``frame(state, dt, timeleft) -> (state, dt, timeleft, flags)``."""
    n_shards = mesh.shape[AXIS]
    pspec = P(AXIS)
    state_specs = ParticleState(
        position=pspec,
        velocity=pspec,
        intermediate_velocity=pspec,
        acceleration=pspec,
        density=pspec,
        pressure=pspec,
        grid_index=pspec,
    )
    fn = jax.shard_map(
        partial(
            _local_frame,
            params=params,
            scene=scene,
            config=config,
            n_shards=n_shards,
            exchange=exchange,
            halo_max=halo_max,
            halo_hops=halo_hops,
        ),
        mesh=mesh,
        in_specs=(state_specs, P(), P()),
        out_specs=(state_specs, P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def make_sharded_substep(
    mesh: Mesh,
    params: SimulationParameters,
    scene: Optional[collisions_ops.DeviceScene],
    config: StepConfig,
    exchange: str = "all_gather",
    halo_max: int = 0,
    halo_hops: int = 1,
):
    """Build the jitted sharded substep for a mesh.

    Expects state arrays pre-padded so N_padded is divisible by
    (n_shards * block_size); see :func:`pad_for_mesh`. ``exchange`` /
    ``halo_max``: see :func:`_local_substep`.
    """
    n_shards = mesh.shape[AXIS]
    pspec = P(AXIS)
    state_specs = ParticleState(
        position=pspec,
        velocity=pspec,
        intermediate_velocity=pspec,
        acceleration=pspec,
        density=pspec,
        pressure=pspec,
        grid_index=pspec,
    )

    fn = jax.shard_map(
        partial(
            _local_substep,
            params=params,
            scene=scene,
            config=config,
            n_shards=n_shards,
            exchange=exchange,
            halo_max=halo_max,
            halo_hops=halo_hops,
        ),
        mesh=mesh,
        in_specs=(state_specs, P()),
        out_specs=(state_specs, P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def pad_for_mesh(
    state: ParticleState, params: SimulationParameters, mesh: Mesh, config: StepConfig
) -> ParticleState:
    """Pad + Morton-partition the state across the mesh (host side).

    Sentinel rows get non-finite-ish far positions; they are detected
    on device by magnitude and frozen.
    """
    from .mesh import morton_partition

    n = state.position.shape[0]
    n_shards = mesh.shape[AXIS]
    chunk = n_shards * config.block_size
    n_pad = (-n) % chunk

    order = morton_partition(np.asarray(state.position), n_shards)
    state = jax.tree.map(lambda a: jnp.take(a, jnp.asarray(order), axis=0), state)

    if n_pad:
        far = jnp.float32(1.0e32)

        def pad(a):
            fill = jnp.zeros((n_pad,) + a.shape[1:], a.dtype)
            return jnp.concatenate([a, fill], axis=0)

        state = jax.tree.map(pad, state)
        state = state.replace(
            position=state.position.at[n:].set(far),
            density=state.density.at[n:].set(params.fluid_density),
        )
    return state


def dryrun(n_devices: int) -> None:
    """Driver hook: build an n_devices mesh, jit the FULL sharded step,
    run one step on tiny shapes, sanity-check the result."""
    import jax

    devices = jax.devices()[:n_devices]
    assert len(devices) == n_devices, (
        f"need {n_devices} devices, have {len(jax.devices())}"
    )
    mesh = Mesh(np.asarray(devices), (AXIS,))

    from ..core.params import derive_parameters
    from ..core.state import init_state

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
        particles_count=2048,
        particle_mass=0.05,
        simulation_time=3,
        target_fps=60,
        simulation_scale=0.1,
        constant_acceleration=dict(x=0, y=-9.8, z=0),
    )
    params = derive_parameters(fluid, sim)
    config = StepConfig(neighbor_impl="tiles", block_size=64, max_candidates=32)

    state = init_state(params)
    state = pad_for_mesh(state, params, mesh, config)
    sharding = NamedSharding(mesh, P(AXIS))
    state = jax.tree.map(lambda a: jax.device_put(a, sharding), state)

    step = make_sharded_substep(mesh, params, None, config)
    out_state, dt, flags = step(state, jnp.float32(params.max_dt))
    assert not int(flags)
    jax.block_until_ready(out_state.position)

    pos = np.asarray(out_state.position)
    real = np.abs(pos).max(axis=1) < 1.0e30
    assert real.sum() == params.particles_count, (
        real.sum(),
        params.particles_count,
    )
    assert np.isfinite(pos[real]).all()
    rho = np.asarray(out_state.density)[real]
    assert rho.min() > 0, rho.min()
    assert float(dt) > 0

    # also exercise the point-to-point ppermute ring exchange under the
    # mesh (full ring coverage) WITH a DF collision scene (a 2-triangle
    # floor under the lattice) so the sharded collision path
    # (collisionsv2.cl:249-336 under the mesh) is certified too, on the
    # platform's own neighbour path
    from ..scene.obj_loader import ObjMesh
    from ..scene.scene import Scene

    floor = ObjMesh(
        vertices=np.asarray(
            [[-2, -0.5, -2], [2, -0.5, -2], [2, -0.5, 2], [-2, -0.5, 2]],
            np.float32,
        ),
        triangles=np.asarray([[0, 2, 1], [0, 3, 2]], np.int32),
    )
    dev_scene = collisions_ops.build_device_scene(
        Scene.from_mesh(floor, params.h * 2.0)
    )
    nb_local = state.position.shape[0] // n_devices // config.block_size
    config_p = StepConfig(
        block_size=config.block_size, max_candidates=config.max_candidates,
    )
    step_ring = make_sharded_substep(
        mesh, params, dev_scene, config_p, exchange="ring",
        halo_max=nb_local, halo_hops=(n_devices + 1) // 2,
    )
    out2, dt2, flags2 = step_ring(state, jnp.float32(params.max_dt))
    assert not int(flags2), int(flags2)
    pos2 = np.asarray(out2.position)
    real2 = np.abs(pos2).max(axis=1) < 1.0e30
    assert real2.sum() == params.particles_count
    assert np.isfinite(pos2[real2]).all()
    assert float(dt2) > 0

    # and the device-side frame loop (make_sharded_frame) with the
    # sort cadence: a whole frame's substeps in one dispatch, one
    # scalar fetched back
    config_c = dataclasses.replace(config_p, sort_interval=2)
    frame = make_sharded_frame(mesh, params, dev_scene, config_c)
    out3, dt3, timeleft3, flags3 = frame(
        state, jnp.float32(params.max_dt), jnp.float32(params.frame_time)
    )
    assert not int(flags3), int(flags3)
    assert float(timeleft3) <= 0.0 or float(dt3) > 0.0
    pos3 = np.asarray(out3.position)
    real3 = np.abs(pos3).max(axis=1) < 1.0e30
    assert real3.sum() == params.particles_count
    assert np.isfinite(pos3[real3]).all()
