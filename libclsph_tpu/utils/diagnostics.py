"""Runtime diagnostics for the neighbour machinery.

The reference validates by runtime assertion and visual inspection
(SURVEY.md §4); this module gives the engine observable health
metrics instead: candidate-capacity statistics, cell occupancy, and a
density sanity summary, all computable on device and cheap to fetch.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.params import SimulationParameters
from ..ops import grid as grid_ops
from ..ops import tiles as tiles_ops


class NeighborStats(NamedTuple):
    count_mean: jnp.ndarray
    count_max: jnp.ndarray
    overflowed: jnp.ndarray
    occupancy_max: jnp.ndarray  # particles in fullest grid cell


def neighbor_stats(
    position: jnp.ndarray,
    params: SimulationParameters,
    block_size: int = 128,
    max_candidates: int = 1024,
) -> NeighborStats:
    """Candidate-list statistics for the current particle distribution.

    Useful to pick StepConfig.max_candidates before a long run (the
    engine can also grow it reactively via the overflow autotune).
    """
    n = position.shape[0]
    pad = (-n) % block_size
    grid = grid_ops.compute_bounds(position, params)
    codes = grid_ops.locate_in_grid(position, grid)
    if pad:
        far = grid.max_point + 1000.0 * params.h
        position = jnp.concatenate(
            [position, jnp.broadcast_to(far, (pad, 3))], axis=0
        )
        codes = jnp.concatenate(
            [codes, jnp.full((pad,), tiles_ops.SENTINEL_CODE, jnp.uint32)]
        )
    order = jnp.argsort(codes)
    pos_sorted = jnp.take(position, order, axis=0)
    real = jnp.take(
        jnp.concatenate([jnp.ones(n, bool), jnp.zeros(pad, bool)]), order
    )

    blocked_pos = pos_sorted.reshape(-1, block_size, 3)
    real_b = real.reshape(-1, block_size)
    bmin, bmax = tiles_ops.split_block_bounds(blocked_pos, real_b)
    _, count, ovf = tiles_ops.candidate_blocks(
        bmin, bmax, params.h, max_candidates
    )
    sorted_codes = jnp.take(codes, order)
    start, end = grid_ops.cell_ranges(sorted_codes, sorted_codes)
    return NeighborStats(
        count_mean=count.mean(),
        count_max=count.max(),
        overflowed=ovf,
        occupancy_max=jnp.max(end - start),
    )


def density_summary(density: jnp.ndarray, params: SimulationParameters) -> dict:
    """Host-side density health check (fraction near rest density)."""
    import numpy as np

    d = np.asarray(density)
    rho0 = params.fluid_density
    return {
        "min": float(d.min()),
        "max": float(d.max()),
        "mean": float(d.mean()),
        "frac_within_10pct_rest": float(
            np.mean(np.abs(d - rho0) < 0.1 * rho0)
        ),
        "any_nonfinite": bool(~np.isfinite(d).all()),
    }
