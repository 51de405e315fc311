"""Exact 27-cell neighbour gather (reference-parity path).

Reproduces the reference's neighbour iteration structure exactly: for
each particle, the 3x3x3 Morton cells around its cell (forces.cl:24-30)
are resolved to [start, end) ranges in the Morton-sorted particle array
(grid.cl:19-29) and every particle in those ranges is a candidate.

XLA needs static shapes, so each cell's range is padded to
``cell_capacity`` slots with a validity mask ("hard part #1" in
SURVEY.md §7). This path is exact whenever no cell holds more than
``cell_capacity`` particles; overflow is detectable via
:func:`max_cell_occupancy`. It is the clarity/correctness baseline —
the production paths are the block-tile passes of ops/tiles.py.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core import morton
from . import grid as grid_ops


def neighbor_indices(
    sorted_codes: jnp.ndarray, cell_capacity: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Padded candidate indices for every sorted particle.

    Returns (idx, valid): (N, 27 * cell_capacity) int32 indices into the
    sorted arrays and bool mask. Candidates enumerate, per neighbour
    cell, the first ``cell_capacity`` particles of its sorted range.
    """
    codes27 = morton.neighbor_codes(sorted_codes)  # (N, 27)
    start, end = grid_ops.cell_ranges(sorted_codes, codes27)  # (N, 27) each
    k = jnp.arange(cell_capacity, dtype=jnp.int32)  # (C,)
    idx = start[..., None] + k  # (N, 27, C)
    valid = idx < end[..., None]
    n = sorted_codes.shape[0]
    idx = jnp.clip(idx, 0, n - 1)
    return idx.reshape(n, -1), valid.reshape(n, -1)


def max_cell_occupancy(sorted_codes: jnp.ndarray) -> jnp.ndarray:
    """Largest number of particles sharing one cell (overflow check)."""
    start, end = grid_ops.cell_ranges(sorted_codes, sorted_codes)
    return jnp.max(end - start)


def gather_candidates(arr: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Gather per-candidate field values: (N,...) x (N,K) -> (N,K,...)."""
    return jnp.take(arr, idx, axis=0)
