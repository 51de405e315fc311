"""Spatial-hash grid: bounds, cell assignment, sort, cell-range lookup.

Redesign of the reference's grid machinery for a jitted device step:

* Bounds (min/max position + 2-cell padding, sph_simulation.cpp:634-728)
  are computed **on device** with ``jnp.min/max`` inside the jitted step
  instead of a two-stage OpenCL reduction plus blocking host reads.
* Cell assignment (locate_in_grid, grid.cl:40-64) is a vectorised
  floor-divide + Morton encode.
* The hand-rolled 4-pass radix sort + Blelloch scan (sort.cl:1-200,
  sph_simulation.cpp:110-198) is replaced by ``jax.lax.sort_key_val``
  over the 30-bit Morton keys — XLA lowers this to an efficient
  on-device sort and it is autodiff/SPMD friendly.
* The dense ``cell_table`` (fill_cell_table, sort.cl:62-79) is replaced
  by binary search over the *sorted key array* (``jnp.searchsorted``):
  cell_table[c] == searchsorted(keys, c, 'left'), which sidesteps the
  dynamic ``grid_cell_count``-sized allocation XLA cannot express.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import morton
from ..core.params import SimulationParameters
from ..core.state import ParticleState
from . import radix_sort

# "xla" (lax.sort_key_val) | "radix" (ops/radix_sort.py matrix-scan
# radix over the 30-bit Morton keys). Both stable -> bit-identical.
_SORT_IMPL = os.environ.get("LIBCLSPH_TPU_SORT", "xla")
# radix only: Morton bits to sort. 30 is always safe (the 1024-cell
# grid guard); a run whose grid never exceeds 2^(b/3) cells per axis
# can drop to b bits and skip whole passes. Checked against the
# dynamic grid on device: grid_exceeds_sort_bits feeds FLAG_GRID_DIM
# so an outgrown grid aborts like the reference's 1024-cell assert
# (sph_simulation.cpp:722-724) instead of silently missorting.
_SORT_BITS = int(os.environ.get("LIBCLSPH_TPU_SORT_BITS", "30"))
# radix only: per-pass data movement, "scatter" | "gather" (see
# radix_sort._apply_dest).
_SORT_APPLY = os.environ.get("LIBCLSPH_TPU_SORT_APPLY", "scatter")


class GridInfo(NamedTuple):
    """Dynamic per-substep grid geometry (traced values, static shapes).

    Mirrors the dynamic tail of simulation_parameters
    (structures.h:33-37) that the reference recomputes per substep.
    """

    min_point: jnp.ndarray  # (3,) f32, already includes 2-cell padding
    max_point: jnp.ndarray  # (3,) f32
    grid_size: jnp.ndarray  # (3,) int32
    cell_side: jnp.ndarray  # () f32


def compute_bounds(position: jnp.ndarray, params: SimulationParameters) -> GridInfo:
    """On-device equivalent of findMinMaxPosition (sph_simulation.cpp:634-728).

    Pads min/max by two cell lengths so 3x3x3 neighbourhood coordinates
    never underflow (the reference relies on this padding to keep its
    unsigned cell coords >= 1, :668-702).
    """
    cell = jnp.float32(params.cell_side)
    pmin = jnp.min(position, axis=0) - 2.0 * cell
    pmax = jnp.max(position, axis=0) + 2.0 * cell
    grid_size = ((pmax - pmin) / cell).astype(jnp.int32)
    return GridInfo(min_point=pmin, max_point=pmax, grid_size=grid_size, cell_side=cell)


def locate_in_grid(position: jnp.ndarray, grid: GridInfo) -> jnp.ndarray:
    """Per-particle Morton cell code (locate_in_grid, grid.cl:40-64)."""
    coords = ((position - grid.min_point) / grid.cell_side).astype(jnp.uint32)
    return morton.encode(coords[:, 0], coords[:, 1], coords[:, 2])


def grid_exceeds_sort_bits(grid_size: jnp.ndarray) -> jnp.ndarray:
    """True when the dynamic grid outgrows the configured radix key
    width: with ``b`` sorted bits, codes are only ordered below 2^b,
    which requires every axis to stay <= 2^(b//3) cells. Constant
    False for the default 30 bits or the XLA sort backend, so it folds
    away under jit."""
    if _SORT_IMPL != "radix" or _SORT_BITS >= 30:
        return jnp.asarray(False)
    return jnp.any(grid_size > (1 << (_SORT_BITS // 3)))


def sort_by_cell(state: ParticleState, codes: jnp.ndarray):
    """Sort particles by Morton code.

    Replaces the radix-sort pipeline (sph_simulation.cpp:110-198).
    Returns (sorted_state, sorted_codes, order) where ``order`` maps
    sorted slot -> original index.
    """
    n = codes.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    if _SORT_IMPL == "radix":
        sorted_codes, order = radix_sort.radix_sort_key_val(
            codes, iota, num_bits=_SORT_BITS, apply=_SORT_APPLY,
        )
    else:
        sorted_codes, order = jax.lax.sort_key_val(codes, iota)
    sorted_state = state.permute(order)
    sorted_state = sorted_state.replace(grid_index=sorted_codes)
    return sorted_state, sorted_codes, order


def cell_ranges(
    sorted_codes: jnp.ndarray, query_codes: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """[start, end) index range in the sorted array for each query cell.

    Functional equivalent of get_start_end_indices_for_cell (grid.cl:19-29)
    against the back-filled cell table (sort.cl:62-79):
    start == searchsorted(keys, c, 'left'), end == searchsorted(keys, c, 'right').
    """
    # uint32 searchsorted is fine: codes are 30-bit, no sign issues in int32.
    keys = sorted_codes.astype(jnp.int32)
    q = query_codes.astype(jnp.int32)
    start = jnp.searchsorted(keys, q, side="left")
    end = jnp.searchsorted(keys, q, side="right")
    return start.astype(jnp.int32), end.astype(jnp.int32)
