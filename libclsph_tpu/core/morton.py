"""Vectorised 3-D Morton (z-order) curve indexing.

Equivalent of the reference's scalar bit-twiddling helpers
(``libclsph/common/util.h:4-62``): the same 10-bit-per-axis interleave,
but expressed as ``jnp`` uint32 ops over whole arrays so the encode of a
million cell coordinates is a handful of fused vector instructions.

The 10-bit limit (grid dims < 1024 per axis, asserted at
sph_simulation.cpp:722-724) is inherited: codes are 30-bit.
"""

from __future__ import annotations

import jax.numpy as jnp

MAX_GRID_DIM = 1024  # 10 bits per axis


def _part1by2(v: jnp.ndarray) -> jnp.ndarray:
    """Spread the low 10 bits of each lane out to every 3rd bit.

    Same mask sequence as get_grid_index_z_curve (util.h:41-62).
    """
    v = v.astype(jnp.uint32)
    v = (v | (v << 16)) & jnp.uint32(0x030000FF)
    v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
    v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
    v = (v | (v << 2)) & jnp.uint32(0x09249249)
    return v


def _compact1by2(v: jnp.ndarray) -> jnp.ndarray:
    """Inverse of _part1by2 (uninterleave, util.h:4-19)."""
    v = v.astype(jnp.uint32) & jnp.uint32(0x09249249)
    v = (v | (v >> 2)) & jnp.uint32(0x030C30C3)
    v = (v | (v >> 4)) & jnp.uint32(0x0300F00F)
    v = (v | (v >> 8)) & jnp.uint32(0x030000FF)
    v = (v | (v >> 16)) & jnp.uint32(0x000003FF)
    return v


def encode(x: jnp.ndarray, y: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
    """Interleave three 10-bit coordinate arrays into Morton codes.

    Matches get_grid_index_z_curve (util.h:41-62): x in bit 0, y in
    bit 1, z in bit 2.
    """
    return _part1by2(x) | (_part1by2(y) << 1) | (_part1by2(z) << 2)


def decode(code: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Morton code -> (x, y, z) cell coordinates.

    Matches get_cell_coords_z_curve (util.h:21-38).
    """
    code = code.astype(jnp.uint32)
    return _compact1by2(code), _compact1by2(code >> 1), _compact1by2(code >> 2)


def neighbor_codes(code: jnp.ndarray) -> jnp.ndarray:
    """Morton codes of the 3x3x3 neighborhood of each input cell.

    Returns shape ``code.shape + (27,)``. Mirrors the triple loop over
    cell_coords +/- 1 in compute_density_with_grid (forces.cl:24-27).
    Assumes coords >= 1 (guaranteed by the 2-cell bound padding the
    engine applies, sph_simulation.cpp:668-702).
    """
    x, y, z = decode(code)
    out = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                out.append(
                    encode(
                        (x.astype(jnp.int32) + dx).astype(jnp.uint32),
                        (y.astype(jnp.int32) + dy).astype(jnp.uint32),
                        (z.astype(jnp.int32) + dz).astype(jnp.uint32),
                    )
                )
    return jnp.stack(out, axis=-1)
