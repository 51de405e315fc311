"""Device mesh helpers for multi-device SPH.

The reference is strictly single-device (init_cl_single_device,
util/cl_boilerplate.cpp:3-63; SURVEY.md §2.3). Multi-device scaling is
a new capability: a 1-D ``jax.sharding.Mesh`` over the "dp" axis with
particles spatially (Morton-range) decomposed across devices. The mesh
follows the algorithm alone: the cards of one host reach each other all
to all over NVLink, so no device order is preferred.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "dp"


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


def particle_sharding(mesh: Mesh) -> NamedSharding:
    """Shard leading (particle) dimension across the dp axis."""
    return NamedSharding(mesh, P(AXIS))


def morton_partition(position: np.ndarray, n_shards: int) -> np.ndarray:
    """Host-side global spatial decomposition: a permutation that
    Morton-orders particles so each shard owns a compact region.

    Run once at initialisation (and optionally at rebalance points);
    per-step ordering within a shard is maintained on device.
    """
    from ..core import morton as morton_mod
    import jax.numpy as jnp

    pos = np.asarray(position, dtype=np.float32)
    lo = pos.min(axis=0)
    hi = pos.max(axis=0)
    cell = np.maximum((hi - lo) / 1023.0, 1e-12)
    coords = np.clip(((pos - lo) / cell), 0, 1023).astype(np.uint32)
    codes = np.asarray(
        morton_mod.encode(
            jnp.asarray(coords[:, 0]),
            jnp.asarray(coords[:, 1]),
            jnp.asarray(coords[:, 2]),
        )
    )
    return np.argsort(codes, kind="stable")
