"""Particle state as a structure-of-arrays pytree.

Replacement for the reference's 60-byte AoS ``particle``
struct (``libclsph/common/structures.h:40-44``): separate contiguous
``jnp`` arrays per field so every pass is a dense vector op over
well-tiled (N,) / (N,3) buffers instead of strided struct loads.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .params import SimulationParameters


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ParticleState:
    """SoA particle state. All arrays share leading dimension N.

    Field set mirrors ``particle`` (structures.h:40-44):
    position / velocity / intermediate_velocity / acceleration (N,3) f32,
    density / pressure (N,) f32, grid_index (N,) uint32.
    """

    position: jnp.ndarray
    velocity: jnp.ndarray
    intermediate_velocity: jnp.ndarray
    acceleration: jnp.ndarray
    density: jnp.ndarray
    pressure: jnp.ndarray
    grid_index: jnp.ndarray

    @property
    def n(self) -> int:
        return self.position.shape[0]

    def replace(self, **kw) -> "ParticleState":
        return dataclasses.replace(self, **kw)

    def permute(self, order: jnp.ndarray) -> "ParticleState":
        """Reorder all fields by ``order`` (the sorted-by-cell gather)."""
        return jax.tree.map(lambda a: jnp.take(a, order, axis=0), self)

    @staticmethod
    def zeros(n: int) -> "ParticleState":
        return ParticleState(
            position=jnp.zeros((n, 3), jnp.float32),
            velocity=jnp.zeros((n, 3), jnp.float32),
            intermediate_velocity=jnp.zeros((n, 3), jnp.float32),
            acceleration=jnp.zeros((n, 3), jnp.float32),
            density=jnp.zeros((n,), jnp.float32),
            pressure=jnp.zeros((n,), jnp.float32),
            grid_index=jnp.zeros((n,), jnp.uint32),
        )


def init_lattice_positions(params: SimulationParameters) -> np.ndarray:
    """Initial cube-lattice particle placement.

    Matches init_particles (sph_simulation.cpp:52-98): particles laid
    out on a cube of side ``cbrt(initial_volume)`` centred in x/z and
    resting on y=0, index-ordered x-fastest then y then z.
    """
    n = params.particles_count
    per_side = int(np.ceil(np.cbrt(n)))
    side_length = float(np.cbrt(params.initial_volume))
    spacing = side_length / per_side

    i = np.arange(n)
    x = (i % per_side).astype(np.float32) * spacing - side_length / 2.0
    y = ((i // per_side) % per_side).astype(np.float32) * spacing
    z = (i // (per_side * per_side)).astype(np.float32) * spacing - side_length / 2.0
    return np.stack([x, y, z], axis=1).astype(np.float32)


def init_state(params: SimulationParameters) -> ParticleState:
    """Fresh state on the default cube lattice with zero velocities."""
    pos = jnp.asarray(init_lattice_positions(params))
    n = params.particles_count
    return ParticleState(
        position=pos,
        velocity=jnp.zeros((n, 3), jnp.float32),
        intermediate_velocity=jnp.zeros((n, 3), jnp.float32),
        acceleration=jnp.zeros((n, 3), jnp.float32),
        density=jnp.zeros((n,), jnp.float32),
        pressure=jnp.zeros((n,), jnp.float32),
        grid_index=jnp.zeros((n,), jnp.uint32),
    )
