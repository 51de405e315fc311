"""Checkpoint / resume of the particle state.

Equivalent of the reference's cereal raw-binary dump of the
AoS particle array to ``last_frame.bin`` (example/particles.cpp:35-40,
restore at sph_simulation.cpp:63-71): a single ``.npz`` with the SoA
arrays plus a parameter fingerprint, so stale checkpoints (different N
or physics) are rejected up front — the reference only checks file
size (particles.cpp:74-95).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np

from ..core.params import SimulationParameters
from ..core.state import ParticleState

DEFAULT_CHECKPOINT = "last_frame.npz"

_FINGERPRINT_FIELDS = (
    "particles_count",
    "fluid_density",
    "particle_mass",
    "dynamic_viscosity",
    "h",
    "K",
    "restitution",
    "surface_tension",
    "surface_tension_threshold",
)


def params_fingerprint(params: SimulationParameters) -> str:
    data = {k: getattr(params, k) for k in _FINGERPRINT_FIELDS}
    return hashlib.sha256(
        json.dumps(data, sort_keys=True).encode()
    ).hexdigest()[:16]


def save_checkpoint(
    path: str, state_arrays: dict, params: SimulationParameters
) -> None:
    """``state_arrays``: field name -> np.ndarray (host copies)."""
    tmp = path + ".tmp"
    np.savez(
        tmp if tmp.endswith(".npz") else tmp,
        fingerprint=np.frombuffer(
            params_fingerprint(params).encode(), dtype=np.uint8
        ),
        **state_arrays,
    )
    # np.savez appends .npz to paths without it
    written = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(written, path)


def load_checkpoint(
    path: str, params: SimulationParameters
) -> Optional[dict]:
    """Returns field dict or None (missing / stale checkpoint).

    Raises ValueError on a fingerprint/size mismatch, mirroring the
    reference's refusal to run with a wrong-size last_frame.bin
    (particles.cpp:89-92).
    """
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        fp = bytes(z["fingerprint"]).decode()
        if fp != params_fingerprint(params):
            raise ValueError(
                f"checkpoint {path} was written with different simulation "
                "parameters; delete it to start fresh"
            )
        arrays = {k: z[k] for k in z.files if k != "fingerprint"}
    n = params.particles_count
    for k, v in arrays.items():
        if v.shape[0] != n:
            raise ValueError(
                f"checkpoint field {k} has {v.shape[0]} particles, expected {n}"
            )
    return arrays


def state_to_arrays(state: ParticleState) -> dict:
    # np.array (not asarray): jax arrays surface as read-only host
    # views, but the pre/post-frame callback contract lets user code
    # mutate these buffers in place (sph_simulation.cpp:730-768).
    return {
        "position": np.array(state.position),
        "velocity": np.array(state.velocity),
        "intermediate_velocity": np.array(state.intermediate_velocity),
        "acceleration": np.array(state.acceleration),
        "density": np.array(state.density),
        "pressure": np.array(state.pressure),
        "grid_index": np.array(state.grid_index),
    }
