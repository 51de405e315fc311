"""libclsph-tpu — a Smoothed Particle Hydrodynamics framework in JAX.

A ground-up JAX/XLA/Pallas re-design with the capabilities of the
OpenCL/CUDA reference library ``libclsph`` (see SURVEY.md): Tait-EOS
compressible liquid SPH, Morton-grid neighbour search, triangle-mesh
collision via precomputed signed distance fields, Houdini .geo/.bgeo
frame export, checkpoint/resume, adaptive time stepping — plus
multi-device scaling over a ``jax.sharding.Mesh`` that the reference
never had. The hot density/force passes run as fused Pallas kernels
on NVIDIA GPUs and as plain XLA elsewhere (libclsph_tpu/platform.py).
"""

from .core.params import (
    PrecomputedKernelValues,
    SimulationParameters,
    derive_parameters,
    load_parameters,
)
from .core.state import ParticleState, init_state
from .engine.simulation import SPHSimulation
from .engine.step import StepConfig, frame_jit, substep_jit
from .io.houdini import HoudiniFileSaver
from .models.presets import PRESETS, Preset, get_preset
from .scene.scene import Scene

__version__ = "0.1.0"

__all__ = [
    "PrecomputedKernelValues",
    "SimulationParameters",
    "derive_parameters",
    "load_parameters",
    "ParticleState",
    "init_state",
    "SPHSimulation",
    "StepConfig",
    "substep_jit",
    "frame_jit",
    "HoudiniFileSaver",
    "PRESETS",
    "Preset",
    "get_preset",
    "Scene",
    "__version__",
]
