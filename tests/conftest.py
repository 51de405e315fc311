import os
import sys

# The tests run on the CPU unless JAX_PLATFORMS names a platform: the
# gpu-marked tests run on an NVIDIA card (python chip_smoke.py runs
# them, or JAX_PLATFORMS=cuda python -m pytest -m gpu tests/).
# Multi-device tests use a virtual 8-device CPU mesh.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# bench.py, chip_smoke.py and experiments/ live at the repository root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import functools  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from libclsph_tpu.core.params import derive_parameters  # noqa: E402

WATER = dict(
    fluid_density=998.29,
    dynamic_viscosity=3.5,
    restitution=0,
    k=100,
    surface_tension_threshold=7.065,
    surface_tension=0.0728,
    particles_inside_influence_radius=20,
)
MUCUS = dict(
    fluid_density=1000,
    dynamic_viscosity=36,
    restitution=0.5,
    k=5,
    surface_tension_threshold=5,
    surface_tension=6,
    particles_inside_influence_radius=40,
)
DEFAULT_SIM = dict(
    particles_count=64000,
    particle_mass=0.05,
    simulation_time=3,
    target_fps=60,
    simulation_scale=0.1,
    write_all_frames=False,
    serialize=False,
    constant_acceleration=dict(x=0, y=-9.8, z=0),
)


def make_params(fluid=WATER, n=1024, **overrides):
    sim = dict(DEFAULT_SIM, particles_count=n, **overrides)
    return derive_parameters(dict(fluid), sim)


@pytest.fixture
def water_params():
    return make_params(WATER, n=1024)


@pytest.fixture
def mucus_params():
    return make_params(MUCUS, n=512)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skips a gpu-marked test unless JAX's first device is a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU (python chip_smoke.py, or "
            "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/)"
        )
    return dev


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Runs the fused GPU kernels in Pallas interpret mode wherever the
    engine calls them, so CPU tests can drive the 'fused' path."""
    from libclsph_tpu.ops.pallas import neighbor_gpu

    for name in ("fused_density", "fused_forces"):
        monkeypatch.setattr(
            neighbor_gpu, name,
            functools.partial(getattr(neighbor_gpu, name), interpret=True),
        )


# ---- slow markers (README "quick set"): the heavy equivalence /
# engine / mesh suites are marked slow so `-m "not slow"` gives an
# iteration loop that fits a small CPU budget; the full suite stays
# the merge gate.
_SLOW_MODULES = {
    "test_golden", "test_engine", "test_parallel", "test_render",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__
        if mod in _SLOW_MODULES or (
            mod == "test_physics" and item.cls is None
        ):
            item.add_marker(pytest.mark.slow)
