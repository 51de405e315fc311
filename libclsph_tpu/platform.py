"""Where the program runs: the neighbour path for each platform and the
persistent compile cache.

The CLI, ``bench.py``, ``chip_smoke.py`` and the ``StepConfig`` default
take their neighbour path from :func:`neighbor_impl`; nothing else
branches on the platform.
"""

from __future__ import annotations

import os
import subprocess

import jax

# platform -> StepConfig.neighbor_impl. 'fused' is the GPU kernel pair
# of ops/pallas/neighbor_gpu.py; 'tiles' the plain-XLA block tiles.
NEIGHBOR_IMPL = {"gpu": "fused", "cpu": "tiles"}

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def neighbor_impl(platform: str | None = None) -> str:
    """The neighbour path for ``platform`` (default: JAX's default
    backend). An unknown platform is an error, not a fallback."""
    platform = platform or jax.default_backend()
    try:
        return NEIGHBOR_IMPL[platform]
    except KeyError:
        raise ValueError(
            f"no neighbour path for platform {platform!r}; "
            f"supported: {sorted(NEIGHBOR_IMPL)}"
        ) from None


def gpu_card() -> str | None:
    """The first GPU's name and power limit as nvidia-smi reports them
    (``"NVIDIA H100 80GB HBM3, 700.00 W"``), read by a child process;
    None where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.stdout.strip().splitlines()[0]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here. Otherwise the cache lives at a fixed path,
    ``<repo>/.jax_cache``, so a later run finds what an earlier one
    compiled (the directory is part of the cache key)."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
