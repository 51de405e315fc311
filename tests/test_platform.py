"""The platform map (libclsph_tpu/platform.py): neighbour path per
platform and the compile-cache placement."""

import os

import jax
import pytest

from libclsph_tpu import platform
from libclsph_tpu.engine.step import StepConfig


@pytest.mark.parametrize("name,impl", [("gpu", "fused"), ("cpu", "tiles")])
def test_known_platforms(name, impl):
    assert platform.neighbor_impl(name) == impl


@pytest.mark.parametrize("name", ["rocm", "metal", "neuron"])
def test_unknown_platform_is_an_error(name):
    with pytest.raises(ValueError, match="no neighbour path"):
        platform.neighbor_impl(name)


def test_default_follows_the_backend():
    assert platform.neighbor_impl() == platform.NEIGHBOR_IMPL[
        jax.default_backend()
    ]
    assert StepConfig().neighbor_impl == platform.neighbor_impl()


def test_cache_follows_the_variable(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(platform.CACHE_ENV, str(tmp_path))
    assert platform.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # set nothing


def test_cache_defaults_to_the_repo(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(platform.CACHE_ENV, raising=False)
    try:
        path = platform.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_gpu_card_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert platform.gpu_card() is None
