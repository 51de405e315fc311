"""Radix sort (ops/radix_sort.py) — bit-equality with lax.sort_key_val.

The reference's radix pipeline (sort.cl:1-200, sph_simulation.cpp:
110-198) is covered functionally by lax.sort_key_val; these tests pin
the hand-built matrix-scan radix sort as an exact drop-in (stability
included), so the engine can switch sort backends.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libclsph_tpu.ops.radix_sort import radix_sort_key_val


def _ref(keys, vals):
    k, v = jax.lax.sort_key_val(keys, vals)
    return np.asarray(k), np.asarray(v)


@pytest.mark.parametrize("n", [128, 256, 300, 4096, 65536])
@pytest.mark.parametrize("bits_per_pass", [4, 5, 6])
def test_matches_lax_sort(rng, n, bits_per_pass):
    keys = jnp.asarray(
        rng.integers(0, 1 << 30, size=n, dtype=np.uint32)
    )
    vals = jnp.arange(n, dtype=jnp.int32)
    k, v = radix_sort_key_val(keys, vals, bits_per_pass=bits_per_pass)
    rk, rv = _ref(keys, vals)
    np.testing.assert_array_equal(np.asarray(k), rk)
    np.testing.assert_array_equal(np.asarray(v), rv)


def test_stability_with_heavy_duplicates(rng):
    """Morton codes repeat ~20x per cell: ties must keep input order
    (both sorts are stable -> the val streams agree exactly)."""
    n = 8192
    keys = jnp.asarray(
        rng.integers(0, 64, size=n, dtype=np.uint32)
    )  # ~128 duplicates per key
    vals = jnp.asarray(rng.permutation(n).astype(np.int32))
    k, v = radix_sort_key_val(keys, vals)
    rk, rv = _ref(keys, vals)
    np.testing.assert_array_equal(np.asarray(k), rk)
    np.testing.assert_array_equal(np.asarray(v), rv)
    # independent stability check vs numpy's stable argsort
    order = np.argsort(np.asarray(keys), kind="stable")
    np.testing.assert_array_equal(
        np.asarray(v), np.asarray(vals)[order]
    )


def test_extreme_keys():
    """All-equal, already-sorted, reversed, and max-code keys."""
    n = 512
    vals = jnp.arange(n, dtype=jnp.int32)
    for keys in [
        jnp.full((n,), (1 << 30) - 1, jnp.uint32),
        jnp.zeros((n,), jnp.uint32),
        jnp.arange(n, dtype=jnp.uint32),
        jnp.arange(n, dtype=jnp.uint32)[::-1],
    ]:
        k, v = radix_sort_key_val(keys, vals)
        rk, rv = _ref(keys, vals)
        np.testing.assert_array_equal(np.asarray(k), rk)
        np.testing.assert_array_equal(np.asarray(v), rv)


def test_block_256(rng):
    keys = jnp.asarray(rng.integers(0, 1 << 30, size=4096, dtype=np.uint32))
    vals = jnp.arange(4096, dtype=jnp.int32)
    k, v = radix_sort_key_val(keys, vals, block=256)
    rk, rv = _ref(keys, vals)
    np.testing.assert_array_equal(np.asarray(k), rk)
    np.testing.assert_array_equal(np.asarray(v), rv)


@pytest.mark.parametrize("impl", ["radix"])
def test_sort_by_cell_radix_backend(rng, monkeypatch, impl):
    """grid.sort_by_cell honours LIBCLSPH_TPU_SORT=radix and the
    backends agree with XLA on a real particle state."""
    from libclsph_tpu.core.state import init_state
    from libclsph_tpu.ops import grid as grid_ops
    from tests.conftest import make_params

    params = make_params(n=512)
    state = init_state(params)
    ginfo = grid_ops.compute_bounds(state.position, params)
    codes = grid_ops.locate_in_grid(state.position, ginfo)
    s_xla, c_xla, o_xla = grid_ops.sort_by_cell(state, codes)
    monkeypatch.setattr(grid_ops, "_SORT_IMPL", impl)
    s_rx, c_rx, o_rx = grid_ops.sort_by_cell(state, codes)
    np.testing.assert_array_equal(np.asarray(c_xla), np.asarray(c_rx))
    np.testing.assert_array_equal(np.asarray(o_xla), np.asarray(o_rx))
    np.testing.assert_array_equal(
        np.asarray(s_xla.position), np.asarray(s_rx.position)
    )


@pytest.mark.parametrize("block", [128, 256])
def test_gather_apply_matches_scatter(rng, block):
    """The inverse-permutation gather apply is a pure data-movement
    swap: results stay bit-identical to the scatter apply."""
    n = 4096
    keys = jnp.asarray(rng.integers(0, 1 << 30, size=n, dtype=np.uint32))
    vals = jnp.asarray(rng.permutation(n).astype(np.int32))
    k, v = radix_sort_key_val(keys, vals, block=block, apply="gather")
    rk, rv = _ref(keys, vals)
    np.testing.assert_array_equal(np.asarray(k), rk)
    np.testing.assert_array_equal(np.asarray(v), rv)


def test_reduced_sort_bits_guard(monkeypatch):
    """A grid outgrowing a reduced LIBCLSPH_TPU_SORT_BITS key width
    must raise the FLAG_GRID_DIM status instead of missorting."""
    from libclsph_tpu.ops import grid as grid_ops

    size = jnp.asarray([9, 4, 4], jnp.int32)  # needs 4 bits on axis 0
    # default config: constant False (folds away under jit)
    assert not bool(grid_ops.grid_exceeds_sort_bits(size))
    monkeypatch.setattr(grid_ops, "_SORT_IMPL", "radix")
    monkeypatch.setattr(grid_ops, "_SORT_BITS", 9)  # 8 cells/axis max
    assert bool(grid_ops.grid_exceeds_sort_bits(size))
    assert not bool(
        grid_ops.grid_exceeds_sort_bits(jnp.asarray([8, 8, 8], jnp.int32))
    )
