"""LSD radix sort over Morton cell codes — the reference's sort pipeline
in plain XLA.

The reference sorts (code, index) pairs with a hand-rolled 4-pass
radix sort + Blelloch scans (sort.cl:1-200, host orchestration
sph_simulation.cpp:110-198): per pass, per-workgroup digit histograms,
a global exclusive scan, then a scatter. This module is the same
algorithm re-expressed in XLA ops:

* **Block-local scans are matrix products.** A stable radix pass needs,
  for every element, its rank among same-digit elements. Per block of
  ``block`` elements we one-hot the digits to a 0/1 matrix ``(block,
  D)`` and multiply by a lower-triangular ones matrix — an inclusive
  column scan as ONE ``(block, block) @ (block, D)`` matmul, batched
  over all blocks. bf16 operands / f32 accumulation is exact: products
  are 0/1 and every count is an integer <= block <= 256 < 2^24.
* **The global scan is tiny.** Block histograms are the scan's last
  row; a single ``cumsum`` over the digit-major flattened ``(D, nb)``
  table yields the classic radix offsets (counts are integers <= n
  < 2^24, exact in f32).
* **The scatter is XLA's.** Destinations are a permutation, so the
  apply step is two 1D scatters with ``unique_indices=True`` — the
  only data movement per pass (the reference's scatter kernel,
  sort.cl:150-200).

Every pass is stable (offsets + in-order local ranks), so the result
is bit-identical to ``jax.lax.sort_key_val`` (also stable), which
remains the default backend; ``LIBCLSPH_TPU_SORT=radix`` switches
``grid.sort_by_cell`` to this implementation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Morton codes are 3 x 10-bit coordinates (core/morton.py; the
# reference's 1024-cells-per-axis guard, sph_simulation.cpp:700-728).
MORTON_BITS = 30


def _apply_dest(keys, vals, dest, mode):
    """Move (keys, vals) to their destination slots.

    ``scatter``: two n-sized scatters (the reference's scatter kernel
    shape, sort.cl:150-200). ``gather``: ONE iota scatter builds the
    inverse permutation, then keys/vals move via gathers, trading 2n
    scattered elements for n scattered + 2n gathered. Equal results.
    """
    if mode == "gather":
        inv = jnp.zeros_like(dest).at[dest].set(
            jnp.arange(dest.shape[0], dtype=dest.dtype),
            unique_indices=True,
            mode="promise_in_bounds",
        )
        return keys[inv], vals[inv]
    out_k = jnp.zeros_like(keys).at[dest].set(
        keys, unique_indices=True, mode="promise_in_bounds"
    )
    out_v = jnp.zeros_like(vals).at[dest].set(
        vals, unique_indices=True, mode="promise_in_bounds"
    )
    return out_k, out_v


def _radix_pass(keys, vals, shift, *, bits, block, apply):
    """One stable counting-sort pass on digit ``(keys >> shift) & mask``."""
    n = keys.shape[0]
    nb = n // block
    d = 1 << bits
    digits = jax.lax.shift_right_logical(
        keys, jnp.uint32(shift)
    ).astype(jnp.int32) & (d - 1)
    dg = digits.reshape(nb, block)
    onehot = (dg[..., None] == jnp.arange(d, dtype=jnp.int32)).astype(
        jnp.bfloat16
    )  # (nb, block, d) 0/1
    tri = jnp.tril(jnp.ones((block, block), jnp.bfloat16))
    # scan[b, i, k] = #{j <= i in block b : digit[j] == k}  (inclusive)
    scan = jnp.einsum(
        "ij,bjk->bik", tri, onehot, preferred_element_type=jnp.float32
    )
    onef = onehot.astype(jnp.float32)
    local = jnp.sum(scan * onef, axis=-1)  # (nb, block) in-block rank, 1-based
    hist = scan[:, -1, :]  # (nb, d) block histograms
    # digit-major exclusive scan: offset of (digit k, block b) =
    # all counts of digits < k plus counts of k in blocks < b
    flat = hist.T.reshape(-1)  # (d * nb,)
    ex = (jnp.cumsum(flat) - flat).reshape(d, nb).T  # (nb, d)
    base = jnp.sum(ex[:, None, :] * onef, axis=-1)  # (nb, block)
    dest = (base + local - 1.0).astype(jnp.int32).reshape(-1)
    return _apply_dest(keys, vals, dest, apply)


@functools.partial(
    jax.jit,
    static_argnames=("num_bits", "bits_per_pass", "block", "apply"),
)
def radix_sort_key_val(
    keys: jnp.ndarray,
    vals: jnp.ndarray,
    *,
    num_bits: int = MORTON_BITS,
    bits_per_pass: int = 5,
    block: int = 128,
    apply: str = "scatter",
):
    """Stable radix sort of ``(keys, vals)`` by ``keys``.

    Bit-identical to ``jax.lax.sort_key_val`` for keys that fit in
    ``num_bits`` unsigned bits. ``block`` is the scan tile (local ranks
    stay <= block; block <= 256 keeps the bf16 0/1 accumulation
    exact). ``apply`` picks how each pass moves data: "scatter" (2 scatters)
    or "gather" (1 inverse-permutation scatter + 2 gathers).
    """
    if keys.ndim != 1 or vals.shape != keys.shape:
        raise ValueError("radix_sort_key_val expects matching 1D arrays")
    if block > 256 or block % 128:
        raise ValueError("block must be 128 or 256")
    if apply not in ("scatter", "gather"):
        raise ValueError("apply must be 'scatter' or 'gather'")
    n = keys.shape[0]
    kind = keys.dtype
    keys = keys.astype(jnp.uint32)
    pad = (-n) % block
    if pad:
        # max in-range key, appended AFTER the real elements: stable
        # passes keep pads behind every real tie, so [:n] is exact
        keys = jnp.concatenate(
            [keys, jnp.full((pad,), (1 << num_bits) - 1, jnp.uint32)]
        )
        vals = jnp.concatenate([vals, jnp.zeros((pad,), vals.dtype)])
    for shift in range(0, num_bits, bits_per_pass):
        bits = min(bits_per_pass, num_bits - shift)
        keys, vals = _radix_pass(
            keys, vals, shift, bits=bits, block=block, apply=apply
        )
    return keys[:n].astype(kind), vals[:n]
