"""Block-tile neighbour search and the plain-XLA density/force passes.

Design (no counterpart in the reference): after the Morton sort,
consecutive particles are spatially coherent, so we partition the
sorted array into fixed blocks of ``B`` particles and compute
block-level axis-aligned bounding boxes. Two blocks can interact only
if their AABBs, dilated by the support radius h, overlap — a dense
(nb x nb) test that yields a padded per-block candidate list. The
density/force passes then reduce over candidate blocks with dense
(B x B) pairwise tiles (here, in XLA) or with the fused GPU kernels of
ops/pallas/neighbor_gpu.py, which read the same candidate lists.

Compared with a literal port of the reference's 27-cell gather
(forces.cl:24-30):

* every gather is a *contiguous block slice*, not a ragged per-cell
  range — static shapes, unit-stride loads;
* the directional sums are (B,B) @ (B,3) products via
    sum_j A_ij (x_i - x_j) = rowsum(A) * x_i - A @ X;
* correctness does not depend on the tiling: the smoothing kernels'
  hard support cutoff (smoothing.cl) zeroes every candidate beyond h,
  and the dilated-AABB test guarantees every true r<h neighbour is in
  some candidate block. Results equal the exact path up to float
  summation order.

Padding convention: particle arrays are padded to a multiple of B with
sentinel particles whose Morton key is the maximal 30-bit code, so they
sort to the tail; the sentinel mask rides along as ``real``.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import smoothing
from ..core.params import PrecomputedKernelValues, SimulationParameters

# Python int (not a jnp scalar): module-level jnp arrays get captured
# as jaxpr constants, and jax 0.9's dispatch mishandles executables
# with 3+ hoisted constants on repeat calls (buffer-count mismatch).
SENTINEL_CODE = (1 << 30) - 1

# Hierarchical candidate search constants (see candidate_blocks_auto):
# above ~1024 blocks the dense nb x nc overlap matrix (67M elements and
# their scatter at 1M particles) costs more than the physics, so a
# superblock prefilter takes over. The threshold was tuned on the
# accelerator this library was first written for and is not yet
# measured on the GPU. The env override lets tests compile the
# hierarchical path at small n.
HIERARCHICAL_THRESHOLD = int(
    os.environ.get("LIBCLSPH_TPU_HIER_THRESHOLD", "1024")
)
SUPER = 16  # blocks per superblock
# padded candidate superblocks per superblock. Slab-shaped fluids
# (river/labyrinth channels at 1M) measure sb_count up to ~141 — the
# Morton curve over a high-aspect grid produces stringy superblock
# runs whose split boxes overlap ~28% of all superblocks — so the
# default sits above that; candidate_blocks_hierarchical clamps it to
# nsb. Level 2 is chunked, so capacity costs memory only per chunk.
SUPER_CAND = 192


class TileConfig(NamedTuple):
    block_size: int = 128  # B — particles per tile
    max_candidates: int = 64  # padded candidate blocks per block


def num_blocks(n: int, block_size: int) -> int:
    return -(-n // block_size)


def padded_count(n: int, block_size: int) -> int:
    """Particles after sentinel padding: a whole number of blocks AND a
    whole number of SUPER-block groups, so the hierarchical candidate
    search (which needs nb % SUPER == 0) is always available."""
    nb = num_blocks(n, block_size)
    nb = -(-nb // SUPER) * SUPER
    return nb * block_size


def block_bounds(pos_blocked: jnp.ndarray, real_blocked: jnp.ndarray):
    """Per-block AABB over real particles. pos (nb, B, 3), real (nb, B)."""
    big = jnp.float32(3.0e38)
    m = real_blocked[..., None]
    bmin = jnp.min(jnp.where(m, pos_blocked, big), axis=1)
    bmax = jnp.max(jnp.where(m, pos_blocked, -big), axis=1)
    return bmin, bmax


# boxes per block in split_block_bounds. With B=128 the candidate count
# is already near its tiling bound (~(2 + 2h/s)^3 = 33 intersecting
# blocks; measured mean 34-37 at 1M), so extra split boxes mostly trim
# the elongated TAIL (max 64 -> 57 with 4 boxes) — cheap insurance
# against capacity overflows rather than a big mean win.
SPLIT_BOXES = 4


def split_block_bounds(
    pos_blocked: jnp.ndarray, real_blocked: jnp.ndarray, n_boxes: int = SPLIT_BOXES
):
    """``n_boxes`` AABBs per block, split at the largest intra-block
    spatial gaps.

    The Morton curve jumps across octant boundaries, so a fixed-size
    block can contain several distant particle runs; a single AABB then
    spans the gaps and overlaps far more blocks than the particles do
    (observed 210 overlaps vs ~10 real at 64k with one box). Splitting
    at the top n_boxes-1 position jumps keeps each segment compact.

    Returns (bmin, bmax) of shape (nb, n_boxes, 3). Empty segments
    produce inverted boxes that overlap nothing.
    """
    big = jnp.float32(3.0e38)
    nb, b, _ = pos_blocked.shape
    # jump[k] = |p[k+1] - p[k]| between consecutive sorted particles
    jump = jnp.linalg.norm(pos_blocked[:, 1:] - pos_blocked[:, :-1], axis=-1)
    jump = jnp.where(real_blocked[:, 1:] & real_blocked[:, :-1], jump, -1.0)
    # top (n_boxes - 1) gaps -> split points (ascending)
    _, top_idx = jax.lax.top_k(jump, n_boxes - 1)  # (nb, n_boxes-1)
    splits = jnp.sort(top_idx + 1, axis=1)  # first index of each next segment
    idx = jnp.arange(b, dtype=jnp.int32)[None, :]
    # segment id of each particle = number of split points <= its index
    seg = jnp.sum(idx[:, :, None] >= splits[:, None, :], axis=-1)  # (nb, B)

    mins, maxs = [], []
    for sgi in range(n_boxes):
        m = ((seg == sgi) & real_blocked)[..., None]
        mins.append(jnp.min(jnp.where(m, pos_blocked, big), axis=1))
        maxs.append(jnp.max(jnp.where(m, pos_blocked, -big), axis=1))
    return jnp.stack(mins, axis=1), jnp.stack(maxs, axis=1)


def candidate_blocks(
    bmin: jnp.ndarray,
    bmax: jnp.ndarray,
    h: float,
    max_candidates: int,
    cand_bmin: jnp.ndarray | None = None,
    cand_bmax: jnp.ndarray | None = None,
    self_index: jnp.ndarray | None = None,
):
    """Padded candidate-block lists from dilated split-AABB overlap.

    ``bmin``/``bmax``: (nb, S, 3) split boxes from
    :func:`split_block_bounds` (query side); candidate side defaults to
    the query set. ``self_index``: each query block's own index in the
    candidate table (defaults to identity when the sets coincide) — the
    own block is always emitted in slot 0 so a capacity overflow can
    never drop a particle's self-interaction.

    Returns (cand (nb, M) int32, count (nb,) int32, overflowed () bool).
    ``overflowed`` means some true neighbour blocks were dropped; the
    engine reacts by re-running with a larger cap (engine/autotune).
    Blocks with no real particles (empty AABBs) never overlap anything.
    """
    if cand_bmin is None:
        cand_bmin, cand_bmax = bmin, bmax
    nb = bmin.shape[0]
    nc = cand_bmin.shape[0]
    if self_index is None:
        self_index = jnp.arange(nb, dtype=jnp.int32)

    lo = bmin - h  # (nb, S, 3)
    hi = bmax + h
    # any-of-SxS split-box overlap combinations, accumulated per pair
    # to bound memory
    overlap = jnp.zeros((nb, nc), bool)
    for a in range(bmin.shape[1]):
        for c in range(cand_bmin.shape[1]):
            overlap = overlap | jnp.all(
                (lo[:, None, a, :] <= cand_bmax[None, :, c, :])
                & (hi[:, None, a, :] >= cand_bmin[None, :, c, :]),
                axis=-1,
            )
    # reserve slot 0 for the own block
    is_self = (
        jnp.arange(nc, dtype=jnp.int32)[None, :] == self_index[:, None]
    )
    others = overlap & ~is_self
    pos = jnp.cumsum(others.astype(jnp.int32), axis=1)  # 1-based slots
    row_count = pos[:, -1] + 1
    valid = others & (pos < max_candidates)
    slot = jnp.where(valid, pos, max_candidates)
    rows = jnp.broadcast_to(jnp.arange(nb, dtype=jnp.int32)[:, None], (nb, nc))
    cols = jnp.broadcast_to(jnp.arange(nc, dtype=jnp.int32)[None, :], (nb, nc))
    cand = jnp.zeros((nb, max_candidates + 1), jnp.int32)
    cand = cand.at[:, 0].set(self_index)
    cand = cand.at[rows, slot].set(cols, mode="drop")
    count = jnp.minimum(row_count, max_candidates)
    return cand[:, :max_candidates], count, jnp.any(row_count > max_candidates)


def candidate_blocks_hierarchical(
    bmin: jnp.ndarray,
    bmax: jnp.ndarray,
    h: float,
    max_candidates: int,
    super_cand: int = SUPER_CAND,
):
    """Two-level candidate search for large block counts (query set ==
    candidate set only — the single-chip path).

    Level 1 tests query *blocks* against candidate *superblocks* (the
    AABB union of SUPER consecutive blocks); level 2 expands each
    query's candidate superblocks into a block shortlist and applies
    the precise split-AABB test there. Conservative in the same way as
    :func:`candidate_blocks` (supersets never change the physics —
    smoothing-kernel cutoffs zero extras).
    """
    nb = bmin.shape[0]
    if nb % SUPER:
        raise ValueError(f"nb={nb} not a multiple of SUPER={SUPER}")
    nsb = nb // SUPER
    n_boxes = bmin.shape[1]

    # Superblock AABBs, split at the largest inter-member gaps: like
    # blocks (split_block_bounds), superblocks straddle Morton jumps —
    # on non-power-of-two grids a contiguous code range crosses
    # unoccupied code gaps, so runs are stringy/sheety and un-split
    # union boxes overlap far more superblocks than the particles do
    # (at 4M: 2-box splits still overflowed a 192 cap). 4 boxes at the
    # top-3 member-centre gaps keep the level-1 count bounded.
    mb_min = bmin.reshape(nsb, SUPER, n_boxes, 3)
    mb_max = bmax.reshape(nsb, SUPER, n_boxes, 3)
    mem_lo = jnp.min(mb_min, axis=2)  # (nsb, SUPER, 3) member boxes
    mem_hi = jnp.max(mb_max, axis=2)
    centers = 0.5 * (mem_lo + mem_hi)
    gap = jnp.linalg.norm(centers[:, 1:] - centers[:, :-1], axis=-1)
    sb_split = 4
    _, top_idx = jax.lax.top_k(gap, sb_split - 1)  # (nsb, 3)
    splits = jnp.sort(top_idx + 1, axis=1)
    mem_idx = jnp.arange(SUPER, dtype=jnp.int32)[None, :]
    seg = jnp.sum(
        mem_idx[:, :, None] >= splits[:, None, :], axis=-1
    )  # (nsb, SUPER) segment id
    big = jnp.float32(3.0e38)
    sb_lo_boxes, sb_hi_boxes = [], []
    for g in range(sb_split):
        m = (seg == g)[..., None]
        sb_lo_boxes.append(jnp.min(jnp.where(m, mem_lo, big), axis=1))
        sb_hi_boxes.append(jnp.max(jnp.where(m, mem_hi, -big), axis=1))
    sb_min = jnp.stack(sb_lo_boxes, axis=1)  # (nsb, sb_split, 3)
    sb_max = jnp.stack(sb_hi_boxes, axis=1)

    # ---- level 1: superblock x superblock (tiny nsb^2 matrix); every
    # block of a query superblock inherits its candidate-superblock
    # list. The OWN superblock takes slot 0 unconditionally (like
    # candidate_blocks' self slot): a truncated list must never drop a
    # block's self-interaction — at 4M that zeroed densities and
    # NaN'd the force combine's 1/rho.
    ov1 = jnp.zeros((nsb, nsb), bool)
    for a in range(sb_split):
        for c in range(sb_split):
            ov1 = ov1 | jnp.all(
                (sb_min[:, None, a, :] - h <= sb_max[None, :, c, :])
                & (sb_max[:, None, a, :] + h >= sb_min[None, :, c, :]),
                axis=-1,
            )
    super_cand = min(super_cand, nsb)  # counts cannot exceed nsb
    sb_ids = jnp.arange(nsb, dtype=jnp.int32)
    others1 = ov1 & (sb_ids[None, :] != sb_ids[:, None])
    pos1 = jnp.cumsum(others1.astype(jnp.int32), axis=1)  # 1-based
    row_count1 = pos1[:, -1] + 1  # + self
    valid1 = others1 & (pos1 < super_cand)
    slot1 = jnp.where(valid1, pos1, super_cand)
    rows1 = jnp.broadcast_to(sb_ids[:, None], (nsb, nsb))
    cols1 = jnp.broadcast_to(sb_ids[None, :], (nsb, nsb))
    sb_cand_sb = jnp.zeros((nsb, super_cand + 1), jnp.int32)
    sb_cand_sb = sb_cand_sb.at[:, 0].set(sb_ids)
    sb_cand_sb = sb_cand_sb.at[rows1, slot1].set(cols1, mode="drop")
    sb_cand_sb = sb_cand_sb[:, :super_cand]  # (nsb, Msb)
    sb_count_sb = jnp.minimum(row_count1, super_cand)
    sb_overflow = jnp.any(row_count1 > super_cand)

    # ---- level 2: refine the superblock shortlists to block lists
    # (refine_candidates: each candidate superblock's SUPER member
    # boxes against the query's split boxes, chunked over query rows).
    # Member boxes are per-block UNIONS (mem_lo/mem_hi); the query side
    # keeps its split boxes.
    cand_rep = jnp.repeat(sb_cand_sb, SUPER, axis=0)  # (nb, Msb)
    count_rep = jnp.repeat(sb_count_sb, SUPER, axis=0)
    # self-priority: level-2 ids are BLOCK ids, the query's own id is
    # its row index — biased so a truncated list keeps self-interaction
    # (advisor r2 finding #4)
    cand, count, overflow = refine_candidates(
        cand_rep, count_rep, bmin, bmax,
        mem_lo.reshape(-1, 3), mem_hi.reshape(-1, 3),
        h, SUPER, max_candidates,
        self_lo=jnp.arange(nb, dtype=jnp.int32), self_width=1,
    )
    return cand, count, overflow | sb_overflow


# sentinel id for dead slots in refined candidate tables (the passes
# read only the live slots [0, count), and clamp ids besides)
REFINE_SENTINEL = 2**30  # Python int, not jnp (see SENTINEL_CODE note)

# Self-priority bias for truncation-safe sorts (see _self_priority_sort):
# subtracting it from the query's own candidate ids makes them sort
# FIRST, so a capacity-truncated list can never drop a particle's
# self-interaction (which would zero its density and NaN the force
# combine's 1/rho on the flagged step before the engine re-runs it).
SELF_BIAS = 2**29


def _self_priority_sort(keys, self_lo, self_width, max_out):
    """Compact live candidate ids to the first ``max_out`` slots, ids in
    [self_lo, self_lo + self_width) guaranteed to survive truncation.
    ``keys`` (nb, K) candidate ids (dead = REFINE_SENTINEL); ``self_lo``
    (nb,) or None (no self priority).

    Two implementations (LIBCLSPH_TPU_COMPACT, read per trace):
    * ``sort``: ascending row sort with self ids biased first — output
      slot order is globally ascending (after self ids).
    * ``scatter``: two row cumsums compute each live id's destination
      (self ids first, then encounter order) + ONE 2D scatter, with no
      O(K log K) sort. Output order is encounter order, still
      live-first + self-first, which is all the passes require.
    """
    if os.environ.get("LIBCLSPH_TPU_COMPACT", "sort") == "scatter":
        nb, _k = keys.shape
        live = keys != REFINE_SENTINEL
        if self_lo is not None:
            is_self = (
                live
                & (keys >= self_lo[:, None])
                & (keys < self_lo[:, None] + self_width)
            )
        else:
            is_self = jnp.zeros_like(live)
        is_other = live & ~is_self
        c_self = jnp.cumsum(is_self, axis=1, dtype=jnp.int32)
        c_other = jnp.cumsum(is_other, axis=1, dtype=jnp.int32)
        dest = jnp.where(is_self, c_self - 1, c_self[:, -1:] + c_other - 1)
        ok = live & (dest < max_out)
        # colliding writes (everything truncated or dead) land in the
        # trash column max_out and all write SENTINEL — order-safe
        dest = jnp.where(ok, dest, max_out)
        vals = jnp.where(ok, keys, REFINE_SENTINEL)
        out = jnp.full((nb, max_out + 1), REFINE_SENTINEL, keys.dtype)
        out = out.at[
            jnp.arange(nb, dtype=jnp.int32)[:, None], dest
        ].set(vals, mode="promise_in_bounds")
        return out[:, :max_out]
    if self_lo is not None:
        is_self = (keys >= self_lo[:, None]) & (
            keys < self_lo[:, None] + self_width
        )
        keys = jnp.where(is_self, keys - SELF_BIAS, keys)
    out = jnp.sort(keys, axis=1)[:, :max_out]
    if self_lo is not None:
        out = jnp.where(out < 0, out + SELF_BIAS, out)
    return out

# memory cap for refine's gathered (rows, 128) box stream: 2 GB, a few
# per cent of an 80 GB card. The 1M search (~0.8 GB) runs as one
# dispatch; larger runs fall back to a chunked lax.map over query rows.
REFINE_CHUNK_BYTES = 2 << 30


def refine_candidates(
    cand: jnp.ndarray,
    count: jnp.ndarray,
    qmin: jnp.ndarray,
    qmax: jnp.ndarray,
    sub_lo: jnp.ndarray,
    sub_hi: jnp.ndarray,
    h: float,
    sub: int,
    max_sub: int,
    self_lo: jnp.ndarray | None = None,
    self_width: int = 1,
):
    """Refine coarse candidate lists to their ``sub`` members each.

    The hierarchical search's level 2: each candidate superblock's
    ``sub`` member blocks are tested against the query's dilated split
    boxes, so only overlapping members survive.

    ``cand`` (nb, M) / ``count`` (nb,): coarse lists; ``qmin``/``qmax``
    (nb, S, 3): query split boxes; ``sub_lo``/``sub_hi`` (nc*sub, 3):
    member boxes.

    The per-slot box gather reads a flat (nc, 128) pack — lane s*6+f
    holds member s's [lo.xyz | hi.xyz][f] — and a member overlaps when
    all 6 of its lane predicates pass, counted with one
    (rows, 128) @ (128, sub) product per split box; the test is chunked
    over query rows under REFINE_CHUNK_BYTES.

    Returns (cand_sub (nb, max_sub) int32 member ids with dead slots
    = REFINE_SENTINEL, count_sub (nb,), overflowed () bool).
    ``self_lo``/``self_width``: optional per-row self-id range kept
    through capacity truncation (:func:`_self_priority_sort`).
    """
    nb, m = cand.shape
    s_split = qmin.shape[1]
    if sub * 6 > 128:
        raise ValueError("sub too large for the 128-lane box pack")
    nc = sub_lo.shape[0] // sub
    # flat box pack (nc, 128)
    bp = jnp.concatenate(
        [sub_lo.reshape(nc, sub, 3), sub_hi.reshape(nc, sub, 3)], axis=2
    ).reshape(nc, sub * 6)
    bp = jnp.pad(bp, ((0, 0), (0, 128 - sub * 6)))

    lane = jnp.arange(128, dtype=jnp.int32)
    f6 = lane % 6
    fc = jnp.where(f6 < 3, f6, f6 - 3)  # world axis per lane
    is_lo = f6 < 3  # lane holds a subblock lo field
    # selector: count subblock s's 6 lanes (invalid lanes select nothing)
    sel = (
        (lane[:, None] // 6 == jnp.arange(sub)[None, :]) & (lane[:, None] < sub * 6)
    ).astype(jnp.float32)
    # per-lane query compare values, one per split box: lo lanes need
    # qmax + h >= g, hi lanes need qmin - h <= g
    qc = jnp.where(
        is_lo,
        jnp.take(qmax + h, fc, axis=-1),
        jnp.take(qmin - h, fc, axis=-1),
    )  # (nb, S, 128)
    live = jnp.arange(m, dtype=jnp.int32) < count[:, None]  # (nb, m)
    candc = jnp.where(live, cand, 0)

    def run(args):
        candc_c, qc_c, live_c, cand_c = args
        rows = candc_c.shape[0]
        g = jnp.take(bp, candc_c.reshape(-1), axis=0).reshape(rows, m, 128)
        ok = jnp.zeros((rows, sub, m), bool)
        for s in range(s_split):
            qs = qc_c[:, s, None, :]  # (rows, 1, 128)
            pred = jnp.where(is_lo, g <= qs, g >= qs)
            counts = jnp.einsum(
                "rml,ls->rsm",
                pred.astype(jnp.float32),
                sel,
                preferred_element_type=jnp.float32,
            )
            ok = ok | (counts == 6.0)
        ok = ok & live_c[:, None, :]
        ids = cand_c[:, None, :] * sub + jnp.arange(sub, dtype=jnp.int32)[
            None, :, None
        ]
        keys = jnp.where(ok, ids, REFINE_SENTINEL)  # (rows, sub, m)
        count_c = jnp.sum(ok, axis=(1, 2))
        return keys, count_c

    chunk = max(1, min(nb, REFINE_CHUNK_BYTES // (m * 128 * 4)))
    if chunk == nb:
        keys, count_sub = run((candc, qc, live, cand))
    else:
        nch = -(-nb // chunk)
        pad = nch * chunk - nb

        def cc(a):
            if pad:
                a = jnp.concatenate(
                    [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], axis=0
                )
            return a.reshape((nch, chunk) + a.shape[1:])

        keys, count_sub = jax.lax.map(run, (cc(candc), cc(qc), cc(live), cc(cand)))
        keys = keys.reshape((-1, sub, m))[:nb]
        count_sub = count_sub.reshape(-1)[:nb]

    # (nb, sub, m) -> (nb, sub*m) via lane concat (order irrelevant: the
    # ascending sort packs live ids to the front either way)
    keys = jnp.concatenate([keys[:, s, :] for s in range(sub)], axis=1)
    cand_sub = _self_priority_sort(keys, self_lo, self_width, max_sub)
    overflow = jnp.any(count_sub > max_sub)
    return cand_sub, jnp.minimum(count_sub, max_sub), overflow


def candidate_blocks_auto(bmin, bmax, h, max_candidates):
    """Pick the dense or hierarchical search by problem size.

    The level-1 superblock cap scales with max_candidates (so the
    engine's capacity autotune also relieves level-1 overflow) AND
    with nsb/3: a handful of superblocks are Morton "sheet runs"
    (gapless snakes over 2D cell sheets on non-power-of-two grids —
    splitting can't shrink them) whose counts grow with the superblock
    total: measured max 162/340/467 at nsb 512/1024/2048 on cube
    lattices. Level 2 is chunked, so the bigger cap costs level-2
    test volume (~linear in the cap), not peak memory.
    """
    nb = bmin.shape[0]
    if nb > HIERARCHICAL_THRESHOLD and nb % SUPER == 0:
        nsb = nb // SUPER
        super_cand = max(SUPER_CAND, max_candidates, -(-nsb // 3))
        return candidate_blocks_hierarchical(
            bmin, bmax, h, max_candidates, super_cand=super_cand
        )
    return candidate_blocks(bmin, bmax, h, max_candidates)


class BlockedFields(NamedTuple):
    """Morton-sorted per-particle fields reshaped to (nb, B, ...)."""

    position: jnp.ndarray  # (nb, B, 3)
    velocity: jnp.ndarray  # (nb, B, 3)
    density: jnp.ndarray  # (nb, B)
    pressure: jnp.ndarray  # (nb, B)
    real: jnp.ndarray  # (nb, B) bool
    gid: jnp.ndarray  # (nb, B) int32 global sorted index


def make_blocked(
    position, velocity, density, pressure, real, block_size: int, gid_offset=0
):
    """``gid_offset`` makes gids globally unique across shards (each
    shard passes shard_index * local_n) so self-exclusion works against
    an all-gathered candidate table."""
    n = position.shape[0]
    nb = n // block_size
    gid = jnp.arange(n, dtype=jnp.int32) + gid_offset
    rs = lambda a: a.reshape((nb, block_size) + a.shape[1:])
    return BlockedFields(
        position=rs(position),
        velocity=rs(velocity),
        density=rs(density),
        pressure=rs(pressure),
        real=rs(real),
        gid=rs(gid),
    )


def _pair_r2(qp, cp):
    rvec = qp[:, :, None, :] - cp[:, None, :, :]  # (nb, B, B, 3)
    return jnp.sum(rvec * rvec, axis=-1)


def density_pass(
    blocked: BlockedFields,
    cand: jnp.ndarray,
    count: jnp.ndarray,
    params: SimulationParameters,
    terms: PrecomputedKernelValues,
    cfg: TileConfig,
    cand_fields: BlockedFields | None = None,
) -> jnp.ndarray:
    """Tile-parallel poly6 density (forces.cl:14-42 semantics).

    ``cand_fields`` is the block table candidate indices refer to —
    defaults to ``blocked`` (single-chip); under shard_map it is the
    all-gathered global block table (parallel/sharded_step.py).
    Returns flat (n,) density over the sorted order (sentinels get
    rest density to keep downstream divisions finite).
    """
    cf = cand_fields if cand_fields is not None else blocked
    h = params.h
    qp = blocked.position

    def step(acc, m):
        # dead slots may hold REFINE_SENTINEL (hierarchical search);
        # clamp the gather index — jnp.take's default fill mode would
        # return NaN rows, and even masked physics NaN-poisons the
        # einsums downstream (0 * NaN = NaN in force_pass)
        c = jnp.minimum(cand[:, m], cf.position.shape[0] - 1)  # (nb,)
        cp = jnp.take(cf.position, c, axis=0)  # (nb, B, 3)
        creal = jnp.take(cf.real, c, axis=0)  # (nb, B)
        r2 = _pair_r2(qp, cp)
        r = jnp.sqrt(r2)
        w = smoothing.poly_6(r, h, terms)  # (nb, B, B)
        ok = (m < count)[:, None, None] & creal[:, None, :]
        contrib = jnp.sum(jnp.where(ok, w, 0.0), axis=2)  # (nb, B)
        return acc + contrib, None

    acc0 = jnp.zeros(qp.shape[:2], jnp.float32)
    acc, _ = jax.lax.scan(step, acc0, jnp.arange(cfg.max_candidates))
    density = params.particle_mass * acc
    density = jnp.where(blocked.real, density, params.fluid_density)
    return density.reshape(-1)


def force_pass(
    blocked: BlockedFields,
    cand: jnp.ndarray,
    count: jnp.ndarray,
    params: SimulationParameters,
    terms: PrecomputedKernelValues,
    cfg: TileConfig,
    cand_fields: BlockedFields | None = None,
) -> jnp.ndarray:
    """Tile-parallel internal forces + gravity (forces.cl:44-126).

    ``cand_fields`` as in :func:`density_pass`. Returns flat (n, 3)
    acceleration over the sorted order.
    """
    cf = cand_fields if cand_fields is not None else blocked
    h = params.h
    mass = params.particle_mass
    qp = blocked.position
    qv = blocked.velocity
    qrho = blocked.density
    qpress = blocked.pressure
    self_coeff = (qpress / qrho**2)[:, :, None]  # p_i / rho_i^2

    def step(carry, m):
        press_acc, visc_acc, norm_acc, lap_acc = carry
        # clamp dead-slot sentinels (see density_pass step note)
        c = jnp.minimum(cand[:, m], cf.position.shape[0] - 1)
        cp = jnp.take(cf.position, c, axis=0)
        cv = jnp.take(cf.velocity, c, axis=0)
        crho = jnp.take(cf.density, c, axis=0)
        cpress = jnp.take(cf.pressure, c, axis=0)
        creal = jnp.take(cf.real, c, axis=0)
        cgid = jnp.take(cf.gid, c, axis=0)

        r2 = _pair_r2(qp, cp)
        r = jnp.sqrt(r2)  # (nb, B, B)

        ok = (m < count)[:, None, None] & creal[:, None, :]
        is_self = blocked.gid[:, :, None] == cgid[:, None, :]
        not_self = ok & ~is_self

        cut = smoothing.support_mask(r, h)  # (nb, B, B)
        near0 = r < smoothing.EPSILON
        safe_r = jnp.where(near0, 1.0, r)

        # ---- pressure: A_ij = p_coeff * spiky_scale(r)/r, term = rowsum(A)x_i - A X_j
        p_coeff = (cpress / crho**2)[:, None, :] + self_coeff  # (nb, B, B)
        spiky_s = cut * terms.spiky * (h - r) ** 2 / safe_r
        a_mat = jnp.where(not_self & ~near0, mass * p_coeff * spiky_s, 0.0)
        # Positions are centred on the query block before the matmul so
        # rowsum(A)x - A X does not cancel catastrophically in f32.
        qpc = qp - qp[:, :1, :]
        cpc = cp - qp[:, :1, :]
        press = jnp.sum(a_mat, axis=2)[:, :, None] * qpc - jnp.einsum(
            "nij,njd->nid", a_mat, cpc, precision=jax.lax.Precision.HIGHEST, preferred_element_type=jnp.float32
        )
        # singular branch (smoothing.cl:23-25): coincident distinct pair
        sing = jnp.where(not_self & near0, mass * p_coeff * terms.spiky, 0.0)
        press = press + jnp.sum(sing, axis=2)[:, :, None]

        # ---- viscosity: B_ij = (m/rho_j) visc_lap(r); term = B V_j - rowsum(B) v_i
        b_mat = jnp.where(
            not_self, (mass / crho)[:, None, :] * cut * terms.viscosity * (h - r), 0.0
        )
        visc = jnp.einsum(
            "nij,njd->nid", b_mat, cv, precision=jax.lax.Precision.HIGHEST, preferred_element_type=jnp.float32
        ) - jnp.sum(b_mat, axis=2)[:, :, None] * qv

        # ---- colour field (self included)
        g_mat = jnp.where(
            ok,
            (mass / crho)[:, None, :]
            * cut
            * terms.poly_6_gradient
            * (h * h - r2) ** 2,
            0.0,
        )
        norm = jnp.sum(g_mat, axis=2)[:, :, None] * qpc - jnp.einsum(
            "nij,njd->nid", g_mat, cpc, precision=jax.lax.Precision.HIGHEST, preferred_element_type=jnp.float32
        )
        l_mat = jnp.where(
            ok,
            (mass / crho)[:, None, :]
            * cut
            * terms.poly_6_laplacian
            * (h * h - r2)
            * (3.0 * h * h - 7.0 * r2),
            0.0,
        )
        lap = jnp.sum(l_mat, axis=2)

        return (press_acc + press, visc_acc + visc, norm_acc + norm, lap_acc + lap), None

    nb, bsz = qp.shape[:2]
    z3 = jnp.zeros((nb, bsz, 3), jnp.float32)
    z1 = jnp.zeros((nb, bsz), jnp.float32)
    (press, visc, norm, lap), _ = jax.lax.scan(
        step, (z3, z3, z3, z1), jnp.arange(cfg.max_candidates)
    )

    total = -qrho[:, :, None] * press + visc * params.dynamic_viscosity
    nlen = jnp.linalg.norm(norm, axis=-1, keepdims=True)
    apply_st = nlen > params.surface_tension_threshold
    st = (
        -params.surface_tension
        * lap[:, :, None]
        * norm
        / jnp.where(apply_st, nlen, 1.0)
    )
    total = total + jnp.where(apply_st, st, 0.0)
    accel = total / qrho[:, :, None] + jnp.asarray(
        params.constant_acceleration, dtype=jnp.float32
    )
    return accel.reshape(-1, 3)
