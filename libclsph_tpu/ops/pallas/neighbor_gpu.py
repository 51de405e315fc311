"""Density and force passes as fused GPU kernels (Pallas, Triton route).

The GPU twin of :func:`..tiles.density_pass` / :func:`..tiles.force_pass`
and of the reference's one-thread-per-particle ``density_pressure`` and
``forces`` kernels (sphb.cl:3-126): the neighbour loop and every pair
term run in one kernel per pass, and pair values never leave registers.

Layout. After the Morton sort the particles form ``nb`` blocks of ``B``
(the candidate search's block size). Each pass reads a packed SoA table
of shape ``(nb, F, B)`` float32: row ``f`` of block ``c`` holds field
``f`` of that block's ``B`` particles, so one candidate block is one
contiguous ``F * B * 4``-byte region. The id row holds the particle's
int32 id bit-cast to float32 (``-1`` for padding particles), so ids are
exact at any particle count and the id doubles as the real mask.

Work split. One program per ``(block, query tile)``; a ``fori_loop``
walks only the ``count[b]`` live candidate blocks of
:func:`..tiles.candidate_blocks_auto` (dead slots are never read), and
each candidate block is consumed in ``B // cand_tile`` register tiles of
``(query_tile, cand_tile)`` pairs. The directional sums
``sum_j a_ij (x_i - x_j)`` are accumulated elementwise in float32: no
tensor cores, no TF32 (its ~1e-3 error would break the 1e-4 budget).
Densities ``(n,)`` and accelerations ``(n, 3)`` are written once.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...core import smoothing
from ...core.params import PrecomputedKernelValues, SimulationParameters
from ..tiles import BlockedFields

# rows of the packed tables; the density table is the first four
X, Y, Z, ID, VX, VY, VZ, MP, MR = range(9)
NONREAL_ID = -1


class KernelShape(NamedTuple):
    """Register tile and launch shape of one pass."""

    query_tile: int  # query particles per program
    cand_tile: int  # candidate particles per register tile
    num_warps: int
    num_stages: int


# chosen per pass by the on-card sweep in experiments/gpu_kernel_sweep.py
# (PERF.md records the numbers)
DENSITY_SHAPE = KernelShape(32, 32, 2, 2)
FORCE_SHAPE = KernelShape(16, 128, 4, 2)


def _ids_as_f32(blocked: BlockedFields) -> jnp.ndarray:
    ids = jnp.where(blocked.real, blocked.gid, NONREAL_ID).astype(jnp.int32)
    return lax.bitcast_convert_type(ids, jnp.float32)


def pack_density(blocked: BlockedFields) -> jnp.ndarray:
    """(nb, 4, B) table [x, y, z, id] of a blocked particle set."""
    p = blocked.position
    return jnp.stack(
        [p[..., 0], p[..., 1], p[..., 2], _ids_as_f32(blocked)], axis=1
    )


def pack_forces(blocked: BlockedFields, mass: float) -> jnp.ndarray:
    """(nb, 9, B) table [x, y, z, id, vx, vy, vz, m p / rho^2, m / rho].

    ``blocked.density`` must be finite for every row (padding particles
    carry the rest density)."""
    p, v, rho = blocked.position, blocked.velocity, blocked.density
    return jnp.stack(
        [
            p[..., 0], p[..., 1], p[..., 2], _ids_as_f32(blocked),
            v[..., 0], v[..., 1], v[..., 2],
            mass * blocked.pressure / (rho * rho), mass / rho,
        ],
        axis=1,
    )


def _load(ref, block, lanes, fields):
    """Rows ``fields`` of one block of a packed table, at ``lanes``."""
    return [ref[block, f, lanes] for f in fields]


def _density_kernel(cand_ref, count_ref, q_ref, c_ref, out_ref, *,
                    query_tile, cand_tile, h2):
    b = pl.program_id(0)
    rows = pl.ds(pl.program_id(1) * query_tile, query_tile)
    qx, qy, qz = _load(q_ref, b, rows, (X, Y, Z))
    n_cand_blocks, _, block = c_ref.shape

    def body(j, acc):
        c = jnp.minimum(cand_ref[b, j], n_cand_blocks - 1)
        for s in range(block // cand_tile):
            cols = pl.ds(s * cand_tile, cand_tile)
            cx, cy, cz, cid = _load(c_ref, c, cols, (X, Y, Z, ID))
            real = lax.bitcast_convert_type(cid, jnp.int32) >= 0
            dx = qx[:, None] - cx[None, :]
            dy = qy[:, None] - cy[None, :]
            dz = qz[:, None] - cz[None, :]
            r2 = dx * dx + dy * dy + dz * dz
            t = h2 - r2
            w = jnp.where(real[None, :] & (r2 < h2), t * t * t, 0.0)
            acc = acc + jnp.sum(w, axis=1)
        return acc

    acc = lax.fori_loop(
        0, count_ref[b], body, jnp.zeros((query_tile,), jnp.float32)
    )
    out_ref[b, rows] = acc


def _force_kernel(cand_ref, count_ref, q_ref, rho_ref, c_ref, out_ref, *,
                  query_tile, cand_tile, h, consts):
    b = pl.program_id(0)
    rows = pl.ds(pl.program_id(1) * query_tile, query_tile)
    qx, qy, qz, qid, qvx, qvy, qvz, qmp = _load(
        q_ref, b, rows, (X, Y, Z, ID, VX, VY, VZ, MP)
    )
    qid = lax.bitcast_convert_type(qid, jnp.int32)
    n_cand_blocks, _, block = c_ref.shape
    h2 = h * h

    def body(j, acc):
        c = jnp.minimum(cand_ref[b, j], n_cand_blocks - 1)
        for s in range(block // cand_tile):
            cols = pl.ds(s * cand_tile, cand_tile)
            cx, cy, cz, cid = _load(c_ref, c, cols, (X, Y, Z, ID))
            cid = lax.bitcast_convert_type(cid, jnp.int32)
            real = (cid >= 0)[None, :]
            dx = qx[:, None] - cx[None, :]
            dy = qy[:, None] - cy[None, :]
            dz = qz[:, None] - cz[None, :]
            r2 = dx * dx + dy * dy + dz * dz
            # most candidate tiles hold no pair inside the support:
            # test the cheap distances first, skip the pair terms
            nearest = jnp.min(jnp.where(real, r2, jnp.inf))

            def add_pairs(acc):  # traced at once, so no late binding
                (px, py, pz, sing, vx, vy, vz, nx, ny, nz, lap) = acc
                cvx, cvy, cvz, cmp, cmr = _load(
                    c_ref, c, cols, (VX, VY, VZ, MP, MR)
                )
                r = jnp.sqrt(r2)
                inside = real & (r < h)
                pair = inside & (qid[:, None] != cid[None, :])
                near0 = r < smoothing.EPSILON
                # m (p_i / rho_i^2 + p_j / rho_j^2)
                coeff = qmp[:, None] + cmp[None, :]
                hr = h - r
                # pressure (spiky gradient), with the r -> 0 singular branch
                a = coeff * hr * hr / jnp.where(near0, 1.0, r)
                a = jnp.where(pair & ~near0, a, 0.0)
                px = px + jnp.sum(a * dx, axis=1)
                py = py + jnp.sum(a * dy, axis=1)
                pz = pz + jnp.sum(a * dz, axis=1)
                sing = sing + jnp.sum(
                    jnp.where(pair & near0, coeff, 0.0), axis=1
                )
                # viscosity laplacian: sum_j m/rho_j (h - r) (v_j - v_i)
                bv = jnp.where(pair, cmr[None, :] * hr, 0.0)
                vx = vx + jnp.sum(bv * (cvx[None, :] - qvx[:, None]), axis=1)
                vy = vy + jnp.sum(bv * (cvy[None, :] - qvy[:, None]), axis=1)
                vz = vz + jnp.sum(bv * (cvz[None, :] - qvz[:, None]), axis=1)
                # colour field gradient and laplacian (self included)
                t = h2 - r2
                g = jnp.where(inside, cmr[None, :] * t * t, 0.0)
                nx = nx + jnp.sum(g * dx, axis=1)
                ny = ny + jnp.sum(g * dy, axis=1)
                nz = nz + jnp.sum(g * dz, axis=1)
                lt = cmr[None, :] * t * (3.0 * h2 - 7.0 * r2)
                lap = lap + jnp.sum(jnp.where(inside, lt, 0.0), axis=1)
                return (px, py, pz, sing, vx, vy, vz, nx, ny, nz, lap)

            acc = lax.cond(nearest < h2, add_pairs, lambda acc: acc, acc)
        return acc

    zero = jnp.zeros((query_tile,), jnp.float32)
    (px, py, pz, sing, vx, vy, vz, nx, ny, nz, lap) = lax.fori_loop(
        0, count_ref[b], body, (zero,) * 11
    )

    (spiky, visc, grad, lapc, mu, sigma, threshold, gx, gy, gz) = consts
    rho = rho_ref[b, rows]
    nx, ny, nz, lap = grad * nx, grad * ny, grad * nz, lapc * lap
    nlen = jnp.sqrt(nx * nx + ny * ny + nz * nz)
    apply_st = nlen > threshold
    st = jnp.where(
        apply_st, -sigma * lap / jnp.where(apply_st, nlen, 1.0), 0.0
    )
    for k, (p, v, nk, gk) in enumerate(
        ((px, vx, nx, gx), (py, vy, ny, gy), (pz, vz, nz, gz))
    ):
        total = -rho * spiky * (p + sing) + mu * visc * v + st * nk
        out_ref[b, k, rows] = total / rho + gk


def _call(kernel, block, shape: KernelShape, out_shape, name, interpret):
    # blocks narrower than the tuned tiles (small test configurations)
    # run with tiles clipped to the block
    shape = shape._replace(
        query_tile=min(shape.query_tile, block),
        cand_tile=min(shape.cand_tile, block),
    )
    for t in (shape.query_tile, shape.cand_tile):
        if t & (t - 1) or block % t:
            raise ValueError(
                f"tile {t} must be a power of two dividing the block size {block}"
            )
    nb = out_shape.shape[0]
    return pl.pallas_call(
        functools.partial(
            kernel, query_tile=shape.query_tile, cand_tile=shape.cand_tile
        ),
        grid=(nb, block // shape.query_tile),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=shape.num_warps, num_stages=shape.num_stages
        ),
        interpret=interpret,
        name=name,
    )


def fused_density(
    q_pack: jnp.ndarray,
    c_pack: jnp.ndarray,
    cand: jnp.ndarray,
    count: jnp.ndarray,
    params: SimulationParameters,
    terms: PrecomputedKernelValues,
    *,
    interpret: bool = False,
    shape: KernelShape = DENSITY_SHAPE,
) -> jnp.ndarray:
    """Poly6 density of every query particle (forces.cl:14-42).

    ``q_pack`` (nb, >=4, B): query blocks, from :func:`pack_density` or
    :func:`pack_forces`; ``c_pack``: the table ``cand`` (nb, M) indexes
    (the same array on one device, the gathered table under shard_map);
    ``count`` (nb,): live slots per row. Returns flat (nb * B,) density;
    rows of padding particles are meaningless (callers mask them).
    """
    nb, _, block = q_pack.shape
    kernel = functools.partial(_density_kernel, h2=float(params.h) ** 2)
    acc = _call(
        kernel, block, shape, jax.ShapeDtypeStruct((nb, block), jnp.float32),
        "sph_density", interpret,
    )(cand.astype(jnp.int32), count.astype(jnp.int32), q_pack, c_pack)
    return (params.particle_mass * terms.poly_6) * acc.reshape(-1)


def fused_forces(
    q_pack: jnp.ndarray,
    q_density: jnp.ndarray,
    c_pack: jnp.ndarray,
    cand: jnp.ndarray,
    count: jnp.ndarray,
    params: SimulationParameters,
    terms: PrecomputedKernelValues,
    *,
    interpret: bool = False,
    shape: KernelShape = FORCE_SHAPE,
) -> jnp.ndarray:
    """Internal forces + gravity as accelerations (forces.cl:44-126).

    ``q_pack`` / ``c_pack``: :func:`pack_forces` tables of the query
    and candidate blocks; ``q_density`` (nb * B,) the query densities
    (finite everywhere). Returns flat (nb * B, 3) acceleration.
    """
    nb, _, block = q_pack.shape
    g = tuple(float(x) for x in params.constant_acceleration)
    consts = (
        terms.spiky, terms.viscosity, terms.poly_6_gradient,
        terms.poly_6_laplacian, params.dynamic_viscosity,
        params.surface_tension, params.surface_tension_threshold,
    ) + g
    kernel = functools.partial(
        _force_kernel, h=float(params.h), consts=tuple(float(c) for c in consts)
    )
    out = _call(
        kernel, block, shape, jax.ShapeDtypeStruct((nb, 3, block), jnp.float32),
        "sph_forces", interpret,
    )(
        cand.astype(jnp.int32), count.astype(jnp.int32), q_pack,
        q_density.reshape(nb, block), c_pack,
    )
    return out.transpose(0, 2, 1).reshape(-1, 3)
