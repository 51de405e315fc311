"""Mesh collisions via per-face signed distance fields.

Vectorised re-implementation of ``libclsph/kernels/collisionsv2.cl``:

* :func:`bake_distance_field` — the one-time DF bake
  (computeDistanceField, collisionsv2.cl:57-138): for every gridpoint of
  every face's dilated AABB grid, the signed distance to the nearest
  triangle whose AABB contains the point (sign = side of that face's
  plane). Vectorised over gridpoints with a ``lax.scan`` over face
  chunks instead of one GPU thread per gridpoint.
* :func:`handle_collisions` — per-substep collision response
  (handle_collisions, collisionsv2.cl:249-336): locate the *last* face
  AABB containing the particle, trilinearly interpolate its DF, and if
  the signed distance is below the 0.02 contact threshold reflect the
  velocity with restitution scaling (respond, collisionsv2.cl:9-22).

Scene geometry lives in a :class:`DeviceScene` pytree of static-shaped
arrays; a ``None``/empty scene degrades to free flight exactly like the
reference with ``face_count == 0``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.scene import Scene

CONTACT_DISTANCE = 0.02  # collision threshold (collisionsv2.cl:205/294)
DF_FAR = 20.0  # "no surface nearby" DF initialiser (collisionsv2.cl:63)


class DeviceScene(NamedTuple):
    """Static-shape device mirror of :class:`Scene` + baked DF."""

    bb_min: jnp.ndarray  # (F, 3) f32
    bb_max: jnp.ndarray  # (F, 3) f32
    bb_size: jnp.ndarray  # (F, 3) i32
    bb_offset: jnp.ndarray  # (F,)  i32
    rotations: jnp.ndarray  # (F, 3, 3) f32
    translations: jnp.ndarray  # (F, 3) f32
    rvertices: jnp.ndarray  # (F, 4) f32
    df: jnp.ndarray  # (G,) f32 baked signed distance field
    # (G, 8) corner table: corner8[g] = the 8 trilinear cell-corner DF
    # values whose base gridpoint is g, columns ordered d000..d111
    # (x-major digit order, see handle_collisions). Precomputed once at
    # bake so the per-substep lookup is ONE row gather instead of 8
    # scalar gathers.
    corner8: jnp.ndarray

    @property
    def face_count(self) -> int:
        return self.bb_min.shape[0]


def device_scene_arrays(scene: Scene) -> dict:
    if scene.total_gridpoints >= np.iinfo(np.int32).max:
        raise ValueError(
            f"distance field too large for int32 indexing: {scene.total_gridpoints}"
        )
    return dict(
        bb_min=jnp.asarray(scene.bb_min),
        bb_max=jnp.asarray(scene.bb_max),
        bb_size=jnp.asarray(scene.bb_size, dtype=jnp.int32),
        bb_offset=jnp.asarray(scene.bb_offset, dtype=jnp.int32),
        rotations=jnp.asarray(scene.rotations),
        translations=jnp.asarray(scene.translations),
        rvertices=jnp.asarray(scene.rvertices),
    )


def _point_segment_dist(rpx, rpy, rpz, x1, y1, x2, y2):
    """distPointDroite (collisionsv2.cl:26-55): 3-D distance from the
    face-local point to a 2-D segment lying in the face plane."""
    a = rpy - x1
    b = rpz - y1
    c = x2 - x1
    d = y2 - y1
    dot = a * c + b * d
    len_sq = c * c + d * d
    param = jnp.where(len_sq != 0.0, dot / jnp.where(len_sq != 0.0, len_sq, 1.0), -1.0)
    xx = jnp.where(param < 0.0, x1, jnp.where(param > 1.0, x2, x1 + param * c))
    yy = jnp.where(param < 0.0, y1, jnp.where(param > 1.0, y2, y1 + param * d))
    dy = rpy - xx
    dz = rpz - yy
    return jnp.sqrt(rpx * rpx + dz * dz + dy * dy)


def _face_local(p, rot, trans):
    """p_local = R @ (p + t) (collisionsv2.cl:92-102). Shapes
    broadcast: p (..., 3), rot (..., 3, 3), trans (..., 3)."""
    tp = p + trans
    # HIGHEST precision: JAX's default matmul path truncates f32
    # operands to bf16, far too coarse for signed-distance geometry.
    return jnp.einsum(
        "...ij,...j->...i", rot, tp, precision=jax.lax.Precision.HIGHEST
    )


def _signed_face_distance(p, rot, trans, rv):
    """Signed point-to-triangle distance in the face frame
    (collisionsv2.cl:92-131). Returns (d, rpx): unsigned distance and
    the plane coordinate whose sign signs the DF."""
    rp = _face_local(p, rot, trans)
    rpx, rpy, rpz = rp[..., 0], rp[..., 1], rp[..., 2]
    v1x, v1y = rv[..., 0], rv[..., 1]
    v2x, v2y = rv[..., 2], rv[..., 3]

    def det(x1, y1, x2, y2):
        return x1 * y2 - y1 * x2

    denom = det(v2x, v2y, 0.0, v1y)
    safe_denom = jnp.where(denom != 0.0, denom, 1.0)
    a = det(rpy, rpz, jnp.zeros_like(v1y), v1y) / safe_denom
    b = -det(rpy, rpz, v2x, v2y) / safe_denom
    inside = (a > 0.0) & (b > 0.0) & (a + b < 1.0) & (denom != 0.0)

    d_edge = _point_segment_dist(rpx, rpy, rpz, 0.0, 0.0, v1x, v1y)
    d_edge = jnp.minimum(d_edge, _point_segment_dist(rpx, rpy, rpz, v1x, v1y, v2x, v2y))
    d_edge = jnp.minimum(d_edge, _point_segment_dist(rpx, rpy, rpz, 0.0, 0.0, v2x, v2y))

    d = jnp.where(inside, jnp.abs(rpx), d_edge)
    return d, rpx


def _gridpoint_positions(scene: Scene) -> np.ndarray:
    """World positions of all DF gridpoints (NumPy, host side), in the
    reference's y-major / z / x-minor flat layout per face grid
    (collisionsv2.cl:61-87)."""
    total = scene.total_gridpoints
    idx = np.arange(total, dtype=np.int64)
    owner = np.searchsorted(scene.bb_offset, idx, side="right") - 1
    owner = np.clip(owner, 0, scene.face_count - 1)
    size = scene.bb_size[owner]
    li = idx - scene.bb_offset[owner]
    sx = size[:, 0]
    plane = sx * size[:, 2]
    x = (li % plane) % sx
    z = (li % plane) // sx
    y = li // plane
    o_min = scene.bb_min[owner]
    o_max = scene.bb_max[owner]
    coords = np.stack([x, y, z], axis=1).astype(np.float64)
    denom = np.maximum(size.astype(np.float64) - 1.0, 1.0)
    return (coords * (o_max - o_min) / denom + o_min).astype(np.float32)


def bake_distance_field(
    scene: Scene, *, point_chunk: int = 4096, face_chunk: int = 8
) -> jnp.ndarray:
    """Bake the flat (G,) signed distance field on device.

    Mirrors computeDistanceField (collisionsv2.cl:57-138), including the
    y-major / z / x-minor flat layout of each face's grid
    (collisionsv2.cl:70-77) and the first-strict-min sign convention
    (``if (d < fabs(temd))``, collisionsv2.cl:131-133).

    The reference tests every gridpoint against every face's dilated
    AABB (collisionsv2.cl:89-91). Here a HOST-side prefilter computes,
    per ``point_chunk`` of consecutive gridpoints (spatially compact —
    they tile one face's grid), the exact shortlist of faces whose AABB
    overlaps the chunk's AABB; the device then evaluates only
    (chunk x shortlist) distances — one jitted ``lax.map`` over all
    chunks, one dispatch, one fetch. Shortlists are padded to a common
    multiple of ``face_chunk``; pad slots point at a sentinel face with
    an inverted AABB that matches nothing (an all-faces scan per
    gridpoint would cost faces x gridpoints distance tests).
    """
    f_total = scene.face_count
    total = scene.total_gridpoints
    pos = _gridpoint_positions(scene)  # (G, 3) host

    n_chunks = -(-total // point_chunk)
    pad = n_chunks * point_chunk - total
    pos_p = np.concatenate([pos, np.tile(pos[:1], (pad, 1))]) if pad else pos
    pos_c = pos_p.reshape(n_chunks, point_chunk, 3)
    cmin = pos_c.min(axis=1)  # (nch, 3)
    cmax = pos_c.max(axis=1)
    # exact host shortlist: faces whose dilated AABB intersects the
    # chunk AABB (superset per point of the reference's per-point test,
    # so no face any point needs is ever dropped)
    ov = np.all(
        (cmin[:, None, :] <= scene.bb_max[None, :, :])
        & (cmax[:, None, :] >= scene.bb_min[None, :, :]),
        axis=-1,
    )  # (nch, F)
    counts = ov.sum(axis=1)
    k = max(int(counts.max()), 1)
    k = -(-k // face_chunk) * face_chunk
    short = np.full((n_chunks, k), f_total, np.int32)  # pad = sentinel face
    for i in range(n_chunks):
        ids = np.nonzero(ov[i])[0]  # ascending face order (first-win ties)
        short[i, : ids.size] = ids

    # face tables + one sentinel row that matches nothing
    arrs = device_scene_arrays(scene)
    inf = np.float32(np.inf)
    bb_min = jnp.concatenate([arrs["bb_min"], jnp.full((1, 3), inf)], axis=0)
    bb_max = jnp.concatenate([arrs["bb_max"], jnp.full((1, 3), -inf)], axis=0)
    rot = jnp.concatenate(
        [arrs["rotations"], jnp.zeros((1, 3, 3), jnp.float32)], axis=0
    )
    trans = jnp.concatenate(
        [arrs["translations"], jnp.zeros((1, 3), jnp.float32)], axis=0
    )
    rv = jnp.concatenate([arrs["rvertices"], jnp.zeros((1, 4), jnp.float32)], axis=0)

    def chunk_df(args):
        p, ids = args  # (C, 3), (K,)
        fb_min = jnp.take(bb_min, ids, axis=0)  # (K, 3)
        fb_max = jnp.take(bb_max, ids, axis=0)
        frot = jnp.take(rot, ids, axis=0)
        ftrans = jnp.take(trans, ids, axis=0)
        frv = jnp.take(rv, ids, axis=0)
        in_box = jnp.all(
            (p[:, None, :] <= fb_max[None, :, :])
            & (p[:, None, :] >= fb_min[None, :, :]),
            axis=-1,
        )  # (C, K)
        d, rpx = _signed_face_distance(
            p[:, None, :], frot[None], ftrans[None], frv[None]
        )  # (C, K)
        cand = jnp.where(in_box & (d < DF_FAR), d, jnp.inf)
        # shortlist is in ascending face order and argmin returns the
        # FIRST minimum -> identical tie behaviour to the reference's
        # strict-< update loop
        j = jnp.argmin(cand, axis=1)
        dmin = jnp.take_along_axis(cand, j[:, None], axis=1)[:, 0]
        sgn = jnp.take_along_axis(rpx, j[:, None], axis=1)[:, 0]
        return jnp.where(
            dmin < DF_FAR, jnp.copysign(dmin, sgn), jnp.float32(DF_FAR)
        )

    out = jax.jit(
        lambda ps, ss: jax.lax.map(chunk_df, (ps, ss))
    )(jnp.asarray(pos_c), jnp.asarray(short))
    return out.reshape(-1)[:total]


@jax.jit
def _build_corner_table(df, bb_size, bb_offset):
    """(G, 8) trilinear corner table over the baked DF.

    For every gridpoint g of every face grid, gather the DF at the 8
    corners of the cell whose low corner is g, in d000..d111 order
    (digits = x, y, z offsets; flat index stride 1 / sx*sz / sx, the
    getDFindex layout of collisionsv2.cl:152-156). Rows whose +1
    corners fall outside their face grid are never read at runtime
    (handle_collisions clips cells to [0, size-2]); their indices are
    clamped to stay in bounds.
    """
    total = df.shape[0]
    g = jnp.arange(total, dtype=jnp.int32)
    owner = jnp.searchsorted(bb_offset, g, side="right") - 1
    owner = jnp.clip(owner, 0, bb_size.shape[0] - 1)
    size = bb_size[owner]  # (G, 3)
    sx, sz = size[:, 0], size[:, 2]
    plane = sx * sz
    cols = []
    for a in (0, 1):  # x
        for b in (0, 1):  # y
            for c in (0, 1):  # z
                idx = jnp.clip(g + a + plane * b + sx * c, 0, total - 1)
                cols.append(df[idx])
    return jnp.stack(cols, axis=1)


def build_device_scene(scene: Scene | None, **bake_kwargs) -> DeviceScene | None:
    """Scene -> DeviceScene with baked DF (engine setup path,
    sph_simulation.cpp:311-326 + :607-632)."""
    if scene is None or scene.face_count == 0:
        return None
    arrs = device_scene_arrays(scene)
    df = bake_distance_field(scene, **bake_kwargs)
    corner8 = _build_corner_table(df, arrs["bb_size"], arrs["bb_offset"])
    return DeviceScene(df=df, corner8=corner8, **arrs)


class CollisionResponse(NamedTuple):
    position: jnp.ndarray
    next_velocity: jnp.ndarray
    collision_happened: jnp.ndarray


def handle_collisions(
    scene: DeviceScene | None,
    old_position: jnp.ndarray,  # (N, 3) pre-advection positions
    position: jnp.ndarray,  # (N, 3) advected positions
    next_velocity: jnp.ndarray,  # (N, 3)
    restitution: float,
    time_elapsed: jnp.ndarray,
    *,
    face_chunk: int = 256,
) -> CollisionResponse:
    """Vectorised handle_collisions (collisionsv2.cl:249-336).

    Differences from the reference, both intentional:
    * DF cell coords are clipped to [0, size-2] so the +1 corner gather
      stays in bounds (the reference reads out of range — undefined
      behaviour — when a particle sits exactly on a dilated-AABB edge;
      there d ~ 2h >> 0.02 so responses are identical).
    * |next_velocity| is floored at 1e-12 in the restitution term
      (reference divides by zero for a resting particle).
    """
    if scene is None:
        return CollisionResponse(
            position, next_velocity, jnp.zeros(position.shape[0], dtype=bool)
        )

    n = position.shape[0]
    f_total = scene.face_count

    # --- locate the LAST containing face AABB (collisionsv2.cl:253-261)
    # don't pad a small face list up to a whole chunk: cube.obj has 12
    # faces and would otherwise scan (N, 256) boxes — 20x the compares
    face_chunk = min(face_chunk, ((f_total + 7) // 8) * 8)
    f_pad = (-f_total) % face_chunk
    inf = jnp.float32(jnp.inf)
    cb_min = jnp.concatenate([scene.bb_min, jnp.full((f_pad, 3), inf)]) if f_pad else scene.bb_min
    cb_max = jnp.concatenate([scene.bb_max, jnp.full((f_pad, 3), -inf)]) if f_pad else scene.bb_max
    n_chunks = (f_total + f_pad) // face_chunk
    cmin = cb_min.reshape(n_chunks, face_chunk, 3)
    cmax = cb_max.reshape(n_chunks, face_chunk, 3)

    def find_last(carry, data):
        c_min, c_max, base = data
        in_box = jnp.all(
            (position[:, None, :] <= c_max[None]) & (position[:, None, :] >= c_min[None]),
            axis=-1,
        )  # (N, C)
        ids = jnp.arange(face_chunk, dtype=jnp.int32)[None, :] + base
        best = jnp.max(jnp.where(in_box, ids, -1), axis=1)
        return jnp.maximum(carry, best), None

    bases = jnp.arange(n_chunks, dtype=jnp.int32) * face_chunk
    indice, _ = jax.lax.scan(
        find_last, jnp.full((n,), -1, jnp.int32), (cmin, cmax, bases)
    )
    found = indice >= 0
    safe_f = jnp.clip(indice, 0, f_total - 1)

    bmin = scene.bb_min[safe_f]
    bmax = scene.bb_max[safe_f]
    size = scene.bb_size[safe_f]
    offset = scene.bb_offset[safe_f]
    side = (bmax - bmin) / jnp.maximum(size.astype(jnp.float32) - 1.0, 1.0)

    cell = ((position - bmin) / side).astype(jnp.int32)
    # INVARIANT (load-bearing for _build_corner_table): cells are
    # clipped to [0, size-2] per axis, so the +1 corner lookups the
    # corner table precomputes stay inside this face's own grid —
    # rows the table built for a face-boundary base gridpoint (whose
    # clamped +1 indices alias the NEXT face's grid) are never read.
    cell = jnp.clip(cell, 0, size - 2)
    x, y, z = cell[:, 0], cell[:, 1], cell[:, 2]
    sx, sz = size[:, 0], size[:, 2]
    base = cell.astype(jnp.float32) * side + bmin  # (bx, by, bz)

    # ONE (N, 8) row gather from the precomputed corner table replaces
    # the reference's 8 per-corner gathers (getDFindex,
    # collisionsv2.cl:152-156); base index = cell's d000 gridpoint.
    idx0 = offset + y * sx * sz + sx * z + x
    corners = jnp.take(scene.corner8, idx0, axis=0)  # (N, 8)
    d000, d001, d010, d011 = (corners[:, k] for k in range(4))
    d100, d101, d110, d111 = (corners[:, k] for k in range(4, 8))

    def wavg(xq, x1, x2, f1, f2):
        # weigthedAverage (collisionsv2.cl:140-142)
        return ((x2 - xq) / (x2 - x1)) * f1 + ((xq - x1) / (x2 - x1)) * f2

    def bilerp(xq, yq, xmin, ymin, xmax, ymax, f00, f01, f10, f11):
        r1 = wavg(xq, xmin, xmax, f00, f10)
        r2 = wavg(xq, xmin, xmax, f01, f11)
        return wavg(yq, ymin, ymax, r1, r2)

    px, py, pz = position[:, 0], position[:, 1], position[:, 2]
    bx, by, bz = base[:, 0], base[:, 1], base[:, 2]
    sxs, sys, szs = side[:, 0], side[:, 1], side[:, 2]

    facedown = bilerp(px, pz, bx, bz, bx + sxs, bz + szs, d000, d001, d100, d101)
    faceup = bilerp(px, pz, bx, bz, bx + sxs, bz + szs, d010, d011, d110, d111)
    d = wavg(py, by, by + sys, facedown, faceup)

    colliding = found & (d < CONTACT_DISTANCE)

    faceright = bilerp(py, pz, by, bz, by + sys, bz + szs, d100, d101, d110, d111)
    faceleft = bilerp(py, pz, by, bz, by + sys, bz + szs, d000, d001, d010, d011)
    faceback = bilerp(px, py, bx, by, bx + sxs, by + sys, d000, d010, d100, d110)
    facefront = bilerp(px, py, bx, by, bx + sxs, by + sys, d001, d011, d101, d111)

    normal = jnp.stack(
        [faceright - faceleft, faceup - facedown, facefront - faceback], axis=1
    )
    nlen = jnp.linalg.norm(normal, axis=1, keepdims=True)
    normal = normal / jnp.where(nlen > 0.0, nlen, 1.0)

    # respond (collisionsv2.cl:9-22)
    absd = jnp.abs(d)[:, None]
    new_position = position + absd * normal
    speed = jnp.linalg.norm(next_velocity, axis=1, keepdims=True)
    coef = 1.0 + restitution * absd / (time_elapsed * jnp.maximum(speed, 1e-12))
    vdotn = jnp.sum(next_velocity * normal, axis=1, keepdims=True)
    new_velocity = next_velocity - coef * vdotn * normal

    cmask = colliding[:, None]
    return CollisionResponse(
        position=jnp.where(cmask, new_position, position),
        next_velocity=jnp.where(cmask, new_velocity, next_velocity),
        collision_happened=colliding,
    )
