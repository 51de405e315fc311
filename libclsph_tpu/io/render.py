"""On-device point rendering — the accelerator-side answer to the
reference's OpenGL live view.

The reference renders by uploading the particle buffer as a VBO and
drawing density-coloured GL points with a rotating camera
(``example/opengl.cpp:121-148``, ``shaders/vert.glsl:1-18``). The
hardware there is the GPU's rasteriser; here rasterisation stays ON
the accelerator as a jitted XLA program and ship
PIXELS to the host instead of particles: at 1M particles a frame fetch
drops from ~12 MB of state to a ~1.9 MB image, and the projection /
z-test / colour math runs at device speed instead of in NumPy.

Pipeline (one jitted function, no host round-trips):

1. orbit-camera transform + perspective projection (the same camera
   model as the reference's rotating MVP, opengl.cpp:108-117);
2. density -> RGB via the exact export colour ramp
   (houdini_file_saver.cpp:46-60 — the GL example colours by raw
   density, vert.glsl:12-14; we reuse the richer ramp so the live view
   matches the exported frames);
3. z-buffered point splatting WITHOUT a rasteriser: each point packs
   (quantised depth << 18 | r6 g6 b6) into one int32 key and a
   ``scatter-min`` per splat pixel keeps the nearest point's key —
   depth test and colour write in a single XLA op. Out-of-frustum and
   sentinel/padded particles (non-finite or far coordinates) fail the
   float validity mask and are routed to a dropped out-of-range index.

Everything is shape-static (width/height/splat are Python ints);
camera angles/zoom/center are traced scalars so interactive motion
never recompiles.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

# packed-key layout: [ z:13 | r:6 | g:6 | b:6 ] = 31 bits (int32-safe)
_ZBITS = 13
_CBITS = 6
_ZMAX = (1 << _ZBITS) - 1
_CMAX = (1 << _CBITS) - 1
_EMPTY = jnp.int32(0x7FFFFFFF)  # > any packed key
_ZNEAR = 0.05


def density_ramp(density: jnp.ndarray) -> jnp.ndarray:
    """density -> (n, 3) float RGB, the export ramp of
    io/geo_format.density_color_ramp (houdini_file_saver.cpp:46-60),
    in jnp so it can run inside jitted device code."""
    d = density.astype(jnp.float32)
    r = jnp.where((d > 1000.0) & (d <= 2000.0), (d - 1000.0) / 1000.0, 0.0)
    g = jnp.where((d >= 0.0) & (d < 1000.0), 1.0 - d / 1000.0, 0.0)
    b = jnp.where(
        (d >= 500.0) & (d <= 1000.0),
        (d - 500.0) / 500.0,
        jnp.where(
            (d >= 1000.0) & (d <= 1500.0), 1.0 - (d - 1000.0) / 500.0, 0.0
        ),
    )
    return jnp.stack([r, g, b], axis=1)


@functools.partial(
    jax.jit, static_argnames=("width", "height", "splat", "focal")
)
def render_points(
    position: jnp.ndarray,
    density: jnp.ndarray,
    yaw,
    pitch,
    zoom,
    center,
    *,
    width: int = 900,
    height: int = 700,
    splat: int = 2,
    focal: float = 0.9,
    background: Sequence[int] = (18, 18, 24),
) -> jnp.ndarray:
    """Render density-coloured points to a (height, width, 3) uint8
    image, entirely on device.

    ``position`` (n, 3) world positions (padded/sentinel rows at
    non-finite or far coordinates are culled by the frustum test);
    ``density`` (n,); ``yaw``/``pitch``/``zoom``/``center`` the orbit
    camera (traced — interactive motion does not recompile);
    ``splat`` the square splat size in pixels.
    """
    # orbit camera: yaw about y, pitch about x, then push back by zoom
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    p = position - center
    x = cy * p[:, 0] + sy * p[:, 2]
    z0 = -sy * p[:, 0] + cy * p[:, 2]
    y = cp * p[:, 1] - sp * z0
    z = sp * p[:, 1] + cp * z0 + zoom

    f = focal * height
    vis = z > _ZNEAR
    zsafe = jnp.where(vis, z, 1.0)
    fx = f * x / zsafe + width / 2.0
    fy = height / 2.0 - f * y / zsafe
    # validity decided on floats: NaN/Inf coordinates fail every
    # comparison, so sentinel rows can never reach the cast below
    ok = (
        vis
        & (fx >= 0.0)
        & (fx <= float(width - splat))
        & (fy >= 0.0)
        & (fy <= float(height - splat))
    )
    xi = jnp.clip(fx, 0.0, width - 1.0).astype(jnp.int32)
    yi = jnp.clip(fy, 0.0, height - 1.0).astype(jnp.int32)

    # depth quantised over [ZNEAR, zfar]; zfar tracks the live extent
    # so precision adapts to the camera distance
    zfar = jnp.maximum(jnp.max(jnp.where(ok, z, _ZNEAR)), _ZNEAR + 1e-3)
    zq = (
        jnp.clip((z - _ZNEAR) / (zfar - _ZNEAR), 0.0, 1.0) * _ZMAX
    ).astype(jnp.int32)

    rgb = jnp.clip(density_ramp(density), 0.0, 1.0)
    c6 = (rgb * _CMAX + 0.5).astype(jnp.int32)  # (n, 3) 6-bit channels
    key = (
        (zq << (3 * _CBITS))
        | (c6[:, 0] << (2 * _CBITS))
        | (c6[:, 1] << _CBITS)
        | c6[:, 2]
    )

    npix = width * height
    pix = jnp.where(ok, yi * width + xi, npix)  # npix = dropped
    buf = jnp.full((npix,), _EMPTY, jnp.int32)
    for dy in range(splat):
        for dx in range(splat):
            buf = buf.at[pix + (dy * width + dx)].min(
                key, mode="drop", indices_are_sorted=False,
                unique_indices=False,
            )

    hit = buf != _EMPTY
    chan = jnp.stack(
        [
            (buf >> (2 * _CBITS)) & _CMAX,
            (buf >> _CBITS) & _CMAX,
            buf & _CMAX,
        ],
        axis=-1,
    )
    fg = (chan.astype(jnp.float32) * (255.0 / _CMAX) + 0.5).astype(jnp.uint8)
    bg = jnp.asarray(background, jnp.uint8)
    img = jnp.where(hit[:, None], fg, bg[None, :])
    return img.reshape(height, width, 3)


class PointRenderer:
    """Stateful convenience wrapper: camera state + the jitted render.

    Intended as the engine's ``device_view`` hook target — see
    :meth:`view` — or called directly with (position, density) arrays
    (device or host; host arrays are uploaded once per call).
    """

    def __init__(self, width: int = 900, height: int = 700, splat: int = 2):
        self.width = width
        self.height = height
        self.splat = splat
        self.yaw = 0.6
        self.pitch = 0.35
        self.zoom = 3.0
        self.auto_rotate = True
        self.center = None  # default: live particle centroid

    def render(self, position, density) -> np.ndarray:
        """(H, W, 3) uint8 host image of the given particle state."""
        if self.auto_rotate:
            self.yaw += 0.02  # the reference's rotating camera
        center = (
            jnp.nanmean(
                jnp.where(
                    jnp.abs(position) < 1.0e30, position, jnp.nan
                ),
                axis=0,
            )
            if self.center is None
            else jnp.asarray(self.center, jnp.float32)
        )
        img = render_points(
            jnp.asarray(position),
            jnp.asarray(density),
            jnp.float32(self.yaw),
            jnp.float32(self.pitch),
            jnp.float32(self.zoom),
            center,
            width=self.width,
            height=self.height,
            splat=self.splat,
        )
        return np.asarray(img)

    def view(self, state, params, is_full_frame: bool) -> None:
        """Engine ``device_view`` signature; override ``on_image`` (or
        subclass) to consume the frame."""
        self.on_image(self.render(state.position, state.density))

    def on_image(self, image: np.ndarray) -> None:  # pragma: no cover
        raise NotImplementedError(
            "assign on_image or subclass PointRenderer"
        )
