"""On-device point renderer (io/render.py) — the accelerator-side equivalent
of the reference's GL viewer (example/opengl.cpp:121-148,
shaders/vert.glsl:1-18)."""

import numpy as np
import jax.numpy as jnp
import pytest

from libclsph_tpu.io.geo_format import density_color_ramp
from libclsph_tpu.io.render import PointRenderer, density_ramp, render_points

BG = (18, 18, 24)


def project_host(pos, yaw, pitch, zoom, center, width, height, focal=0.9):
    """Independent NumPy projection oracle (same camera model)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    p = np.asarray(pos) - center
    x = cy * p[:, 0] + sy * p[:, 2]
    z0 = -sy * p[:, 0] + cy * p[:, 2]
    y = cp * p[:, 1] - sp * z0
    z = sp * p[:, 1] + cp * z0 + zoom
    f = focal * height
    return (
        f * x / z + width / 2.0,
        height / 2.0 - f * y / z,
        z,
    )


def test_density_ramp_matches_export_ramp():
    d = np.linspace(-100.0, 2500.0, 997).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(density_ramp(jnp.asarray(d))),
        density_color_ramp(d),
        atol=1e-6,
    )


def test_single_point_lands_with_ramp_colour():
    # one point at the camera axis -> centre pixel, ramp colour
    pos = jnp.asarray([[0.0, 0.0, 0.0]])
    dens = jnp.asarray([998.29])
    img = np.asarray(render_points(
        pos, dens, 0.0, 0.0, 2.0, jnp.zeros(3), width=64, height=48,
        splat=2,
    ))
    assert img.shape == (48, 64, 3)
    expected = density_color_ramp(np.asarray(dens))[0]
    got = img[24, 32].astype(np.float32) / 255.0
    # 6-bit channel quantisation -> within 1/63 + rounding
    np.testing.assert_allclose(got, expected, atol=1.5 / 63)
    # splat is 2x2
    assert (img[24:26, 32:34] == img[24, 32]).all()
    # everything else is background
    mask = np.ones((48, 64), bool)
    mask[24:26, 32:34] = False
    assert (img[mask] == np.array(BG, np.uint8)).all()


def test_nearest_point_wins_depth_test():
    # two points projecting to the same pixel; the nearer one (camera
    # z = world z + zoom, so world z=-0.5 -> camera z=1.5 beats the
    # origin point's 2.0) must win the scatter-min depth test
    pos = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, -0.5]])
    dens = jnp.asarray([500.0, 1500.0])
    img = np.asarray(render_points(
        pos, dens, 0.0, 0.0, 2.0, jnp.zeros(3), width=64, height=48,
        splat=1,
    ))
    expected = density_color_ramp(np.array([1500.0]))[0]
    got = img[24, 32].astype(np.float32) / 255.0
    np.testing.assert_allclose(got, expected, atol=1.5 / 63)


def test_sentinel_and_behind_camera_points_are_culled():
    pos = jnp.asarray([
        [1.0e38, 1.0e38, 1.0e38],     # sentinel/padded row
        [np.nan, np.nan, np.nan],     # poisoned row
        [0.0, 0.0, -5.0],             # behind the camera (z+zoom < ZNEAR)
    ])
    dens = jnp.asarray([998.0, 998.0, 998.0])
    img = np.asarray(render_points(
        pos, dens, 0.0, 0.0, 2.0, jnp.zeros(3), width=32, height=32,
    ))
    assert (img == np.array(BG, np.uint8)).all()


def test_cloud_matches_host_projection_oracle():
    rng = np.random.default_rng(7)
    n = 512
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    dens = rng.uniform(0.0, 2000.0, n).astype(np.float32)
    yaw, pitch, zoom = 0.6, 0.35, 3.0
    W, H = 120, 90
    img = np.asarray(render_points(
        jnp.asarray(pos), jnp.asarray(dens), yaw, pitch, zoom,
        jnp.zeros(3), width=W, height=H, splat=1,
    ))
    fx, fy, z = project_host(pos, yaw, pitch, zoom, np.zeros(3), W, H)
    ok = (z > 0.05) & (fx >= 0) & (fx <= W - 1) & (fy >= 0) & (fy <= H - 1)
    xi, yi = fx[ok].astype(int), fy[ok].astype(int)
    # every projected point's pixel is non-background
    assert (img[yi, xi] != np.array(BG, np.uint8)).any(axis=-1).all()
    # pixel count sanity: no more lit pixels than points
    lit = (img != np.array(BG, np.uint8)).any(axis=-1).sum()
    assert 0 < lit <= ok.sum()
    # depth ordering: for each lit pixel, the shown colour belongs to
    # (one of) the nearest projected points there
    ramp = density_color_ramp(dens)
    q = np.floor(np.clip(ramp, 0, 1) * 63 + 0.5)
    shown = {}
    for k in np.argsort(z[ok]):  # near first
        key = (yi[k], xi[k])
        shown.setdefault(key, q[np.nonzero(ok)[0][k]])
    for (py, px), want in shown.items():
        got = np.floor(img[py, px].astype(np.float32) / (255.0 / 63) + 0.5)
        np.testing.assert_allclose(got, want, atol=1)


def test_point_renderer_engine_hook():
    """device_view plumbing: the engine calls the hook once per frame
    with the device state; PointRenderer produces images."""
    from libclsph_tpu.core.params import derive_parameters
    from libclsph_tpu.engine.simulation import SPHSimulation
    from libclsph_tpu.engine.step import StepConfig
    from libclsph_tpu.models.presets import WATER, simulation_config

    sim = SPHSimulation(step_config=StepConfig(neighbor_impl="tiles"))
    sim.parameters = derive_parameters(
        dict(WATER),
        simulation_config(particles_count=512, simulation_time=3 / 60),
    )
    sim.precomputed_terms = sim.parameters.precomputed()
    sim.initial_volume = sim.parameters.initial_volume

    r = PointRenderer(width=80, height=60)
    images = []
    r.on_image = images.append
    sim.device_view = r.view
    sim.simulate()

    assert len(images) == 4  # initial view + one per frame
    for img in images:
        assert img.shape == (60, 80, 3) and img.dtype == np.uint8
        assert (img != np.array(BG, np.uint8)).any()  # particles visible


@pytest.mark.parametrize("splat", [1, 2, 3])
def test_splat_sizes_compile(splat):
    img = np.asarray(render_points(
        jnp.zeros((4, 3)), jnp.full((4,), 998.0), 0.1, 0.2, 2.0,
        jnp.zeros(3), width=40, height=40, splat=splat,
    ))
    lit = (img != np.array(BG, np.uint8)).any(axis=-1)
    assert lit.sum() == splat * splat
