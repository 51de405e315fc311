"""Fidelity at bench scale: run a 64k water dam-break for K substeps on
the device, then compare the platform path's density/accel against a
vectorised float64 oracle of the same governing equations (Mueller-03 +
Kelager 4.11 + colour-field surface tension — the math of
forces.cl:14-111 / sphb.cl:3-126).

Density error is measured over ALL particles; accel over a random row
subsample (the f64 pair sums are O(rows * N)). Both are relative RMS,
sqrt(sum err^2 / sum ref^2).

Run:  python experiments/fidelity_64k.py
(``chip_smoke.py`` imports the oracle functions below.)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def oracle_density(pos: np.ndarray, params) -> np.ndarray:
    """float64 poly6 density of every particle in ``pos`` (N, 3).

    Uses the kernel's compact support: a KD-tree pair list (r < h),
    with pair distances evaluated in f64."""
    from scipy.spatial import cKDTree

    pos = np.asarray(pos, np.float64)
    h = float(params.h)
    mass = float(params.particle_mass)
    c_poly6 = 315.0 / (64.0 * np.pi * h**9)
    pairs = cKDTree(pos).query_pairs(h, output_type="ndarray")  # i < j
    pi, pj = pairs[:, 0], pairs[:, 1]
    r2 = ((pos[pi] - pos[pj]) ** 2).sum(axis=1)
    tp = np.maximum(h * h - r2, 0.0) ** 3
    rho = np.full(len(pos), mass * c_poly6 * h**6)  # self term (r = 0)
    np.add.at(rho, pi, mass * c_poly6 * tp)
    np.add.at(rho, pj, mass * c_poly6 * tp)
    return rho


def oracle_accel(pos, vel, rho, params, rows):
    """float64 acceleration of particles ``rows`` given all positions,
    velocities and densities (forces.cl:44-126). Returns (accel
    (rows, 3), colour-field gradient length (rows,)): rows whose length
    sits at the surface-tension threshold switch branch under any
    rounding."""
    pos = np.asarray(pos, np.float64)
    vel = np.asarray(vel, np.float64)
    rho = np.asarray(rho, np.float64)
    n = len(pos)
    h = float(params.h)
    mass = float(params.particle_mass)
    c_grad = -945.0 / (32.0 * np.pi * h**9)
    c_lap = -945.0 / (32.0 * np.pi * h**9)
    c_spiky = -45.0 / (np.pi * h**6)
    c_visc = 45.0 / (np.pi * h**6)
    press = params.K * ((rho / params.fluid_density) ** 7 - 1.0)
    acc = np.zeros((len(rows), 3))
    nlens = np.zeros(len(rows))
    for k, i in enumerate(rows):
        rv = pos[i] - pos  # (N, 3)
        r2 = np.einsum("ij,ij->i", rv, rv)
        r = np.sqrt(r2)
        incl = r < h
        near0 = r < 1e-7
        sel = incl & (np.arange(n) != i)
        coeff = press[sel] / rho[sel] ** 2 + press[i] / rho[i] ** 2
        rr = r[sel]
        sg = np.where(
            near0[sel, None],
            np.full((sel.sum(), 3), c_spiky),
            c_spiky * rv[sel] / np.where(near0[sel, None], 1.0, rr[:, None])
            * (h - rr[:, None]) ** 2,
        )
        pr = (coeff[:, None] * mass * sg).sum(axis=0)
        vi = (
            (vel[sel] - vel[i]) * (mass / rho[sel])[:, None] * c_visc
            * (h - rr)[:, None]
        ).sum(axis=0)
        t = (h * h - r2)[incl]
        normal = (
            (mass / rho[incl])[:, None] * c_grad * rv[incl] * (t**2)[:, None]
        ).sum(axis=0)
        lap = (mass / rho[incl] * c_lap * t * (3 * h * h - 7 * r2[incl])).sum()
        total = -rho[i] * pr + params.dynamic_viscosity * vi
        nlen = np.linalg.norm(normal)
        if nlen > params.surface_tension_threshold:
            total += -params.surface_tension * lap * normal / nlen
        acc[k] = total / rho[i] + np.asarray(params.constant_acceleration)
        nlens[k] = nlen
    return acc, nlens


def rel_rms(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.sqrt(np.sum((got - ref) ** 2) / np.sum(ref**2)))


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax
    import jax.numpy as jnp

    from bench import build_params
    from libclsph_tpu.core.state import init_state
    from libclsph_tpu.engine.step import StepConfig, substep_jit

    n = int(os.environ.get("FIDELITY_N", "65536"))
    settle = int(os.environ.get("FIDELITY_SETTLE", "20"))
    params = build_params(n)
    cfg = StepConfig(max_candidates=96)
    print(f"platform={jax.devices()[0].platform} impl={cfg.neighbor_impl}",
          file=sys.stderr)

    state = init_state(params)
    dt = jnp.float32(params.max_dt)
    t0 = time.perf_counter()
    for _ in range(settle):
        state, dt, flags = substep_jit(state, dt, params, None, cfg)
    if int(flags):
        sys.exit(f"flags {int(flags)} while settling")
    print(f"settled {settle} substeps in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)

    # one more substep at negligible dt: density/accel are evaluated on
    # the input positions; the substep sorts, so match rows by quantized
    # position order (the 1e-9 dt moves positions by <= |v| * 1e-9)
    pos0 = np.asarray(state.position, np.float64)
    vel0 = np.asarray(state.velocity, np.float64)
    out, _, _ = substep_jit(state, jnp.float32(1e-9), params, None, cfg)

    def order(p):
        return np.lexsort(np.round(p, 6).T)

    o_ref = order(pos0)
    o_dev = order(np.asarray(out.position, np.float64))
    pos, vel = pos0[o_ref], vel0[o_ref]
    rho_dev = np.asarray(out.density, np.float64)[o_dev]
    acc_dev = np.asarray(out.acceleration, np.float64)[o_dev]

    rho = oracle_density(pos, params)
    rows = np.sort(np.random.default_rng(7).choice(n, 512, replace=False))
    acc, _ = oracle_accel(pos, vel, rho, params, rows)
    print(f"density: RMS rel {rel_rms(rho_dev, rho):.3e}  "
          f"max rel {np.max(np.abs(rho_dev - rho) / rho):.3e}")
    print(f"accel: RMS rel {rel_rms(acc_dev[rows], acc):.3e}")


if __name__ == "__main__":
    main()
