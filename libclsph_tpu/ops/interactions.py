"""Pairwise SPH interaction sums (density and internal forces).

These are the numerics of compute_density_with_grid and
compute_internal_forces_with_grid (``libclsph/kernels/forces.cl:14-111``)
re-expressed over *padded candidate sets*: each query particle comes
with K candidate neighbours plus a validity mask. Because every
smoothing kernel already carries the hard support cutoff
``1 - clamp(floor(r/h),0,1)`` (smoothing.cl), any superset of the true
r<h neighbourhood yields identical sums — so the same functions serve
both the exact 27-cell gather path (ops/neighbors.py) and the block
paths (ops/tiles.py).

Shapes: query fields are (..., ) / (..., 3); candidate fields add a
trailing K axis: (..., K) / (..., K, 3). ``valid`` masks padding;
``is_self`` marks the query particle itself among its candidates (the
``i != current_particle_index`` exclusion, forces.cl:67/77).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core import smoothing
from ..core.params import PrecomputedKernelValues, SimulationParameters


class ForceTerms(NamedTuple):
    pressure_term: jnp.ndarray  # (..., 3)
    viscosity_term: jnp.ndarray  # (..., 3)
    normal: jnp.ndarray  # (..., 3) color-field gradient
    color_field_laplacian: jnp.ndarray  # (...,)


def density_sum(
    q_pos: jnp.ndarray,  # (..., 3)
    c_pos: jnp.ndarray,  # (..., K, 3)
    valid: jnp.ndarray,  # (..., K) bool
    params: SimulationParameters,
    terms: PrecomputedKernelValues,
) -> jnp.ndarray:
    """mass * sum_j W_poly6(|xi-xj|) — forces.cl:31-36 (self included)."""
    r = jnp.linalg.norm(q_pos[..., None, :] - c_pos, axis=-1)
    w = smoothing.poly_6(r, params.h, terms)
    return params.particle_mass * jnp.sum(jnp.where(valid, w, 0.0), axis=-1)


def tait_pressure(density: jnp.ndarray, params: SimulationParameters) -> jnp.ndarray:
    """Tait EOS p = K ((rho/rho0)^7 - 1) (sphb.cl:31-35)."""
    return params.K * ((density / params.fluid_density) ** 7 - 1.0)


def force_sums(
    q_pos: jnp.ndarray,
    q_vel: jnp.ndarray,
    q_density: jnp.ndarray,
    q_pressure: jnp.ndarray,
    c_pos: jnp.ndarray,
    c_vel: jnp.ndarray,
    c_density: jnp.ndarray,
    c_pressure: jnp.ndarray,
    valid: jnp.ndarray,
    is_self: jnp.ndarray,
    params: SimulationParameters,
    terms: PrecomputedKernelValues,
) -> ForceTerms:
    """The four neighbour sums of forces.cl:49-105.

    pressure (symmetrised Kelager 4.11 with spiky gradient), viscosity
    (Laplacian), surface-tension colour-field normal + Laplacian.
    """
    rvec = q_pos[..., None, :] - c_pos  # (..., K, 3)
    r = jnp.linalg.norm(rvec, axis=-1)  # (..., K)

    not_self = valid & ~is_self
    vmask = valid[..., None]
    nsmask = not_self[..., None]

    # Pressure: (pj/rhoj^2 + pi/rhoi^2) * m * spiky_grad(ri - rj), j != i.
    spiky = smoothing.spiky_gradient(rvec, params.h, terms)  # (..., K, 3)
    p_coeff = (
        c_pressure / c_density**2
        + (q_pressure / q_density**2)[..., None]
    ) * params.particle_mass
    pressure_term = jnp.sum(jnp.where(nsmask, p_coeff[..., None] * spiky, 0.0), axis=-2)

    # Viscosity: (vj - vi) * (m/rhoj) * visc_laplacian(r), j != i.
    visc_w = smoothing.viscosity_laplacian(r, params.h, terms)
    visc = (
        (c_vel - q_vel[..., None, :])
        * (params.particle_mass / c_density)[..., None]
        * visc_w[..., None]
    )
    viscosity_term = jnp.sum(jnp.where(nsmask, visc, 0.0), axis=-2)

    # Colour field (self included): normal = sum m/rhoj grad W_poly6,
    # laplacian = sum m/rhoj lap W_poly6.
    inv_rho = (params.particle_mass / c_density)[..., None]
    grad6 = smoothing.poly_6_gradient(rvec, params.h, terms)
    normal = jnp.sum(jnp.where(vmask, inv_rho * grad6, 0.0), axis=-2)
    lap6 = smoothing.poly_6_laplacian(r, params.h, terms)
    color_field_laplacian = jnp.sum(
        jnp.where(valid, (params.particle_mass / c_density) * lap6, 0.0), axis=-1
    )

    return ForceTerms(pressure_term, viscosity_term, normal, color_field_laplacian)


def combine_forces(
    f: ForceTerms,
    q_density: jnp.ndarray,
    params: SimulationParameters,
) -> jnp.ndarray:
    """Total acceleration (forces.cl:110-122).

    a = (-rho_i * pressure + mu * viscosity + surface_tension) / rho_i
        + constant_acceleration,
    surface tension applied only where |normal| > threshold.
    """
    total = (
        -q_density[..., None] * f.pressure_term
        + f.viscosity_term * params.dynamic_viscosity
    )
    nlen = jnp.linalg.norm(f.normal, axis=-1, keepdims=True)
    apply_st = nlen > params.surface_tension_threshold
    safe_nlen = jnp.where(apply_st, nlen, 1.0)
    st = (
        -params.surface_tension
        * f.color_field_laplacian[..., None]
        * f.normal
        / safe_nlen
    )
    total = total + jnp.where(apply_st, st, 0.0)
    accel = total / q_density[..., None]
    return accel + jnp.asarray(params.constant_acceleration, dtype=total.dtype)
