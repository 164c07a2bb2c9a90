"""SPH smoothing-kernel functions.

Two families:

* ``*_ref`` — literal float64 transcriptions of the reference's scaled-SI
  formulas (`/root/reference/src/owPhysicsConstant.h:69-71`,
  `/root/reference/src/sphFluid.cl:507,653,1160`). Used only as test oracles.
* nondimensional helpers — the forms the step functions use, where the
  argument is ``q = r / h_s`` in [0, 1] and all dimensional prefactors live in
  :class:`sph_jax.config.SimParams`.
"""
from __future__ import annotations

import math

import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Reference oracles (float64, scaled SI units) — for tests.
# ---------------------------------------------------------------------------

def w_poly6_ref(r: float, h_s: float) -> float:
    """Muller poly6 kernel W(r) = 315/(64 pi h^9) (h^2-r^2)^3 for r <= h."""
    if r > h_s:
        return 0.0
    c = 315.0 / (64.0 * math.pi * h_s ** 9)
    return c * (h_s ** 2 - r ** 2) ** 3


def grad_w_spiky_mag_ref(r: float, h_s: float) -> float:
    """|dW/dr| prefactor of the spiky kernel: -45/(pi h^6) (h-r)^2."""
    if r > h_s:
        return 0.0
    return -45.0 / (math.pi * h_s ** 6) * (h_s - r) ** 2


def del2_w_visc_ref(r: float, h_s: float) -> float:
    """Laplacian of the viscosity kernel: 45/(pi h^6) (h-r)."""
    if r > h_s:
        return 0.0
    return 45.0 / (math.pi * h_s ** 6) * (h_s - r)


# ---------------------------------------------------------------------------
# Nondimensional forms (f32-safe): argument q = r / h_s in [0, 1].
# ---------------------------------------------------------------------------

def poly6_term(q2: jnp.ndarray) -> jnp.ndarray:
    """(1 - q^2)^3, the O(1) poly6 factor; caller applies c_rho."""
    t = 1.0 - q2
    return t * t * t


def spiky_term(q: jnp.ndarray) -> jnp.ndarray:
    """(1 - q)^2, the O(1) spiky-gradient factor; caller applies c_press."""
    t = 1.0 - q
    return t * t


def visc_term(q: jnp.ndarray) -> jnp.ndarray:
    """(1 - q), the O(1) viscosity-Laplacian factor; caller applies c_visc."""
    return 1.0 - q
