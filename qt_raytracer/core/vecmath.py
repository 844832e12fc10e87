"""Batched 3-vector math on [..., 3] arrays.

Batched counterpart of the reference's scalar ``Vec3`` class and free
functions (include/raytracer/RayTracer.h:64-184). Everything is elementwise
over a trailing axis of 3 so XLA vectorizes across rays, and all helpers
are differentiable.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(u, v):
    """Batched dot product over the trailing axis (RayTracer.h:141-143)."""
    return jnp.sum(u * v, axis=-1)


def cross(u, v):
    """Batched cross product (RayTracer.h:145-149)."""
    return jnp.cross(u, v)


def length_squared(v):
    return jnp.sum(v * v, axis=-1)


def length(v):
    return jnp.sqrt(length_squared(v))


def unit_vector(v, eps: float = 0.0):
    """v / |v| (RayTracer.h:151-153). eps guards the degenerate zero vector."""
    return v / jnp.maximum(length(v), eps)[..., None] if eps else v / length(v)[..., None]


def reflect(v, n):
    """Mirror reflection v - 2(v.n)n (RayTracer.h:175-177)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, etai_over_etat):
    """Snell refraction of unit vector uv about n (RayTracer.h:179-184)."""
    cos_theta = jnp.minimum(dot(-uv, n), 1.0)
    r_out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    r_out_parallel = (
        -safe_sqrt(jnp.abs(1.0 - length_squared(r_out_perp)))[..., None] * n
    )
    return r_out_perp + r_out_parallel


def degrees_to_radians(deg):
    return deg * (jnp.pi / 180.0)


def safe_sqrt(x):
    """sqrt with a finite gradient at x<=0.

    d/dx sqrt(x) -> inf as x -> 0+; under jnp.where both branches are
    differentiated, so a bare sqrt(max(x, 0)) poisons gradients with
    inf * 0 = NaN (the JAX double-where pitfall). Forward value is identical
    to sqrt(max(x, 0)).
    """
    x_safe = jnp.where(x > 0.0, x, 1.0)
    return jnp.where(x > 0.0, jnp.sqrt(x_safe), 0.0)


def safe_unit_vector(v, fallback=None):
    """unit_vector with a NaN-free gradient for |v| ~ 0 lanes.

    Dead/masked lanes can carry zero vectors; dividing by |v|=0 breaks the
    backward pass for every parameter feeding v.
    """
    n2 = length_squared(v)
    ok = n2 > 1.0e-20
    inv = jnp.where(ok, 1.0 / jnp.sqrt(jnp.where(ok, n2, 1.0)), 0.0)
    unit = v * inv[..., None]
    if fallback is not None:
        unit = jnp.where(ok[..., None], unit, fallback)
    return unit
