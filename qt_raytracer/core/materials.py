"""Materials as masked vector evaluation.

The reference dispatches ``Material::scatter`` virtually per ray
(RayTracer.h:468-540). Here all three BSDFs are evaluated for every ray as
vector ops and the result is selected by material tag (``jnp.where``) — three
cheap branches beat gather/scatter repacking (SURVEY.md "Divergence of material
dispatch"). Every branch consumes fixed uniform slots (core/sampling.py layout)
so the random stream is identical regardless of which branch wins, which the
scalar oracle relies on.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from . import sampling, vecmath as vm
from .scene import DIELECTRIC, EMISSIVE, LAMBERTIAN, METAL


class Scatter(NamedTuple):
    direction: jnp.ndarray    # [N,3] next ray direction
    attenuation: jnp.ndarray  # [N,3] throughput multiplier
    ok: jnp.ndarray           # [N] bool: ray continues (False = absorbed)
    emitted: jnp.ndarray      # [N,3] radiance emitted at the hit (emissive tag)


def scatter(
    mat_type: jnp.ndarray,
    albedo: jnp.ndarray,
    fuzz: jnp.ndarray,
    ior: jnp.ndarray,
    emission: jnp.ndarray,
    in_dir: jnp.ndarray,
    normal: jnp.ndarray,
    front_face: jnp.ndarray,
    uniforms: jnp.ndarray,
) -> Scatter:
    """Batched scatter for all rays, on pre-gathered per-ray material params
    (Hits.mat_type..emission — one packed gather in intersect_spheres, since
    one row-gather replaces per-field gathers). uniforms: [N, 8] block."""
    u0, u1, u2, u3 = (uniforms[:, i] for i in range(4))
    unit_in = vm.safe_unit_vector(in_dir)

    # --- Lambertian (RayTracer.h:473-488): normal + random_unit_vector with
    # degenerate-direction guard.
    rand_unit = sampling.random_unit_vector(u0, u1)
    lam_dir = normal + rand_unit
    degenerate = vm.length_squared(lam_dir) < 1.0e-8
    lam_dir = jnp.where(degenerate[:, None], normal, lam_dir)

    # --- Metal (RayTracer.h:490-504): mirror + fuzz * in_unit_sphere; absorbed
    # when scattered below the surface.
    reflected = vm.reflect(unit_in, normal)
    met_dir = reflected + fuzz[:, None] * sampling.random_in_unit_sphere(u0, u1, u2)
    met_ok = vm.dot(met_dir, normal) > 0.0

    # --- Dielectric (RayTracer.h:506-540): Schlick vs uniform, TIR check,
    # white attenuation.
    ratio = jnp.where(front_face, 1.0 / ior, ior)
    cos_theta = jnp.minimum(vm.dot(-unit_in, normal), 1.0)
    sin_theta = vm.safe_sqrt(1.0 - cos_theta * cos_theta)
    cannot_refract = ratio * sin_theta > 1.0
    must_reflect = cannot_refract | (_reflectance(cos_theta, ratio) > u3)
    die_dir = jnp.where(
        must_reflect[:, None],
        vm.reflect(unit_in, normal),
        vm.refract(unit_in, normal, ratio),
    )

    # --- Select by tag.
    is_lam = mat_type == LAMBERTIAN
    is_met = mat_type == METAL
    is_die = mat_type == DIELECTRIC
    is_emit = mat_type == EMISSIVE

    direction = jnp.where(
        is_lam[:, None], lam_dir, jnp.where(is_met[:, None], met_dir, die_dir)
    )
    white = jnp.ones_like(albedo)
    attenuation = jnp.where(is_die[:, None] | is_emit[:, None], white, albedo)
    ok = jnp.where(is_met, met_ok, ~is_emit)
    emitted = jnp.where(is_emit[:, None], emission, jnp.zeros_like(emission))

    return Scatter(direction=direction, attenuation=attenuation, ok=ok, emitted=emitted)


def _reflectance(cosine, ref_idx):
    """Schlick's approximation (RayTracer.h:531-536)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    one_minus = 1.0 - cosine
    return r0 + (1.0 - r0) * one_minus ** 5
