"""Wavefront path-tracing integrator.

The reference integrator is a *recursive* per-ray function
(``ray_color``, RayTracer.h:579-596) on the CPU and an iterative
throughput/radiance loop in each GPU kernel (GpuPathTracer.cpp:204-258).
Recursion and data-dependent loop exits do not exist under XLA, so this
integrator is the wavefront transformation: a ``lax.scan`` over bounce depth on
SoA ray state with an alive mask. Dead lanes ride along masked (no compaction;
occupancy-driven compaction is a later optimization — SURVEY.md §5
"long-context" note).

Semantics map (bounce b, alive ray):
    miss           -> radiance += throughput * sky(d);        die
    hit, scatter   -> throughput *= attenuation;              continue
    hit, absorbed  -> die (black, RayTracer.h:590)
    hit, emissive  -> radiance += throughput * emission * w;  die (NEE ext.)
    depth exhausted-> contributes 0 (depth<=0 -> black, RayTracer.h:582)

Next-event estimation (nee=True; no reference analog, BASELINE config 2):
one-sample MIS between light sampling and BSDF sampling with the balance
heuristic. At every diffuse hit one light (emissive sphere OR triangle) is
picked uniformly and sampled (cone / uniform-area respectively); the
contribution uses the combined form f * cos / (pdf_nee + pdf_bsdf), and when
a BSDF-sampled diffuse ray then hits an emitter, its emission is weighted by
prev_pdf / (prev_pdf + pdf_nee(hit)) instead of being double-counted.
Specular-generated and camera rays take emitter hits at full weight.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import materials, sampling, vecmath as vm
from .world import World, WorldLights, as_world, intersect_world, world_lights
from .scene import LAMBERTIAN, SphereScene

INV_PI = 0.3183098861837907


class RayState(NamedTuple):
    origin: jnp.ndarray      # [N,3]
    direction: jnp.ndarray   # [N,3]
    throughput: jnp.ndarray  # [N,3]
    radiance: jnp.ndarray    # [N,3]
    alive: jnp.ndarray       # [N] bool
    prev_pdf: jnp.ndarray    # [N] solid-angle pdf of the bounce that produced
    #                          this ray (cosine/pi for diffuse); -1 = camera
    #                          or specular ray -> emitter hits at full weight


def _onb(w):
    """Branchless orthonormal basis around unit vector w (Duff et al. 2017)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    sign = jnp.where(wz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + wz)
    b = wx * wy * a
    t1 = jnp.stack([1.0 + sign * wx * wx * a, sign * b, -sign * wx], axis=-1)
    t2 = jnp.stack([b, sign + wy * wy * a, -wy], axis=-1)
    return t1, t2


def _sphere_solid_angle_pdf(center, radius, from_point):
    """Solid-angle pdf of cone sampling a sphere light from a point
    (0 where the sampler could not produce the direction: inside the
    sphere, or a degenerate cone). Uses the stable 1-cos_max =
    sin2/(1+cos_max) form (no cancellation for small/far lights)."""
    to_l = center - from_point
    dist2 = vm.length_squared(to_l)
    outside = dist2 > radius * radius * 1.0001
    sin2 = jnp.clip(radius * radius / jnp.maximum(dist2, 1e-12), 0.0, 1.0)
    cos_max = vm.safe_sqrt(1.0 - sin2)
    omc = sin2 / (1.0 + cos_max)                 # = 1 - cos_max, stable
    ok = outside & (omc > 1e-12)
    # NaN-safe denominator (double-where): the masked branch must see a
    # BENIGN denominator — with a raw 1e-30 clamp the backward partial
    # -1/den^2 overflows f32 to inf, and 0-cotangent * inf = NaN poisons
    # every geometry gradient (found via camera grads with NEE on).
    den = jnp.where(ok, jnp.maximum(2.0 * jnp.pi * omc, 1e-30), 1.0)
    pdf = jnp.where(ok, 1.0 / den, 0.0)
    return pdf, ok, cos_max, to_l, dist2


def _nee_direction(lights: WorldLights, p, u4, u5, u6):
    """The NEE candidate direction + pdf from point p, given the slot
    uniforms — pure math, split out so diff/edge.py can re-trace the SAME
    light sample DIFFERENTIABLY through a moving p (shadow-edge term).
    Returns (ldir unit, pdf_j, valid, row, exp_prim, is_tri)."""
    n_lights = lights.n_total
    ns = lights.n_sphere
    pick = jnp.clip((u4 * n_lights).astype(jnp.int32), 0, n_lights - 1)
    row = lights.table[pick]                               # [N,16]
    exp_prim = lights.expected_prim[pick]
    is_tri = pick >= ns

    # --- sphere light: cone sample (RayTracer-free extension) ---
    lc, lr = row[:, 0:3], row[:, 3]
    pdf_sph, ok_sph, cos_max, _, _ = _sphere_solid_angle_pdf(lc, lr, p)
    w_axis = vm.safe_unit_vector(lc - p)
    cos_a = 1.0 - u5 * (1.0 - cos_max)
    sin_a = vm.safe_sqrt(1.0 - cos_a * cos_a)
    phi = 2.0 * jnp.pi * u6
    t1, t2 = _onb(w_axis)
    dir_sph = (sin_a * jnp.cos(phi))[:, None] * t1 \
        + (sin_a * jnp.sin(phi))[:, None] * t2 + cos_a[:, None] * w_axis

    # --- triangle light: uniform-area sample ---
    v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    flip = u5 + u6 > 1.0
    bu = jnp.where(flip, 1.0 - u5, u5)
    bv = jnp.where(flip, 1.0 - u6, u6)
    p_l = v0 + bu[:, None] * e1 + bv[:, None] * e2
    wv = p_l - p
    d2 = vm.length_squared(wv)
    dir_tri = vm.safe_unit_vector(wv)
    cr = jnp.cross(e1, e2)
    two_area = vm.safe_sqrt(vm.length_squared(cr))
    area = 0.5 * two_area
    n_l = cr / jnp.maximum(two_area, 1e-20)[:, None]
    cos_l = jnp.abs(vm.dot(n_l, dir_tri))
    ok_tri = (d2 > 1e-12) & (cos_l > 1e-7) & (area > 1e-20)
    # NaN-safe denominator: see _sphere_solid_angle_pdf. With sphere-light
    # rows (area == 0) the raw clamp's backward partial -d2/1e-60 is inf.
    den_t = jnp.where(ok_tri, jnp.maximum(cos_l * area, 1e-30), 1.0)
    pdf_tri = jnp.where(ok_tri, d2 / den_t, 0.0)

    ldir = jnp.where(is_tri[:, None], dir_tri, dir_sph)    # unit
    pdf_j = jnp.where(is_tri, pdf_tri, pdf_sph)
    valid = jnp.where(is_tri, ok_tri, ok_sph)
    return ldir, pdf_j, valid, row, exp_prim, is_tri


def _nee_mis(world: World, lights: WorldLights, hits, throughput,
             diffuse_mask, uniforms, t_min, intersector):
    """One-sample MIS next-event estimation over the unified light table.

    Estimator (balance heuristic, light-sample side): for the uniformly
    picked light j with solid-angle pdf p_j,

        L += T * albedo/pi * cos_surf * Le / (p_j/L + cos_surf/pi)

    (the 1/pdf and the MIS weight combine into one denominator — no infs for
    degenerate cones). Uniform slots: 4 = pick, 5/6 = cone angles (sphere) or
    barycentrics (triangle); identical to the pre-MIS layout.
    """
    n_lights = lights.n_total
    u4, u5, u6 = uniforms[:, 4], uniforms[:, 5], uniforms[:, 6]
    p = hits.point
    normal = hits.normal

    ldir, pdf_j, valid, row, exp_prim, _ = _nee_direction(
        lights, p, u4, u5, u6)

    cos_surf = vm.dot(normal, ldir)
    cand = diffuse_mask & valid & (cos_surf > 0.0)

    shadow = intersect_world(world, p, ldir, t_min, backend=intersector,
                             alive=cand)
    lit = cand & shadow.hit & (shadow.prim_idx == exp_prim)

    le = row[:, 9:12]
    pdf_nee = pdf_j / n_lights
    denom = pdf_nee + cos_surf * INV_PI                    # balance heuristic
    # factor is only consumed under lit (a subset of cand); cand lanes have
    # cos_surf > 0 so denom > 0 — NaN-safe denominator as above.
    den_f = jnp.where(cand, jnp.maximum(denom, 1e-30), 1.0)
    factor = jnp.where(cand, cos_surf * INV_PI / den_f, 0.0)
    contrib = throughput * hits.albedo * factor[:, None] * le
    return jnp.where(lit[:, None], contrib, 0.0)


def _emitter_mis_weight(world: World, lights: WorldLights, hits, origin,
                        prev_pdf):
    """Balance-heuristic weight for BSDF-sampled emitter hits: the pdf with
    which NEE *would have* sampled this exact direction from this ray's
    origin (same guards as _nee_mis, so the two sides partition to 1)."""
    num_spheres = world.spheres.num_spheres
    is_sphere = hits.prim_idx < num_spheres
    outward = jnp.where(hits.front_face[:, None], hits.normal, -hits.normal)
    center = hits.point - hits.radius[:, None] * outward
    pdf_sph, _, _, _, _ = _sphere_solid_angle_pdf(center, hits.radius, origin)

    wv = hits.point - origin
    d2 = vm.length_squared(wv)
    w_hat = vm.safe_unit_vector(wv)
    cos_l = jnp.abs(vm.dot(hits.normal, w_hat))            # unit geom normal
    ok_tri = (d2 > 1e-12) & (cos_l > 1e-7) & (hits.area > 1e-20)
    den_t = jnp.where(ok_tri, jnp.maximum(cos_l * hits.area, 1e-30), 1.0)
    pdf_tri = jnp.where(ok_tri, d2 / den_t, 0.0)

    pdf_nee = jnp.where(is_sphere, pdf_sph, pdf_tri) / lights.n_total
    use_mis = prev_pdf > 0.0
    denom = jnp.where(use_mis, prev_pdf + pdf_nee, 1.0)
    return jnp.where(use_mis, prev_pdf / denom, 1.0)


def sky_color(directions):
    """Vertical white->blue gradient on miss (RayTracer.h:593-595)."""
    unit = vm.safe_unit_vector(directions)
    t = 0.5 * (unit[..., 1] + 1.0)
    white = jnp.array([1.0, 1.0, 1.0], directions.dtype)
    blue = jnp.array([0.5, 0.7, 1.0], directions.dtype)
    return (1.0 - t)[..., None] * white + t[..., None] * blue


def trace(
    scene: SphereScene,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    sample_keys: jnp.ndarray,
    max_depth: int,
    t_min: float = 1.0e-3,
    intersector: str = "xla",
    nee: bool = False,
    rr_start: int = 0,
    exclude_prim0=None,
) -> jnp.ndarray:
    """Trace N rays to completion; returns linear radiance [N,3].

    sample_keys: [N] per-ray threefry keys; bounce b consumes stream
    STREAM_BOUNCE0+b (counter-based, shard-invariant).

    nee: enable MIS next-event estimation (direct light sampling at diffuse
    hits over ALL emissive primitives — spheres and mesh faces — with
    balance-heuristic weighting of BSDF-sampled emitter hits; unbiased,
    massively lower variance in enclosed emissive scenes like the Cornell
    box). Compiled out when the world has no lights.

    rr_start: Russian-roulette termination from this bounce index on
    (0 = off, reference semantics). Survival probability = clamp(max
    throughput channel, 0.05, 1.0) with exact throughput compensation —
    unbiased; kills deep low-energy paths so whole ray blocks go dead and
    the kernels skip them. Uses uniform slot 7 (oracle-mirrored).

    exclude_prim0: optional [N] i32 — per-ray sphere index excluded from the
    BOUNCE-0 intersection only (-1 = none). The background radiance of the
    edge-aware silhouette estimator (diff/edge.py): "what this primary ray
    would see if the winning sphere were absent". Every intersector
    supports it.

    scene may be a SphereScene or a World (spheres + triangle mesh).
    """
    world = as_world(scene)
    lights = world_lights(world)
    do_nee = bool(nee) and lights.n_total > 0

    # Derive the initial carry from the ray inputs (origins * 0) rather than
    # fresh constants: under shard_map, constants are "unvarying" over mesh
    # axes while the loop output varies, and lax.scan requires carry types to
    # match exactly (jax >= 0.9 varying-manual-axes check).
    zero3 = origins * 0.0
    true_mask = zero3[..., 0] == 0.0
    state = RayState(
        origin=origins,
        direction=directions,
        throughput=zero3 + 1.0,
        radiance=zero3,
        alive=true_mask,
        prev_pdf=zero3[..., 0] - 1.0,
    )

    def bounce(state: RayState, depth_idx):
        if exclude_prim0 is not None:
            # Exclusion applies to the primary segment only; depth_idx is
            # traced data, so gate with where (no Python branch in-scan).
            excl = jnp.where(depth_idx == 0, exclude_prim0,
                             jnp.full_like(exclude_prim0, -1))
        else:
            excl = None
        hits = intersect_world(world, state.origin, state.direction,
                               t_min, backend=intersector,
                               alive=state.alive, exclude=excl)

        uniforms = sampling.stream_uniforms(
            sample_keys, sampling.STREAM_BOUNCE0 + depth_idx,
            sampling.UNIFORMS_PER_BOUNCE,
        )
        sc = materials.scatter(
            hits.mat_type, hits.albedo, hits.fuzz, hits.ior, hits.emission,
            state.direction, hits.normal, hits.front_face, uniforms,
        )

        miss = state.alive & ~hits.hit
        emit_hit = state.alive & hits.hit
        if do_nee:
            emit_w = _emitter_mis_weight(world, lights, hits, state.origin,
                                         state.prev_pdf)
        else:
            emit_w = 1.0 + zero3[:, 0]
        radiance = state.radiance
        radiance = radiance + jnp.where(
            miss[:, None], state.throughput * sky_color(state.direction), 0.0
        )
        radiance = radiance + jnp.where(
            emit_hit[:, None], state.throughput * sc.emitted * emit_w[:, None],
            0.0
        )

        diffuse_hit = state.alive & hits.hit & (hits.mat_type == LAMBERTIAN)
        if do_nee:
            radiance = radiance + _nee_mis(
                world, lights, hits, state.throughput, diffuse_hit,
                uniforms, t_min, intersector)

        continues = state.alive & hits.hit & sc.ok
        throughput = jnp.where(
            continues[:, None], state.throughput * sc.attenuation, state.throughput
        )
        if rr_start > 0:
            p_cont = jnp.clip(jnp.max(throughput, axis=-1), 0.05, 1.0)
            do_rr = continues & (depth_idx >= rr_start)
            survive = uniforms[:, 7] < p_cont
            throughput = jnp.where((do_rr & survive)[:, None],
                                   throughput / p_cont[:, None], throughput)
            continues = continues & (~do_rr | survive)
        origin = jnp.where(continues[:, None], hits.point, state.origin)
        direction = jnp.where(continues[:, None], sc.direction, state.direction)
        # pdf of the bounce that produced the continuing ray: cosine/pi for
        # diffuse (the next emitter hit is MIS-weighted), -1 sentinel for
        # specular (full weight) — only tracked when NEE is on.
        if do_nee:
            cos_next = vm.dot(hits.normal, vm.safe_unit_vector(sc.direction))
            pdf_next = jnp.where(diffuse_hit & continues,
                                 jnp.maximum(cos_next, 0.0) * INV_PI, -1.0)
            prev_pdf = jnp.where(continues, pdf_next, state.prev_pdf)
        else:
            prev_pdf = state.prev_pdf

        return RayState(origin, direction, throughput, radiance, continues,
                        prev_pdf), None

    state, _ = jax.lax.scan(bounce, state, jnp.arange(max_depth), unroll=1)
    return state.radiance
