"""Ray-primitive intersection.

The reference intersects via virtual dispatch down a pointer BVH
(RayTracer.h:431-439) or a serial 4-sphere loop in the GPU kernels
(GpuPathTracer.cpp:217-240). Here the closest-hit search over S spheres is a
vectorized argmin. The ray-sphere quadratic (RayTracer.h:289-314)

    oc     = o - c
    half_b = oc . d   = (o . d) - (c . d)
    cterm  = |oc|^2 - r^2 = |o|^2 - 2 (o . c) + |c|^2 - r^2

is expanded so that only the cross terms (c . d) and (o . c) are per
(ray, sphere) pair; an elementwise root/argmin chain follows over [N,S]. The
GPU kernel (kernels/sphere_search.py) runs the same expansion per pair
without forming [N,S] arrays. Larger primitive counts go through the mesh
BVH (accel/).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import vecmath as vm
from .scene import SphereScene

BIG = np.float32(3.0e38)  # +inf stand-in that survives arithmetic; np not
#                           jnp: import must not init the XLA backend


class Hits(NamedTuple):
    """SoA hit record batch, the batched HitRecord (RayTracer.h:208-219).

    Material/geometry parameters of the winning primitive ride along
    (mat_type..emission), read by ONE packed [S,16] row-gather instead of
    seven scattered gathers across refinement, normals and material scatter.
    """

    t: jnp.ndarray           # [N] hit distance (BIG when miss)
    prim_idx: jnp.ndarray    # [N] i32 index of nearest primitive (0 if miss)
    hit: jnp.ndarray         # [N] bool
    point: jnp.ndarray       # [N,3] hit point
    normal: jnp.ndarray      # [N,3] forward-facing normal
    front_face: jnp.ndarray  # [N] bool (RayTracer.h:215-218 set_face_normal)
    mat_type: jnp.ndarray    # [N] i32 material tag of winner
    albedo: jnp.ndarray      # [N,3]
    fuzz: jnp.ndarray        # [N]
    ior: jnp.ndarray         # [N]
    emission: jnp.ndarray    # [N,3]
    radius: jnp.ndarray      # [N] winner sphere radius (0 for mesh winners);
    #                          emitter-hit MIS re-derives the light's cone pdf
    #                          from (point, normal, radius) without a regather
    area: jnp.ndarray        # [N] winner face area (0 for sphere winners)


def packed_param_table(scene: SphereScene) -> jnp.ndarray:
    """[S,16] row-table: cx cy cz r | ax ay az fuzz | ior mat ex ey | ez pad.
    Built fresh per call — tiny, constant-folded under jit."""
    s = scene.num_spheres
    return jnp.concatenate([
        scene.center,                             # 0,1,2
        scene.radius[:, None],                    # 3
        scene.albedo,                             # 4,5,6
        scene.fuzz[:, None],                      # 7
        scene.ior[:, None],                       # 8
        scene.mat_type[:, None].astype(jnp.float32),  # 9
        scene.emission,                           # 10,11,12
        jnp.zeros((s, 3), jnp.float32),           # pad to 16
    ], axis=1)


def sphere_hit_ts(scene: SphereScene, origins, directions, t_min, t_max,
                  exclude=None):
    """Per-(ray, sphere) nearest valid root, [N, S]; BIG where no valid hit.

    Exactly mirrors Sphere::hit root selection (RayTracer.h:289-305): try the
    near root (-half_b - sqrtd)/a, fall back to the far root, reject outside
    [t_min, t_max].

    exclude: optional [N] i32 — per-ray sphere index whose hits are masked
    out (-1 = none). Powers the silhouette-background re-trace of the
    edge-aware gradient estimator (diff/edge.py).
    """
    o, d = origins, directions
    c, r = scene.center, scene.radius

    a = vm.length_squared(d)[:, None]                       # [N,1]
    o_dot_d = vm.dot(o, d)[:, None]                         # [N,1]
    # The two K=3 cross products are written elementwise, not as
    # [N,3] @ [3,S] matmuls: XLA then fuses the whole chain into the argmin
    # reduction instead of writing [N,S] products to device memory (2x per
    # call, 2.6x on the 1080p headline frame on the H100; PERF.md). It also
    # keeps the products in full f32: a matmul here needs
    # precision=HIGHEST, since a GPU may run default-precision f32 matmuls
    # in TF32 (about three decimal digits), which yields phantom hits and
    # wrong closest hits on small spheres (~10% wrong winners on the
    # 480-sphere scene with reduced-precision products). The sum is written
    # in the order XLA:CPU contracts into the fused multiply-add chain of a
    # K=3 dot, so CPU results equal the matmul form's bit for bit (renders
    # that graze a surface at t_min flip on a 1-ulp difference).
    def cross(x):
        return ((x[:, 1:2] * c[None, :, 1] + x[:, 0:1] * c[None, :, 0])
                + x[:, 2:3] * c[None, :, 2])                # [N,S]

    d_dot_c = cross(d)
    o_dot_c = cross(o)
    half_b = o_dot_d - d_dot_c                              # [N,S]
    cterm = (
        vm.length_squared(o)[:, None] - 2.0 * o_dot_c
        + (vm.length_squared(c) - r * r)[None, :]
    )                                                       # [N,S]

    disc = half_b * half_b - a * cterm
    has_root = disc >= 0.0
    sqrtd = vm.safe_sqrt(disc)
    inv_a = 1.0 / a
    root_near = (-half_b - sqrtd) * inv_a
    root_far = (-half_b + sqrtd) * inv_a

    in_range = lambda t: (t >= t_min) & (t <= t_max)
    near_ok = in_range(root_near)
    root = jnp.where(near_ok, root_near, root_far)
    valid = has_root & (near_ok | in_range(root_far)) & scene.active[None, :]
    if exclude is not None:
        s = c.shape[0]
        valid = valid & (jnp.arange(s, dtype=jnp.int32)[None, :]
                         != exclude[:, None])
    return jnp.where(valid, root, BIG)


def intersect_spheres(
    scene: SphereScene, origins, directions, t_min, t_max=BIG,
    backend: str = "xla", alive=None, exclude=None,
) -> Hits:
    """Closest-hit over all spheres — HitableList::hit (RayTracer.h:339-353)
    as a vectorized argmin instead of a serial shrinking scan.

    backend: "xla" (portable [N,S] search), "pallas" (the GPU kernel,
    kernels/sphere_search.py), or "pallas_interpret" (that kernel in
    interpreter mode, for CPU tests). The kernel returns detached outputs;
    gradients always flow through the refinement recompute below.

    Tie-breaking: equal-t ties resolve to the lowest sphere index (the
    reference's serial scan resolves to the highest); ties are measure-zero
    and the oracle mirrors argmin semantics.
    """
    if backend == "xla":
        ts = sphere_hit_ts(scene, origins, directions, t_min, t_max,
                           exclude=exclude)                           # [N,S]
        prim_idx = jnp.argmin(ts, axis=1).astype(jnp.int32)           # [N]
        t_coarse = jnp.take_along_axis(ts, prim_idx[:, None], axis=1)[:, 0]
    else:
        from ..kernels.sphere_search import sphere_search

        t_coarse, prim_idx = sphere_search(
            scene, origins, directions, float(t_min), float(t_max),
            alive=alive, exclude=exclude,
            interpret=(backend == "pallas_interpret"))
    hit = t_coarse < BIG

    # ONE packed row-gather for everything the caller needs about the winner
    # (see packed_param_table docstring for the economics).
    params = packed_param_table(scene)[prim_idx]                  # [N,16]
    c_sel = params[:, 0:3]
    r_sel = params[:, 3]

    # Precision refinement: the expansion |o|^2 - 2 o.c + |c|^2 - r^2 is
    # ill-conditioned in f32 for large spheres (catastrophic cancellation at
    # |c| ~ 1e3). Recompute the winning sphere's roots with the
    # well-conditioned oc = o - c form (exactly Sphere::hit,
    # RayTracer.h:289-305) — O(N), negligible next to the O(N*S) search.
    oc = origins - c_sel
    a1 = vm.length_squared(directions)
    half_b1 = vm.dot(oc, directions)
    c1 = vm.length_squared(oc) - r_sel * r_sel
    disc1 = half_b1 * half_b1 - a1 * c1
    sqrtd1 = vm.safe_sqrt(disc1)
    # Numerically stable roots (Citardauq): the naive (-half_b - sqrt)/a form
    # cancels catastrophically for the near root when |a*c1| << half_b^2
    # (every ground-sphere hit: |c| ~ 1e3). q carries the non-cancelling sum;
    # the other root is c1/q. Same math as RayTracer.h:289-305, ~1e2 tighter
    # in f32 (and agreeing across XLA / kernel FMA-contraction choices).
    sq_signed = jnp.where(half_b1 >= 0.0, sqrtd1, -sqrtd1)
    q1 = -half_b1 - sq_signed
    q1_safe = jnp.where(q1 == 0.0, 1.0, q1)
    root_a = q1 / a1
    root_b = jnp.where(q1 == 0.0, 0.0, c1 / q1_safe)
    near1 = jnp.where(half_b1 >= 0.0, root_a, root_b)
    far1 = jnp.where(half_b1 >= 0.0, root_b, root_a)
    near_ok1 = (near1 >= t_min) & (near1 <= t_max)
    t_fine = jnp.where(near_ok1, near1, far1)
    fine_ok = (disc1 >= 0.0) & (near_ok1 | ((far1 >= t_min) & (far1 <= t_max)))
    t = jnp.where(hit & fine_ok, t_fine, t_coarse)

    # Miss lanes carry t=BIG; origin + BIG*d overflows to inf, and inf in the
    # untaken branch of a jnp.where poisons the backward pass with NaN (the
    # double-where pitfall). Use a masked-safe t for the geometric outputs —
    # they are meaningless (and fully masked) on miss lanes anyway.
    t_safe = jnp.where(hit, t, 1.0)
    point = origins + t_safe[:, None] * directions
    # Outward normal (p - c)/r (RayTracer.h:309); guard r=0 padding slots.
    outward = (point - c_sel) / jnp.where(r_sel == 0.0, 1.0, r_sel)[:, None]
    front_face = vm.dot(directions, outward) < 0.0
    normal = jnp.where(front_face[:, None], outward, -outward)

    return Hits(t=t, prim_idx=prim_idx, hit=hit, point=point,
                normal=normal, front_face=front_face,
                mat_type=params[:, 9].astype(jnp.int32),
                albedo=params[:, 4:7], fuzz=params[:, 7], ior=params[:, 8],
                emission=params[:, 10:13],
                radius=r_sel, area=jnp.zeros_like(t))
