"""World = spheres + optional triangle mesh, with a unified closest-hit.

The reference has exactly one primitive type (Sphere) and attaches materials
per object (include/raytracer/RayTracer.h:276-280); the mesh side is the
north-star config-4 extension with PER-FACE materials. A World merges both
primitive families into one Hits batch with a single id space:

    prim_idx < num_spheres          -> sphere hit
    prim_idx >= num_spheres         -> mesh triangle (idx - num_spheres)

(the offset keeps NEE's shadow test — "first hit IS the chosen light"
— correct when meshes occlude). Mesh hit distances are re-derived
differentiably for the winning triangle, so mesh vertices and materials are
gradient targets just like sphere parameters.

The world-level light table (emissive spheres + emissive faces) powers
MIS next-event estimation (core/integrator.py): row layout below.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..accel.mesh import TriangleMesh
from ..accel.traverse import intersect_mesh
from ..utils.pytree import pytree_dataclass
from . import vecmath as vm
from .intersect import BIG, Hits, intersect_spheres
from .scene import SphereScene


@pytree_dataclass
class World:
    spheres: SphereScene
    mesh: Optional[TriangleMesh]


def as_world(scene) -> World:
    """Accept a bare SphereScene (reference-parity API) or a full World."""
    if isinstance(scene, World):
        return scene
    return World(spheres=scene, mesh=None)


class WorldLights(NamedTuple):
    """Static-shape light table over both primitive families.

    table [L,16] rows (kind is STATIC: first n_sphere rows are spheres):
      sphere:   cx cy cz r  | 0 0 0 0 0 | ex ey ez | 0 0 0 0
      triangle: v0(3) e1(3) e2(3)       | ex ey ez | 0 0 0 0
    expected_prim [L]: unified prim id (sphere idx, or num_spheres + tri idx)
    the NEE shadow ray must hit first for the sample to count.
    """
    table: jnp.ndarray          # [L, 16] f32
    expected_prim: jnp.ndarray  # [L] i32
    n_sphere: int               # static sphere-light count
    n_total: int                # static total light count


def world_lights(world: World) -> WorldLights:
    """Assemble the light table (tiny: L gathers on scene arrays, fused by
    XLA; all shapes static so a light-less world compiles NEE out)."""
    sc = world.spheres
    mesh = world.mesh
    ls = sc.num_lights
    lt = mesh.num_lights if mesh is not None else 0
    rows = []
    prim = []
    if ls:
        li = sc.light_idx
        z = jnp.zeros((ls, 1), jnp.float32)
        rows.append(jnp.concatenate(
            [sc.center[li], sc.radius[li][:, None], z, z, z, z, z,
             sc.emission[li], z, z, z, z], axis=1))
        prim.append(li)
    if lt:
        ti = mesh.light_tri
        z = jnp.zeros((lt, 1), jnp.float32)
        rows.append(jnp.concatenate(
            [mesh.v0[ti], mesh.e1[ti], mesh.e2[ti], mesh.emission[ti],
             z, z, z, z], axis=1))
        prim.append(sc.num_spheres + ti)
    if not rows:
        return WorldLights(jnp.zeros((0, 16), jnp.float32),
                           jnp.zeros((0,), jnp.int32), 0, 0)
    return WorldLights(jnp.concatenate(rows, axis=0),
                       jnp.concatenate(prim, axis=0).astype(jnp.int32),
                       ls, ls + lt)


def face_param_table(mesh: TriangleMesh) -> jnp.ndarray:
    """[F,16] per-face row: gnx gny gnz area | ax ay az fuzz | ior mat ex ey |
    ez pad — same slot layout as the sphere packed_param_table (albedo..
    emission at 4..12), with geometry slots 0-3 holding the unit geometric
    normal and face area (what emitter-hit MIS weights need)."""
    f = mesh.num_triangles
    cr = jnp.cross(mesh.e1, mesh.e2)
    area = 0.5 * jnp.linalg.norm(cr, axis=1)
    return jnp.concatenate([
        mesh.geom_normal,                          # 0,1,2
        area[:, None],                             # 3
        mesh.albedo,                               # 4,5,6
        mesh.fuzz[:, None],                        # 7
        mesh.ior[:, None],                         # 8
        mesh.mat_type[:, None].astype(jnp.float32),  # 9
        mesh.emission,                             # 10,11,12
        jnp.zeros((f, 3), jnp.float32),            # pad to 16
    ], axis=1)


def _tri_t_diff(mesh: TriangleMesh, tri_idx, o, d, t_min, t_max):
    """Differentiable Möller-Trumbore t for per-lane selected triangles
    (the gradient path for mesh geometry; the traversal itself is detached)."""
    v0 = mesh.v0[tri_idx]
    e1 = mesh.e1[tri_idx]
    e2 = mesh.e2[tri_idx]
    p = jnp.cross(d, e2)
    det = jnp.sum(p * e1, axis=-1)
    ok = jnp.abs(det) > 1e-12
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    s = o - v0
    q = jnp.cross(s, e1)
    t = jnp.sum(q * e2, axis=-1) * inv_det
    return t, ok & (t >= t_min) & (t <= t_max)


def intersect_world(world: World, origins, directions, t_min,
                    backend: str = "xla", alive=None, exclude=None) -> Hits:
    """Closest hit over every primitive family, merged into one Hits.

    exclude: optional [N] i32 per-ray UNIFIED prim index to mask out
    (-1 = none): ids < num_spheres exclude that sphere, ids >= num_spheres
    exclude triangle (id - num_spheres) from the mesh search — the
    edge-aware gradient background re-trace (diff/edge.py)."""
    ns = world.spheres.num_spheres
    excl_s = excl_m = None
    if exclude is not None:
        exclude = jax.lax.stop_gradient(exclude)
        excl_s = jnp.where((exclude >= 0) & (exclude < ns), exclude, -1)
        excl_m = jnp.where(exclude >= ns, exclude - ns, -1)
    hs = intersect_spheres(world.spheres, origins, directions, t_min,
                           backend=backend, alive=alive, exclude=excl_s)
    mesh = world.mesh
    if mesh is None:
        return hs

    # Cap the mesh search per lane at the sphere winner: subtrees beyond it
    # prune early (the oracle's mesh query is sphere-capped the same way).
    # Lanes whose true winner is a sphere come back as mesh-miss, which the
    # merge below reproduces exactly.
    cap = jnp.where(hs.hit, jax.lax.stop_gradient(hs.t), BIG)
    if backend in ("pallas", "pallas_interpret"):
        from ..accel.mesh import TriHit
        from ..kernels.bvh_search import bvh_search

        t_m, idx_m = bvh_search(mesh, origins, directions, float(t_min),
                                alive=alive, exclude=excl_m, t_cap=cap,
                                interpret=(backend == "pallas_interpret"))
        th = TriHit(t=t_m, tri_idx=idx_m, hit=t_m < BIG)
    else:
        th = intersect_mesh(mesh, origins, directions, t_min, t_max=cap,
                            alive=alive, exclude=excl_m)
    # Differentiable recompute of the winner's t (traversal is detached).
    t_d, ok_d = _tri_t_diff(mesh, th.tri_idx, origins, directions, t_min, BIG)
    t_tri = jnp.where(th.hit & ok_d, t_d, jax.lax.stop_gradient(th.t))

    closer = th.hit & (~hs.hit | (t_tri < hs.t))
    t = jnp.where(closer, t_tri, hs.t)
    hit = hs.hit | th.hit
    prim_idx = jnp.where(
        closer, world.spheres.num_spheres + th.tri_idx, hs.prim_idx)

    t_safe = jnp.where(hit, t, 1.0)
    point_m = origins + t_safe[:, None] * directions
    # ONE packed per-face row-gather for everything about the winning
    # triangle (same economics as the sphere packed_param_table).
    fp = face_param_table(mesh)[th.tri_idx]                # [N,16]
    gn = fp[:, 0:3]
    ff_m = vm.dot(directions, gn) < 0.0
    normal_m = jnp.where(ff_m[:, None], gn, -gn)

    sel3 = lambda m_val, s_val: jnp.where(closer[:, None], m_val, s_val)
    sel1 = lambda m_val, s_val: jnp.where(closer, m_val, s_val)

    return Hits(
        t=t, prim_idx=prim_idx, hit=hit,
        point=sel3(point_m, hs.point),
        normal=sel3(normal_m, hs.normal),
        front_face=sel1(ff_m, hs.front_face),
        mat_type=sel1(fp[:, 9].astype(jnp.int32), hs.mat_type),
        albedo=sel3(fp[:, 4:7], hs.albedo),
        fuzz=sel1(fp[:, 7], hs.fuzz),
        ior=sel1(fp[:, 8], hs.ior),
        emission=sel3(fp[:, 10:13], hs.emission),
        radius=sel1(jnp.zeros_like(t), hs.radius),
        area=sel1(fp[:, 3], jnp.zeros_like(t)),
    )
