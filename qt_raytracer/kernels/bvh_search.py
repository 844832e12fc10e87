"""Closest-hit triangle search over the mesh BVH as a Pallas kernel for the
GPU (Triton route).

Same traversal as accel/traverse.intersect_mesh: a stackless walk of the
escape-index BVH (accel/bvh.py), one node pointer per ray. An inner box that
is hit steps to i+1, a miss or a finished leaf jumps to escape[i], and a leaf
tests its (at most max_leaf) contiguous triangles with Möller-Trumbore. The
difference is where the loop lives. intersect_mesh runs one while loop over
the whole wavefront, so the slowest ray of the chunk sets every ray's trip
count. Here each program walks its own block of rays, so the slowest ray of
the block sets it, and node and triangle data come from per-lane gathers out
of the L2-resident tables.

Contract (as intersect_mesh with a per-lane t_max): alive masks dead rays to
a miss, exclude masks one triangle per ray (-1 = none), and t_cap bounds the
search per ray, so a triangle beyond the ray's sphere winner is never taken
and such a ray returns a miss. Outputs are detached; callers re-derive t from
the winning index (core/world._tri_t_diff).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .sphere_search import _pad, _varying_axes

BIG = np.float32(3.0e38)

# Chosen by measurement on the H100 (PERF.md, kernel table).
BLOCK_RAYS = 32
NUM_WARPS = 1


def _search_kernel(ox, oy, oz, dx, dy, dz, alive, excl, cap,
                   bminx, bminy, bminz, bmaxx, bmaxy, bmaxz, esc, start,
                   count, v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z,
                   t_out, idx_out, *, t_min: float, num_nodes: int,
                   num_tris: int, max_leaf: int):
    o_x, o_y, o_z = ox[...], oy[...], oz[...]
    d_x, d_y, d_z = dx[...], dy[...], dz[...]
    live = alive[...] != 0
    t_cap = cap[...]
    ex = excl[...] if excl is not None else None
    m = num_nodes

    # 1/d with the reference's inf semantics (RayTracer.h:231), as
    # accel/traverse.intersect_mesh.
    def inv(c):
        return 1.0 / jnp.where(jnp.abs(c) < 1e-30,
                               jnp.where(c < 0, -1e-30, 1e-30), c)

    ix, iy, iz = inv(d_x), inv(d_y), inv(d_z)

    def tri_t(tri, t_hi):
        """Möller-Trumbore t for one triangle per lane (BIG if invalid)."""
        a_x, a_y, a_z = v0x[tri], v0y[tri], v0z[tri]
        p1x, p1y, p1z = e1x[tri], e1y[tri], e1z[tri]
        p2x, p2y, p2z = e2x[tri], e2y[tri], e2z[tri]
        px = d_y * p2z - d_z * p2y
        py = d_z * p2x - d_x * p2z
        pz = d_x * p2y - d_y * p2x
        det = px * p1x + py * p1y + pz * p1z
        ok_det = jnp.abs(det) > 1e-12
        inv_det = jnp.where(ok_det, 1.0 / jnp.where(ok_det, det, 1.0), 0.0)
        s_x, s_y, s_z = o_x - a_x, o_y - a_y, o_z - a_z
        u = (s_x * px + s_y * py + s_z * pz) * inv_det
        q_x = s_y * p1z - s_z * p1y
        q_y = s_z * p1x - s_x * p1z
        q_z = s_x * p1y - s_y * p1x
        v = (q_x * d_x + q_y * d_y + q_z * d_z) * inv_det
        t = (q_x * p2x + q_y * p2y + q_z * p2z) * inv_det
        ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t >= t_min) & (t <= t_hi))
        return jnp.where(ok, t, BIG)

    def cond(carry):
        ptr, _, _ = carry
        return jnp.max((ptr < m).astype(jnp.int32)) > 0

    def body(carry):
        ptr, tb, ib = carry
        active = ptr < m
        p = jnp.minimum(ptr, m - 1)

        # Slab test against min(best, cap) (RayTracer.h:229-244).
        t0x, t1x = (bminx[p] - o_x) * ix, (bmaxx[p] - o_x) * ix
        t0y, t1y = (bminy[p] - o_y) * iy, (bmaxy[p] - o_y) * iy
        t0z, t1z = (bminz[p] - o_z) * iz, (bmaxz[p] - o_z) * iz
        enter = jnp.maximum(
            jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
            jnp.maximum(jnp.minimum(t0z, t1z), t_min))
        exit_ = jnp.minimum(
            jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
            jnp.minimum(jnp.maximum(t0z, t1z), jnp.minimum(tb, t_cap)))
        box_ok = active & (exit_ > enter)
        cnt = count[p]
        is_leaf = cnt > 0
        do_leaf = box_ok & is_leaf

        def leaf(tb, ib):
            first = start[p]
            for k in range(max_leaf):
                tri = jnp.minimum(first + k, num_tris - 1)
                t_k = tri_t(tri, jnp.minimum(tb, t_cap))
                take = do_leaf & (k < cnt) & (t_k < tb)
                if ex is not None:
                    take = take & (tri != ex)
                tb = jnp.where(take, t_k, tb)
                ib = jnp.where(take, tri, ib)
            return tb, ib

        any_leaf = jnp.max(do_leaf.astype(jnp.int32)) > 0
        tb, ib = jax.lax.cond(any_leaf, leaf, lambda tb, ib: (tb, ib),
                              tb, ib)
        nxt = jnp.where(box_ok & ~is_leaf, ptr + 1, esc[p])
        return jnp.where(active, nxt, ptr), tb, ib

    ptr0 = jnp.where(live, 0, m).astype(jnp.int32)
    _, tb, ib = jax.lax.while_loop(
        cond, body, (ptr0, jnp.full(o_x.shape, BIG, jnp.float32),
                     jnp.zeros(o_x.shape, jnp.int32)))
    t_out[...] = tb
    idx_out[...] = ib




@functools.partial(jax.jit, static_argnames=(
    "t_min", "max_leaf", "interpret", "block_rays", "num_warps"))
def bvh_search(mesh, origins, directions, t_min: float, alive=None,
               exclude=None, t_cap=None, max_leaf: int = 4,
               interpret: bool = False, block_rays: int = BLOCK_RAYS,
               num_warps: int = NUM_WARPS):
    """Closest triangle per ray: (t [N] f32, BIG on a miss; tri_idx [N] i32,
    0 on a miss), in the mesh's BVH order.

    alive: optional [N] bool, dead rays return a miss.
    exclude: optional [N] i32 triangle masked out per ray (-1 = none).
    t_cap: optional [N] f32 per-ray upper bound on t (BIG = none).
    block_rays/num_warps: measurement parameters; callers use the defaults.
    """
    origins = jax.lax.stop_gradient(origins)
    directions = jax.lax.stop_gradient(directions)
    mesh = jax.lax.stop_gradient(mesh)

    n = origins.shape[0]
    n_pad = max(-(-n // block_rays) * block_rays, block_rays)
    rays = [_pad(origins[:, i], n_pad, 0.0) for i in range(3)]
    rays += [_pad(directions[:, i], n_pad, 1.0) for i in range(3)]
    live = (jnp.ones((n,), jnp.int32) if alive is None
            else jax.lax.stop_gradient(alive).astype(jnp.int32))
    rays.append(_pad(live, n_pad, 0))
    if exclude is not None:
        rays.append(_pad(jax.lax.stop_gradient(exclude).astype(jnp.int32),
                         n_pad, -1))
    cap = (jnp.full((n,), BIG, jnp.float32) if t_cap is None
           else jax.lax.stop_gradient(t_cap).astype(jnp.float32))
    rays.append(_pad(cap, n_pad, BIG))

    nodes = ([mesh.bvh_min[:, i] for i in range(3)]
             + [mesh.bvh_max[:, i] for i in range(3)]
             + [mesh.bvh_escape, mesh.bvh_start, mesh.bvh_count])
    tris = [x[:, i] for x in (mesh.v0, mesh.e1, mesh.e2) for i in range(3)]

    kernel = functools.partial(_search_kernel, t_min=float(t_min),
                               num_nodes=mesh.bvh_escape.shape[0],
                               num_tris=mesh.num_triangles,
                               max_leaf=max_leaf)
    if exclude is None:
        body = kernel

        def kernel(*refs):
            return body(*refs[:7], None, *refs[7:])

    vma = _varying_axes(*rays, *nodes, *tris)
    ray_spec = pl.BlockSpec((block_rays,), lambda i: (i,))
    full = lambda x: pl.BlockSpec(x.shape, lambda i: (0,))
    t, idx = pl.pallas_call(
        kernel,
        grid=(n_pad // block_rays,),
        in_specs=([ray_spec] * len(rays) + [full(x) for x in nodes]
                  + [full(x) for x in tris]),
        out_specs=(ray_spec, ray_spec),
        out_shape=(jax.ShapeDtypeStruct((n_pad,), jnp.float32, vma=vma),
                   jax.ShapeDtypeStruct((n_pad,), jnp.int32, vma=vma)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="bvh_search",
    )(*rays, *nodes, *tris)
    return (jax.lax.stop_gradient(t[:n]), jax.lax.stop_gradient(idx[:n]))
