"""BVH traversal in pure JAX: masked-lane stackless while loop.

Every ray carries a single node pointer through the escape-index layout
(accel/bvh.py): hit an inner box -> step to i+1; miss (or finish a leaf) ->
jump to escape[i]. All rays advance in lockstep under masks; the loop ends
when every lane has walked off the end. This replaces the reference's
recursive BVHNode::hit (RayTracer.h:431-439) with compiler-friendly control
flow; the Pallas kernel (kernels/bvh_search.py) walks the same layout with
one loop per block of rays on the GPU, this is the portable path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .mesh import TriangleMesh, TriHit

# np scalar, not jnp: module import must not initialize the XLA backend
# (multi-host bootstrap needs jax.distributed.initialize() FIRST —
# tests/distributed_worker.py).
BIG = np.float32(3.0e38)


def _slab_test(bmin, bmax, o, inv_d, t_min, t_max):
    """Batched AABB slab test (RayTracer.h:229-244 semantics)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    enter = jnp.maximum(jnp.max(lo, axis=-1), t_min)
    exit_ = jnp.minimum(jnp.min(hi, axis=-1), t_max)
    return exit_ > enter


def _tri_hit_one(mesh, tri_idx, o, d, t_min, t_max):
    """Möller-Trumbore for ONE (per-lane different) triangle per ray."""
    v0 = mesh.v0[tri_idx]
    e1 = mesh.e1[tri_idx]
    e2 = mesh.e2[tri_idx]
    p = jnp.cross(d, e2)
    det = jnp.sum(p * e1, axis=-1)
    ok_det = jnp.abs(det) > 1e-12
    inv_det = jnp.where(ok_det, 1.0 / jnp.where(ok_det, det, 1.0), 0.0)
    s = o - v0
    u = jnp.sum(s * p, axis=-1) * inv_det
    q = jnp.cross(s, e1)
    v = jnp.sum(q * d, axis=-1) * inv_det
    t = jnp.sum(q * e2, axis=-1) * inv_det
    ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= t_min) & (t <= t_max))
    return jnp.where(ok, t, BIG)


def intersect_mesh(mesh: TriangleMesh, origins, directions, t_min,
                   t_max=BIG, max_leaf: int = 4, alive=None,
                   exclude=None) -> TriHit:
    """Closest triangle hit for N rays. Detached (stop_gradient) like the
    sphere search; callers re-derive differentiable quantities from tri_idx.

    exclude: optional [N] i32 per-ray triangle index masked out of the
    search (-1 = none) — the mesh-silhouette boundary term's background
    re-trace (diff/edge.py)."""
    o = jax.lax.stop_gradient(origins)
    d = jax.lax.stop_gradient(directions)
    mesh = jax.lax.stop_gradient(mesh)
    excl = None if exclude is None else jax.lax.stop_gradient(exclude)
    n = o.shape[0]
    m = mesh.bvh_escape.shape[0]

    # 1/d with the reference's inf semantics (RayTracer.h:231: IEEE inf is
    # correct for axis-parallel rays).
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-30, jnp.where(d < 0, -1e-30, 1e-30), d)

    # Derive carries from the (possibly mesh-axis-varying) ray inputs so the
    # while_loop carry types match under shard_map (jax >= 0.9 check).
    vary0 = (o[:, 0] * 0.0).astype(jnp.int32)
    ptr0 = vary0
    if alive is not None:
        ptr0 = jnp.where(jax.lax.stop_gradient(alive), ptr0, m)
    state = (
        ptr0,                                    # node pointer
        BIG + o[:, 0] * 0.0,                     # best t
        vary0,                                   # best tri
    )

    def cond(state):
        ptr, _, _ = state
        return jnp.any(ptr < m)

    def body(state):
        ptr, t_best, idx_best = state
        active = ptr < m
        p_safe = jnp.minimum(ptr, m - 1)
        bmin = mesh.bvh_min[p_safe]
        bmax = mesh.bvh_max[p_safe]
        esc = mesh.bvh_escape[p_safe]
        start = mesh.bvh_start[p_safe]
        count = mesh.bvh_count[p_safe]

        box_ok = active & _slab_test(bmin, bmax, o, inv_d, t_min,
                                     jnp.minimum(t_best, t_max))
        is_leaf = count > 0

        # Leaf: test up to max_leaf contiguous triangles (masked).
        do_leaf = box_ok & is_leaf
        tb, ib = t_best, idx_best
        for k in range(max_leaf):
            tri = jnp.minimum(start + k, mesh.num_triangles - 1)
            t_k = _tri_hit_one(mesh, tri, o, d, t_min,
                               jnp.minimum(tb, t_max))
            take = do_leaf & (k < count) & (t_k < tb)
            if excl is not None:
                take = take & (tri != excl)
            tb = jnp.where(take, t_k, tb)
            ib = jnp.where(take, tri, ib)

        # Advance: into subtree on inner-box hit, else escape.
        next_ptr = jnp.where(box_ok & ~is_leaf, ptr + 1, esc)
        next_ptr = jnp.where(active, next_ptr, ptr)
        return (next_ptr, tb, ib)

    ptr, t_best, idx_best = jax.lax.while_loop(cond, body, state)
    return TriHit(t=t_best, tri_idx=idx_best, hit=t_best < BIG)


def intersect_mesh_brute(mesh: TriangleMesh, origins, directions, t_min,
                         t_max=BIG) -> TriHit:
    """Reference brute force over all triangles (tests + small meshes)."""
    from .mesh import moller_trumbore
    ts = moller_trumbore(mesh.v0, mesh.e1, mesh.e2,
                         jax.lax.stop_gradient(origins),
                         jax.lax.stop_gradient(directions), t_min, t_max)
    idx = jnp.argmin(ts, axis=1).astype(jnp.int32)
    t = jnp.take_along_axis(ts, idx[:, None], axis=1)[:, 0]
    return TriHit(t=t, tri_idx=idx, hit=t < BIG)