"""Closest-hit ray-sphere search as a Pallas kernel for the GPU (Triton route).

The plain XLA search (core/intersect.sphere_hit_ts) forms [N, S] candidate
arrays and reduces them with an argmin. This kernel gives each program a
block of rays, keeps the running (t, idx) of every ray in registers, and
walks the sphere table in index order, so device memory sees only the ray
block in and (t, idx) out. The sphere table is read as uniform scalars and
stays in cache.

Per (ray, sphere) pair the arithmetic is Sphere::hit's (RayTracer.h:289-305)
in the same expanded form as the XLA search: near root, else far root,
inside [t_min, t_max]. A strict ``<`` update over ascending indices keeps the
lowest index among equal-t candidates, which is jnp.argmin's tie-break.

Outputs are detached: the caller re-derives t and everything differentiable
from idx (core/intersect.intersect_spheres refinement).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BIG = np.float32(3.0e38)

# Chosen by measurement on the H100 (PERF.md, kernel table): rays per
# program and warps per program, one ray per thread. 64/2 was the fastest
# on bounce rays, which are 9 of the headline's 10 passes, in three runs.
BLOCK_RAYS = 64
NUM_WARPS = 2


def _search_kernel(ox, oy, oz, dx, dy, dz, alive, excl, cx, cy, cz, c2r2,
                   t_out, idx_out, *, t_min: float, t_max: float,
                   num_slots: int):
    o_x, o_y, o_z = ox[...], oy[...], oz[...]
    d_x, d_y, d_z = dx[...], dy[...], dz[...]
    live = alive[...] != 0
    ex = excl[...] if excl is not None else None

    a = d_x * d_x + d_y * d_y + d_z * d_z
    o_dot_d = o_x * d_x + o_y * d_y + o_z * d_z
    o2 = o_x * o_x + o_y * o_y + o_z * o_z
    inv_a = 1.0 / a
    t_none = jnp.full(o_x.shape, BIG, jnp.float32)
    i_none = jnp.zeros(o_x.shape, jnp.int32)

    def body(s, carry):
        tb, ib = carry
        # Summed in core/intersect.sphere_hit_ts's order.
        half_b = o_dot_d - ((cy[s] * d_y + cx[s] * d_x) + cz[s] * d_z)
        cterm = o2 - 2.0 * ((cy[s] * o_y + cx[s] * o_x) + cz[s] * o_z) \
            + c2r2[s]
        disc = half_b * half_b - a * cterm
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        near = (-half_b - sq) * inv_a
        far = (-half_b + sq) * inv_a
        near_ok = (near >= t_min) & (near <= t_max)
        far_ok = (far >= t_min) & (far <= t_max)
        valid = (disc >= 0.0) & (near_ok | far_ok)
        if ex is not None:
            valid = valid & (ex != s)
        t = jnp.where(valid, jnp.where(near_ok, near, far), BIG)
        better = t < tb
        return jnp.where(better, t, tb), jnp.where(better, s, ib)

    def search():
        return jax.lax.fori_loop(0, num_slots, body, (t_none, i_none))

    # A program whose rays are all dead skips the sweep.
    any_live = jnp.max(live.astype(jnp.int32)) > 0
    tb, ib = jax.lax.cond(any_live, search, lambda: (t_none, i_none))
    t_out[...] = jnp.where(live, tb, BIG)
    idx_out[...] = jnp.where(live, ib, 0)


def _pad(x, n, value):
    return jnp.pad(x, (0, n - x.shape[0]), constant_values=value)


def _varying_axes(*xs):
    """Mesh axes any of xs varies over (empty outside shard_map)."""
    return frozenset().union(*(jax.typeof(x).vma for x in xs))


@functools.partial(jax.jit, static_argnames=(
    "t_min", "t_max", "interpret", "block_rays", "num_warps"))
def sphere_search(scene, origins, directions, t_min: float,
                  t_max: float = float(BIG), alive=None, exclude=None,
                  interpret: bool = False, block_rays: int = BLOCK_RAYS,
                  num_warps: int = NUM_WARPS):
    """Closest sphere per ray: (t [N] f32, BIG on a miss; idx [N] i32, 0 on
    a miss).

    alive: optional [N] bool; dead rays return a miss, and a program whose
    rays are all dead skips the search.
    exclude: optional [N] i32 sphere index masked out per ray (-1 = none),
    the edge-aware background re-trace (diff/edge.py).
    block_rays/num_warps: measurement parameters; callers use the
    defaults.
    """
    origins = jax.lax.stop_gradient(origins)
    directions = jax.lax.stop_gradient(directions)
    scene = jax.lax.stop_gradient(scene)

    n = origins.shape[0]
    n_pad = max(-(-n // block_rays) * block_rays, block_rays)

    rays = [_pad(origins[:, i], n_pad, 0.0) for i in range(3)]
    # Padding lanes get a unit direction so 1/a stays finite; they are dead.
    rays += [_pad(directions[:, i], n_pad, 1.0) for i in range(3)]
    live = (jnp.ones((n,), jnp.int32) if alive is None
            else jax.lax.stop_gradient(alive).astype(jnp.int32))
    rays.append(_pad(live, n_pad, 0))
    if exclude is not None:
        rays.append(_pad(jax.lax.stop_gradient(exclude).astype(jnp.int32),
                         n_pad, -1))

    # Inactive slots get cterm = +inf: disc < 0, never a hit.
    c = scene.center
    c2r2 = jnp.where(scene.active,
                     jnp.sum(c * c, axis=-1) - scene.radius * scene.radius,
                     jnp.inf)
    spheres = [c[:, 0], c[:, 1], c[:, 2], c2r2]
    s = c.shape[0]

    kernel = functools.partial(_search_kernel, t_min=float(t_min),
                               t_max=float(t_max), num_slots=s)
    if exclude is None:
        body = kernel

        def kernel(*refs):
            return body(*refs[:7], None, *refs[7:])

    # Under shard_map the outputs vary over the mesh axes the rays vary over.
    vma = _varying_axes(*rays, *spheres)
    ray_spec = pl.BlockSpec((block_rays,), lambda i: (i,))
    table_spec = pl.BlockSpec((s,), lambda i: (0,))
    t, idx = pl.pallas_call(
        kernel,
        grid=(n_pad // block_rays,),
        in_specs=[ray_spec] * len(rays) + [table_spec] * 4,
        out_specs=(ray_spec, ray_spec),
        out_shape=(jax.ShapeDtypeStruct((n_pad,), jnp.float32, vma=vma),
                   jax.ShapeDtypeStruct((n_pad,), jnp.int32, vma=vma)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="sphere_search",
    )(*rays, *spheres)
    return (jax.lax.stop_gradient(t[:n]), jax.lax.stop_gradient(idx[:n]))
