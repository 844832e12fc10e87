"""Hand-written kernel vs plain XLA on the GPU, per call and end to end.

    python benchmarks/kernel_ab.py --percall   # search calls + block sweep
    python benchmarks/kernel_ab.py --e2e       # frame times, kernel vs xla

Per call: one 414,720-ray chunk (the wavefront size of a 1080p frame) of
primary and of bounce rays, for
  - the sphere search of the book-cover scene (484 spheres in 512 slots):
    kernels/sphere_search.py against the XLA [N, S] search in its two forms,
    elementwise products (core/intersect.py) and the K=3 HIGHEST matmul
    expansion;
  - the mesh search of the 100k-triangle terrain: kernels/bvh_search.py
    against accel/traverse.intersect_mesh.
Each kernel also runs over a small sweep of block shapes. End to end: the
headline frame (random, 1080p, 1 spp, depth 10) and the terrain frame
(1080p, 1 spp, depth 5) with intersector "pallas" and "xla".

Every line is one JSON object with the device as JAX reports it; the first
line is the card's name and power limit from nvidia-smi. Fails without a
GPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

CHUNK = 414720


def out(**kw):
    print(json.dumps(kw), flush=True)


def bench(fn, *args, iters=10):
    """Median seconds per call of a jitted fn (after a compile call)."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def sphere_hit_ts_matmul(scene, origins, directions, t_min, t_max,
                         exclude=None):
    """core/intersect.sphere_hit_ts with the two cross products as
    [N,3] @ [3,S] HIGHEST-precision matmuls (the XLA search's earlier
    form, the plain competitor's second form)."""
    from qt_raytracer.core import intersect
    from qt_raytracer.core import vecmath as vm

    o, d = origins, directions
    c, r = scene.center, scene.radius
    hi = jax.lax.Precision.HIGHEST
    a = vm.length_squared(d)[:, None]
    half_b = vm.dot(o, d)[:, None] - jnp.matmul(d, c.T, precision=hi)
    cterm = (vm.length_squared(o)[:, None]
             - 2.0 * jnp.matmul(o, c.T, precision=hi)
             + (vm.length_squared(c) - r * r)[None, :])
    disc = half_b * half_b - a * cterm
    sqrtd = vm.safe_sqrt(disc)
    root_near = (-half_b - sqrtd) / a
    root_far = (-half_b + sqrtd) / a
    in_range = lambda t: (t >= t_min) & (t <= t_max)
    near_ok = in_range(root_near)
    root = jnp.where(near_ok, root_near, root_far)
    valid = (disc >= 0.0) & (near_ok | in_range(root_far)) \
        & scene.active[None, :]
    if exclude is not None:
        valid = valid & (jnp.arange(c.shape[0])[None, :] != exclude[:, None])
    return jnp.where(valid, root, intersect.BIG)


def bounce_rays(o, d, t, normal, hit, key):
    """Diffuse bounce rays from the hit points of (o, d)."""
    k = jax.random.normal(key, o.shape)
    k = k / jnp.linalg.norm(k, axis=1, keepdims=True)
    nd = jnp.where(jnp.sum(k * normal, 1, keepdims=True) < 0, -k, k)
    p = o + jnp.where(hit, t, 0.0)[:, None] * d
    return p, nd


def percall():
    from qt_raytracer import RenderConfig
    from qt_raytracer.core import intersect
    from qt_raytracer.accel.traverse import intersect_mesh
    from qt_raytracer.kernels.bvh_search import bvh_search
    from qt_raytracer.kernels.sphere_search import sphere_search
    from qt_raytracer.models import meshes, scenes
    from chip_smoke import primary_rays

    cfg = RenderConfig(width=1920, height=1080)
    scene, cam = scenes.get_scene("random", cfg.aspect_ratio)
    o, d = primary_rays(cam, cfg)
    o, d = o[:CHUNK], d[:CHUNK]
    h = intersect.intersect_spheres(scene, o, d, 1e-3, backend="xla")
    bo, bd = bounce_rays(o, d, h.t, h.normal, h.hit, jax.random.PRNGKey(1))
    rays = {"primary": (o, d), "bounce": (bo, bd)}

    def search_xla(form):
        ts_fn = (sphere_hit_ts_matmul if form == "matmul"
                 else intersect.sphere_hit_ts)

        def f(sc, o, d):
            ts = ts_fn(sc, o, d, 1e-3, intersect.BIG)
            idx = jnp.argmin(ts, axis=1)
            return jnp.take_along_axis(ts, idx[:, None], axis=1)[:, 0], idx
        return jax.jit(f)

    for name, (ro, rd) in rays.items():
        ref = search_xla("matmul")(scene, ro, rd)
        for form in ("matmul", "elementwise"):
            out(kernel="sphere", rays=name, impl=f"xla_{form}",
                s_per_call=bench(search_xla(form), scene, ro, rd))
        for br, nw in ((64, 2), (128, 4), (256, 8)):
            f = jax.jit(lambda sc, o, d, br=br, nw=nw: sphere_search(
                sc, o, d, 1e-3, block_rays=br, num_warps=nw))
            t_k, i_k = f(scene, ro, rd)
            agree = float(jnp.mean((t_k < intersect.BIG)
                                   == (ref[0] < intersect.BIG)))
            out(kernel="sphere", rays=name, impl="pallas", block_rays=br,
                num_warps=nw, hit_agree=agree,
                s_per_call=bench(f, scene, ro, rd))

    world = meshes.terrain_world()
    tcam = meshes.terrain_camera(cfg.aspect_ratio)
    o, d = primary_rays(tcam, cfg)
    o, d = o[:CHUNK], d[:CHUNK]
    mesh = world.mesh
    xla = jax.jit(lambda m, o, d: intersect_mesh(m, o, d, 1e-3))
    th = xla(mesh, o, d)
    from qt_raytracer.core.world import face_param_table
    n = face_param_table(mesh)[th.tri_idx][:, 0:3]
    bo, bd = bounce_rays(o, d, th.t, n, th.hit, jax.random.PRNGKey(2))
    for name, (ro, rd) in {"primary": (o, d), "bounce": (bo, bd)}.items():
        ref = xla(mesh, ro, rd)
        out(kernel="bvh", rays=name, impl="xla_intersect_mesh",
            s_per_call=bench(xla, mesh, ro, rd, iters=3))
        for br, nw in ((32, 1), (64, 1), (64, 2), (128, 4)):
            f = jax.jit(lambda m, o, d, br=br, nw=nw: bvh_search(
                m, o, d, 1e-3, block_rays=br, num_warps=nw))
            t_k, i_k = f(mesh, ro, rd)
            agree = float(jnp.mean((t_k < intersect.BIG) == ref.hit))
            out(kernel="bvh", rays=name, impl="pallas", block_rays=br,
                num_warps=nw, hit_agree=agree,
                s_per_call=bench(f, mesh, ro, rd))


def e2e():
    import dataclasses

    from qt_raytracer import RenderConfig, render_linear
    from qt_raytracer.core import intersect
    from qt_raytracer.models import meshes, scenes

    key = jax.random.PRNGKey(0)
    cfg = RenderConfig(width=1920, height=1080, spp=1, max_depth=10,
                       rng="hash")
    scene, cam = scenes.get_scene("random", cfg.aspect_ratio)
    for impl in ("pallas", "xla", "pallas"):
        c = dataclasses.replace(cfg, intersector=impl)
        s = bench(render_linear, scene, cam, c, key, iters=3)
        out(cell="headline", impl=impl, s_per_frame=s,
            msamples_per_s=cfg.num_pixels / s / 1e6)
    # The matmul XLA form, swapped in for the whole frame.
    elementwise_form = intersect.sphere_hit_ts
    intersect.sphere_hit_ts = sphere_hit_ts_matmul
    jax.clear_caches()
    c = dataclasses.replace(cfg, intersector="xla")
    s = bench(render_linear, scene, cam, c, key, iters=3)
    out(cell="headline", impl="xla_matmul", s_per_frame=s,
        msamples_per_s=cfg.num_pixels / s / 1e6)
    intersect.sphere_hit_ts = elementwise_form
    jax.clear_caches()

    cfg = RenderConfig(width=1920, height=1080, spp=1, max_depth=5,
                       rng="hash")
    world = meshes.terrain_world()
    tcam = meshes.terrain_camera(cfg.aspect_ratio)
    for impl, iters in (("pallas", 3), ("xla", 1), ("pallas", 3)):
        c = dataclasses.replace(cfg, intersector=impl)
        s = bench(render_linear, world, tcam, c, key, iters=iters)
        out(cell="terrain", impl=impl, s_per_frame=s,
            msamples_per_s=cfg.num_pixels / s / 1e6)

    cfg = RenderConfig(width=512, height=512, spp=8, max_depth=10, nee=True,
                       rng="hash", samples_per_batch=4)
    world = meshes.cornell_box_world()
    wcam = meshes.cornell_box_mesh_camera(1.0)
    for impl in ("pallas", "xla", "pallas"):
        c = dataclasses.replace(cfg, intersector=impl)
        s = bench(render_linear, world, wcam, c, key, iters=3)
        out(cell="cornell_mesh_8spp", impl=impl, s_per_frame=s,
            msamples_per_s=cfg.num_pixels * cfg.spp / s / 1e6)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--percall", action="store_true")
    ap.add_argument("--e2e", action="store_true")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"kernel_ab: needs a GPU (JAX platform "
                         f"{dev.platform!r})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    out(card=smi.stdout.strip(), device_kind=dev.device_kind,
        jax=jax.__version__)
    from qt_raytracer.runtime.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    if args.percall:
        percall()
    if args.e2e:
        e2e()


if __name__ == "__main__":
    main()
