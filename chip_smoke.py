"""Smoke test of the whole main path on one GPU (or four, with --multi).

    python chip_smoke.py           # one card: device, headline, mesh, train
    python chip_smoke.py --multi   # four cards: the sharded path only

Every phase runs through the public entry points (render_linear,
make_multiview_train_step[_perview], render_linear_sharded) with the
compiled Pallas kernels, compares each kernel with its plain XLA reference at
full width, checks images against the float64 oracles, and prints its first
call time (compile + one run), its steady time and the device's peak memory.
Any failed check raises, so the script exits non-zero; the last line of a
passing run is one JSON object naming the device as JAX reports it.

Exits 1 without a result when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

BIG = np.float32(3.0e38)
# Per-channel oracle criterion of benchmarks/run_baselines.py: a pixel
# mismatches when |got - want| / (|want| + 1) > 2e-3 in any channel.
ORACLE_TOL = 2e-3
ORACLE_MAX_MISMATCH = 0.04


def log(msg: str) -> None:
    print(msg, flush=True)


def peak_bytes() -> int:
    return int(jax.devices()[0].memory_stats().get("peak_bytes_in_use", 0))


def timed(fn, *args, steady_iters: int = 1):
    """(result, first_call_s, steady_s): first call compiles and runs."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    if not steady_iters:
        return out, first, first
    t0 = time.perf_counter()
    for _ in range(steady_iters):
        out = jax.block_until_ready(fn(*args))
    return out, first, (time.perf_counter() - t0) / steady_iters


def report(phase: str, what: str, first: float, steady: float, **extra):
    log(json.dumps({"phase": phase, "what": what,
                    "first_call_s": round(first, 3),
                    "steady_s": round(steady, 4),
                    "peak_bytes_in_use": peak_bytes(), **extra}))


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)
    log(f"  ok: {msg}")


def oracle_mismatch(got, want) -> float:
    per = (np.abs(got - want) / (np.abs(want) + 1.0)).max(axis=-1)
    return float((per > ORACLE_TOL).mean())


def primary_rays(cam, cfg):
    """Pixel-centre primary rays of a cfg-sized image (lens sample fixed)."""
    from qt_raytracer.core import camera as cam_mod
    from qt_raytracer.core.render import pixel_grid

    i, j, _ = pixel_grid(cfg)
    half = jnp.full_like(i, 0.5)
    return cam_mod.get_rays(cam, (i + 0.5) / max(cfg.width - 1, 1),
                            (j + 0.5) / max(cfg.height - 1, 1), half, half)


# ------------------------------------------------------------------ phases
def phase_device() -> dict:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        sys.exit(1)
    from qt_raytracer.runtime.compile_cache import enable_compilation_cache

    cache = enable_compilation_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip())         # name, power limit
    log(f"[device] jax {jax.__version__}, {len(jax.devices())} x "
        f"{dev.device_kind}, compile cache {cache}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def sphere_t_f64(scene, o, d, idx):
    """Sphere::hit t (RayTracer.h:289-305) of sphere idx per ray, in float64
    on the host (the near root if it is past t_min, else the far root)."""
    c = np.asarray(scene.center, np.float64)[idx]
    r = np.asarray(scene.radius, np.float64)[idx]
    oc = o - c
    a = np.sum(d * d, 1)
    hb = np.sum(oc * d, 1)
    sq = np.sqrt(np.maximum(hb * hb - a * (np.sum(oc * oc, 1) - r * r), 0.0))
    near = (-hb - sq) / a
    return np.where(near >= 1e-3, near, (-hb + sq) / a)


def tri_t_f64(mesh, o, d, idx):
    """Möller-Trumbore t of triangle idx per ray, in float64 on the host."""
    v0, e1, e2 = (np.asarray(x, np.float64)[idx]
                  for x in (mesh.v0, mesh.e1, mesh.e2))
    p = np.cross(d, e2)
    q = np.cross(o - v0, e1)
    return np.sum(q * e2, 1) / np.sum(p * e1, 1)


def compare_winners(what, hit_k, i_k, t_k, hit_x, i_x, t_x, o, d, t_f64):
    """Kernel (hit, winner, t) against the XLA search's, as numpy arrays.

    Hit/miss agrees on >= 99.9% of rays. Where both hit, the winner is the
    same apart from ties, and t agrees to rtol 1e-5 where it is the same. A
    tie is a ray whose two winners t_f64(o, d, idx) hits at the same float64
    distance to rtol 1e-5: two surfaces that meet, where the order of the
    float32 arithmetic (the kernel's fused multiply-adds) decides."""
    frac = float((hit_k == hit_x).mean())
    both = hit_k & hit_x
    rows = np.nonzero(both & (i_k != i_x))[0]
    gap = 0.0
    if rows.size:
        ro = np.asarray(o, np.float64)[rows]
        rd = np.asarray(d, np.float64)[rows]
        t1, t2 = t_f64(ro, rd, i_k[rows]), t_f64(ro, rd, i_x[rows])
        gap = float(np.max(np.abs(t1 - t2) / np.minimum(t1, t2)))
    same = both.copy()
    same[rows] = False
    t_rel = float(np.max(np.abs(t_k[same] - t_x[same]) / np.abs(t_x[same])))
    check(frac >= 0.999, f"{what}: hit/miss agrees on {frac:.6f} of "
          f"{hit_k.size} rays (>= 0.999)")
    check(t_rel <= 1e-5, f"{what}: t agrees where the winners agree "
          f"({int(same.sum())} rays): max rel diff {t_rel:.3g} (<= 1e-5)")
    check(gap <= 1e-5, f"{what}: winners differ on {rows.size} of "
          f"{int(both.sum())} shared hits, all ties: max float64 t gap "
          f"{gap:.3g} (<= 1e-5 relative)")


def compare_sphere_search(scene, o, d):
    """Sphere kernel vs the XLA search through intersect_spheres (refined
    t), chunked like a render so the XLA [N, S] candidates stay bounded."""
    from qt_raytracer.core.intersect import intersect_spheres

    search = {b: jax.jit(lambda sc, o, d, b=b: intersect_spheres(
        sc, o, d, 1e-3, backend=b)) for b in ("pallas", "xla")}
    chunk = 414720
    res = {b: [search[b](scene, o[s:s + chunk], d[s:s + chunk])
               for s in range(0, o.shape[0], chunk)] for b in search}
    cat = {b: [np.concatenate([np.asarray(getattr(h, f)) for h in hs])
               for f in ("hit", "prim_idx", "t")] for b, hs in res.items()}
    compare_winners("sphere kernel vs XLA search", *cat["pallas"],
                    *cat["xla"], o, d,
                    lambda o, d, i: sphere_t_f64(scene, o, d, i))


def oracle_full(what, world, cam, cfg, key):
    """Full-size float64 oracle check of one render (testing/oracle_vec)."""
    from qt_raytracer import render_linear
    from qt_raytracer.testing.oracle_vec import render_oracle_vec

    got = np.asarray(render_linear(world, cam, cfg, key), np.float64)
    t0 = time.perf_counter()
    want = render_oracle_vec(world, cam, cfg, key)
    mism = oracle_mismatch(got, want)
    check(mism < ORACLE_MAX_MISMATCH, f"{what} vs f64 oracle at full size "
          f"(oracle {time.perf_counter() - t0:.1f} s on the host): mismatch "
          f"fraction {mism:.5f} (< {ORACLE_MAX_MISMATCH})")


def phase_headline():
    from qt_raytracer import RenderConfig, render_linear
    from qt_raytracer.models import scenes
    from qt_raytracer.testing import oracle

    cfg = RenderConfig(width=1920, height=1080, spp=1, max_depth=10,
                       rng="hash")
    scene, cam = scenes.get_scene("random", cfg.aspect_ratio)
    key = jax.random.PRNGKey(0)
    img, first, steady = timed(render_linear, scene, cam, cfg, key,
                               steady_iters=3)
    report("headline", "render_linear random 1920x1080 1spp d10 (kernel)",
           first, steady,
           msamples_per_s=round(cfg.num_pixels * cfg.spp / steady / 1e6, 3))
    img = np.asarray(img)
    shape = (cfg.height, cfg.width, 3)
    check(img.shape == shape and bool(np.isfinite(img).all()),
          f"headline image finite, shape {shape}")

    cfg_x = dataclasses.replace(cfg, intersector="xla")
    img_x, first, steady = timed(render_linear, scene, cam, cfg_x, key)
    report("headline", "render_linear random 1920x1080 1spp d10 (xla)",
           first, steady,
           msamples_per_s=round(cfg.num_pixels * cfg.spp / steady / 1e6, 3))
    mism = oracle_mismatch(img, np.asarray(img_x))
    check(mism < ORACLE_MAX_MISMATCH, f"kernel image vs xla image at full "
          f"size: mismatch fraction {mism:.5f} (< {ORACLE_MAX_MISMATCH})")

    o, d = primary_rays(cam, cfg)
    compare_sphere_search(scene, o, d)

    vcfg = RenderConfig(width=16, height=16, spp=2, max_depth=4, rng="hash")
    got = np.asarray(render_linear(scene, cam, vcfg, key), np.float64) / 2
    want = oracle.render_oracle_linear(scene, cam, vcfg, key) / 2
    per = (np.abs(got - want) / (np.abs(want) + 1.0)).max(axis=-1)
    flips = int((per > ORACLE_TOL).sum())
    check(flips <= 2, f"16x16 2spp crop vs scalar f64 oracle: {flips} "
          "boundary flips of 256 (<= 2)")

    # BASELINE config 1 (benchmarks/run_baselines.config1 --oracle-full).
    cfg1 = RenderConfig(width=256, height=256, spp=8, max_depth=10,
                        rng="hash")
    scene1, cam1 = scenes.get_scene("three_sphere", 1.0)
    oracle_full("config 1 three_sphere 256x256 8spp d10", scene1, cam1, cfg1,
                key)


def phase_mesh():
    from qt_raytracer import RenderConfig, render_linear
    from qt_raytracer.accel.traverse import (intersect_mesh,
                                             intersect_mesh_brute)
    from qt_raytracer.kernels.bvh_search import bvh_search
    from qt_raytracer.models import meshes

    key = jax.random.PRNGKey(0)
    cfg = RenderConfig(width=1920, height=1080, spp=1, max_depth=5,
                       rng="hash")
    t0 = time.perf_counter()
    world = meshes.terrain_world()
    log(f"[mesh] terrain build: {world.mesh.num_triangles} triangles, "
        f"{time.perf_counter() - t0:.2f} s")
    cam = meshes.terrain_camera(cfg.aspect_ratio)
    img, first, steady = timed(render_linear, world, cam, cfg, key,
                               steady_iters=3)
    report("mesh", "render_linear terrain 1920x1080 1spp d5 (kernel)",
           first, steady,
           msamples_per_s=round(cfg.num_pixels / steady / 1e6, 3))
    check(bool(np.isfinite(np.asarray(img)).all()), "terrain image finite")

    def compare_mesh(what, mesh, o, d, t_k, i_k, ref):
        t_k = np.asarray(t_k)
        compare_winners(what, t_k < BIG, np.asarray(i_k), t_k,
                        np.asarray(ref.hit), np.asarray(ref.tri_idx),
                        np.asarray(ref.t), o, d,
                        lambda o, d, i: tri_t_f64(mesh, o, d, i))

    o, d = primary_rays(cam, cfg)
    (t_k, i_k), first, steady = timed(
        jax.jit(lambda m, o, d: bvh_search(m, o, d, 1e-3)), world.mesh, o, d)
    report("mesh", "bvh_search terrain primary rays (kernel)", first, steady)
    ref, first, steady = timed(
        jax.jit(lambda m, o, d: intersect_mesh(m, o, d, 1e-3)),
        world.mesh, o, d)
    report("mesh", "intersect_mesh terrain primary rays (xla)", first,
           steady)
    compare_mesh("terrain: BVH kernel vs intersect_mesh", world.mesh, o, d,
                 t_k, i_k, ref)

    # True Cornell box: NEE + MIS over triangle lights, 512^2 4 spp.
    cfg = RenderConfig(width=512, height=512, spp=4, max_depth=10, nee=True,
                       rng="hash")
    world = meshes.cornell_box_world()
    cam = meshes.cornell_box_mesh_camera(1.0)
    img, first, steady = timed(render_linear, world, cam, cfg, key,
                               steady_iters=2)
    report("mesh", "render_linear cornell_mesh 512x512 4spp d10 nee "
           "(kernel)", first, steady,
           msamples_per_s=round(cfg.num_pixels * cfg.spp / steady / 1e6, 3))
    check(bool(np.isfinite(np.asarray(img)).all()), "cornell image finite")

    o, d = primary_rays(cam, cfg)
    t_k, i_k = bvh_search(world.mesh, o, d, 1e-3)
    ref = intersect_mesh_brute(world.mesh, o, d, 1e-3)
    compare_mesh("cornell_mesh: BVH kernel vs brute force", world.mesh, o, d,
                 t_k, i_k, ref)

    # BASELINE config 2 (benchmarks/run_baselines.config2 --oracle-full).
    oracle_full("config 2 cornell_mesh 512x512 4spp d10 nee", world, cam,
                cfg, key)


def _sphere_training(views: int, width: int, height: int, mesh=None):
    """Config-5 sphere line (benchmarks/run_baselines.config5 at spec):
    returns (init_state, step_fn, targets)."""
    import optax

    from qt_raytracer import RenderConfig
    from qt_raytracer.diff.inverse import mean_image
    from qt_raytracer.diff.multiview import (make_multiview_train_step,
                                             orbit_cameras, translate_camera)
    from qt_raytracer.models import scenes

    cfg = RenderConfig(width=width, height=height, spp=2, max_depth=4,
                       rng="hash", nee=True, edge_aware=True)
    true_scene = scenes.cornell_box_spheres()
    base = scenes.cornell_box_camera(cfg.aspect_ratio)
    cams = orbit_cameras(base, [(0.0, 0.0, 0.0), (0.5, 0.0, 0.0),
                                (-0.5, 0.1, 0.0), (0.0, 0.3, -0.3)][:views])
    tcfg = dataclasses.replace(cfg, edge_aware=False)
    k0 = jax.random.PRNGKey(7)
    targets = jnp.stack([mean_image(true_scene, c, tcfg,
                                    jax.random.fold_in(k0, v))
                         for v, c in enumerate(cams)])
    wrong = dataclasses.replace(
        true_scene,
        albedo=true_scene.albedo.at[6].set(jnp.array([0.2, 0.6, 0.8])),
        emission=true_scene.emission.at[5].set(jnp.array([8.0, 8.0, 8.0])))
    start = tuple(translate_camera(c, jnp.array([0.1, -0.07, 0.08]))
                  for c in cams)
    opt = optax.multi_transform(
        {"scene": optax.adam(0.03), "emission": optax.adam(0.6),
         "camera": optax.adam(2.5e-2)},
        {"scene": {"albedo": "scene", "emission": "emission"},
         "camera": {"translate": "camera"}})
    init_state, step_fn, _, _ = make_multiview_train_step(
        wrong, start, cfg, opt, trainable=("albedo", "emission"),
        train_camera="pose", mesh=mesh, edge_aware=True)
    return init_state, step_fn, targets


def _finite_state(state, loss, what: str) -> None:
    # The first adam moment is (1 - b1) * grad after a step, so finite
    # moments mean finite gradient leaves.
    leaves = jax.tree.leaves(state)
    ok = bool(np.isfinite(float(loss))) and all(
        bool(np.isfinite(np.asarray(x)).all()) for x in leaves)
    check(ok, f"{what}: loss {float(loss):.6f} and all {len(leaves)} state "
          "leaves (params, gradient moments) finite")


def phase_train():
    import optax

    from qt_raytracer import RenderConfig
    from qt_raytracer.diff.inverse import mean_image
    from qt_raytracer.diff.multiview import (make_multiview_train_step_perview,
                                             orbit_cameras, translate_camera)
    from qt_raytracer.models import meshes

    key = jax.random.PRNGKey(7)
    init_state, step_fn, targets = _sphere_training(4, 1920, 1080)
    state = init_state()
    t0 = time.perf_counter()
    state, loss = jax.block_until_ready(step_fn(state, targets, key))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(2):
        state, loss = step_fn(state, targets, key)
    jax.block_until_ready(state)
    steady = (time.perf_counter() - t0) / 2
    report("train", "config-5 sphere line: 4 views 1920x1080 spp2 d4 nee "
           "edge-aware, 3 steps", first, steady, s_per_step=round(steady, 3))
    _finite_state(state, loss, "sphere line")

    cfg = RenderConfig(width=1920, height=1080, spp=2, max_depth=4,
                       rng="hash", nee=True, edge_aware=True)
    world = meshes.cornell_box_world()
    base = meshes.cornell_box_mesh_camera(cfg.aspect_ratio)
    cams = orbit_cameras(base, [(0.0, 0.0, 0.0), (0.4, 0.15, 0.0)])
    tcfg = dataclasses.replace(cfg, edge_aware=False)
    k11 = jax.random.PRNGKey(11)
    targets = jnp.stack([mean_image(world, c, tcfg, jax.random.fold_in(k11, v))
                         for v, c in enumerate(cams)])
    start = tuple(translate_camera(c, jnp.array([0.1, -0.07, 0.05]))
                  for c in cams)
    init_state, step_fn, _, _ = make_multiview_train_step_perview(
        world, start, cfg, optax.adam(2.5e-2), trainable=(),
        train_camera="pose", edge_aware=True)
    state = init_state()
    t0 = time.perf_counter()
    state, loss = jax.block_until_ready(step_fn(state, targets, k11))
    first = time.perf_counter() - t0
    report("train", "config-5 mesh-world line: 2 views 1920x1080 spp2 d4 "
           "nee edge-aware, per-view calls, 1 step (first call includes "
           "compile)", first, first, s_per_step=round(first, 3))
    _finite_state(state, loss, "mesh-world line")


def phase_multi():
    """The sharded path on four cards, each against its one-card run."""
    from qt_raytracer import RenderConfig, render_linear
    from qt_raytracer.models import meshes, scenes
    from qt_raytracer.parallel.sharding import make_mesh, render_linear_sharded

    devs = jax.devices()
    check(len(devs) == 4, f"four devices visible ({len(devs)})")
    key = jax.random.PRNGKey(0)

    cfg = RenderConfig(width=1920, height=1080, spp=1, max_depth=10,
                       rng="hash")
    scene, cam = scenes.get_scene("random", cfg.aspect_ratio)
    one, first, steady1 = timed(render_linear, scene, cam, cfg, key,
                                steady_iters=3)
    report("multi", "render_linear headline, 1 card", first, steady1)
    mesh = make_mesh(sp=1, px=4)
    four, first, steady4 = timed(render_linear_sharded, scene, cam, cfg, key,
                                 mesh, steady_iters=3)
    report("multi", "render_linear_sharded headline, (sp=1, px=4)", first,
           steady4, scaling_efficiency=round(steady1 / (4 * steady4), 4))
    a, b = np.asarray(one), np.asarray(four)
    if not np.array_equal(a, b):
        ulps = np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64))
        at = np.unravel_index(int(np.argmax(ulps)), ulps.shape)
        raise AssertionError(f"px-sharded headline is not bitwise equal: "
                             f"max {int(ulps.max())} ulps at {at}")
    log("  ok: px-sharded headline frame bitwise equal to the 1-card frame")

    cfg = RenderConfig(width=512, height=512, spp=8, max_depth=10, nee=True,
                       rng="hash")
    world = meshes.cornell_box_world()
    wcam = meshes.cornell_box_mesh_camera(1.0)
    one, first, steady1 = timed(render_linear, world, wcam, cfg, key)
    report("multi", "render_linear cornell_mesh 512x512 8spp, 1 card",
           first, steady1)
    mesh = make_mesh(sp=2, px=2)
    four, first, steady4 = timed(render_linear_sharded, world, wcam, cfg,
                                 key, mesh)
    report("multi", "render_linear_sharded cornell_mesh, (sp=2, px=2)",
           first, steady4, scaling_efficiency=round(steady1 / (4 * steady4),
                                                    4))
    a, b = np.asarray(one), np.asarray(four)
    ulps = np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))
    check(int(ulps.max()) <= 8, f"sp-sharded Cornell within a few f32 ulps "
          f"of the 1-card image (max {int(ulps.max())} ulps)")

    k7 = jax.random.PRNGKey(7)
    init1, step1, targets = _sphere_training(4, 1920, 1080)
    (s1, l1), first, _ = timed(step1, init1(), targets, k7, steady_iters=0)
    report("multi", "config-5 sphere step, 1 card", first, first)
    init4, step4, _ = _sphere_training(4, 1920, 1080,
                                       mesh=make_mesh(sp=1, px=4))
    (s4, l4), first, _ = timed(step4, init4(), targets, k7, steady_iters=0)
    report("multi", "config-5 sphere step, (sp=1, px=4)", first, first)
    check(bool(np.isclose(float(l1), float(l4), rtol=1e-5, atol=0)),
          f"sharded loss {float(l4):.8f} vs 1-card {float(l1):.8f} "
          "(rtol 1e-5)")
    # First adam moments are 0.1 * grad: compare gradients through them.
    worst = 0.0
    for g1, g4 in zip(jax.tree.leaves(s1.opt_state),
                      jax.tree.leaves(s4.opt_state)):
        g1, g4 = np.asarray(g1, np.float64), np.asarray(g4, np.float64)
        scale = max(float(np.abs(g1).max()), 1e-30)
        worst = max(worst, float(np.abs(g1 - g4).max()) / scale)
    check(worst <= 1e-4, f"sharded gradients within rtol 1e-4 of the "
          f"1-card gradients (max diff / leaf scale {worst:.3g})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: run only the sharded path")
    args = ap.parse_args()

    device = phase_device()
    phases = [phase_multi] if args.multi else [phase_headline, phase_mesh,
                                                phase_train]
    for phase in phases:
        t0 = time.perf_counter()
        log(f"[{phase.__name__}] start")
        phase()
        log(f"[{phase.__name__}] passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
