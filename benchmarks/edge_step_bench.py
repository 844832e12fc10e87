"""Edge-aware vs plain inverse-rendering step time:
one process, 512x512 spp 4 depth 4, intersector auto (the kernels on a
GPU) — plain pathwise step vs edge-aware (3-trace boundary estimator) vs
edge-aware forced onto the xla intersector; "mesh"/"mesh_edge" run the
pose step on the true Cornell box.

    python benchmarks/edge_step_bench.py [--side 512] [--modes ...]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=512)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--modes", nargs="*",
                    default=["plain", "edge", "edge_xla"])
    args = ap.parse_args()

    import dataclasses as dc

    import jax
    import jax.numpy as jnp
    import optax

    from qt_raytracer import RenderConfig
    from qt_raytracer.diff.inverse import make_train_step, mean_image
    from qt_raytracer.models import scenes

    dev = jax.devices()[0]
    print(f"# device={dev.platform}:{dev.device_kind}", flush=True)

    base = RenderConfig(width=args.side, height=args.side, spp=4,
                        max_depth=4, samples_per_batch=1)
    scene, cam = scenes.get_scene("three_sphere", base.aspect_ratio)
    key = jax.random.PRNGKey(0)
    target = mean_image(scene, cam, base, key)
    wrong = dc.replace(scene,
                       albedo=scene.albedo.at[0].set(
                           jnp.array([0.3, 0.5, 0.7])))

    mesh_world = mesh_cam = mesh_target = None

    for mode in args.modes:
        cfg = base
        if mode == "edge_xla":
            cfg = dc.replace(base, intersector="xla")
        edge = mode.startswith("edge") or mode.startswith("mesh_edge")
        if mode.startswith("mesh"):
            # TRUE Cornell box (config-2 geometry): pose recovery with the
            # kernel-backed mesh edge path (per-lane triangle exclusion).
            from qt_raytracer.models import meshes

            if mesh_world is None:
                mesh_world = meshes.cornell_box_world()
                mesh_cam = meshes.cornell_box_mesh_camera(base.aspect_ratio)
                mcfg = dc.replace(base, nee=True)
                mesh_target = mean_image(mesh_world, mesh_cam, mcfg, key)
            init_state, step_fn, _, _ = make_train_step(
                mesh_world, mesh_cam, dc.replace(base, nee=True),
                optax.adam(2e-2), trainable=(), train_camera="pose",
                edge_aware=edge)
            target_use = mesh_target
        else:
            init_state, step_fn, _, _ = make_train_step(
                wrong, cam, cfg, optax.adam(2e-2), trainable=("albedo",),
                train_camera="pose", edge_aware=edge)
            target_use = target
        state = init_state()
        t0 = time.perf_counter()
        try:
            state, loss = step_fn(state, target_use, key)
        except Exception as e:  # noqa: BLE001 — report OOM/compile fails
            msg = str(e).splitlines()[0][:120]
            print(f"{mode:10s}: FAILED ({msg})", flush=True)
            continue
        jax.block_until_ready(state.params)
        first = time.perf_counter() - t0
        ts = []
        for it in range(args.iters):
            t0 = time.perf_counter()
            state, loss = step_fn(state, target_use,
                                  jax.random.fold_in(key, it))
            jax.block_until_ready(state.params)
            ts.append(time.perf_counter() - t0)
        print(f"{mode:10s}: first={first:.1f}s best={min(ts)*1e3:.0f}ms "
              f"loss={float(loss):.5f}", flush=True)


if __name__ == "__main__":
    main()
