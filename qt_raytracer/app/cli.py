"""Command-line interface: render / bench / invert.

Replaces the reference's app shell + QML control panel (src/app/main.cpp,
resources/qml/Main.qml): the CLI flags map 1:1 to the panel's controls
(width/height/samples/depth/scene/backend, AA presets Main.qml:91-102), the
``--backend`` flag plays the role of ``--graphics-api``: ``auto`` runs on
JAX's default platform, ``gpu`` insists on a GPU and fails with a message
when there is none (the reference's "X unavailable" report,
RayTracerFboItem.cpp:261-281), ``cpu`` pins the host. No command moves to
the CPU unless asked.

Usage:
    python -m qt_raytracer.app.cli render --scene random --width 400 \
        --height 225 --spp 24 --out out.png
    python -m qt_raytracer.app.cli render --progressive --checkpoint ck \
        --scene cornell --nee ...
    python -m qt_raytracer.app.cli bench --scene random
    python -m qt_raytracer.app.cli invert --steps 60
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..core.config import AA_PRESETS, RenderConfig
from .stats import RenderStats, Timer


def _select_backend(requested: str) -> str:
    """Apply --backend before any computation and return the platform the
    command runs on, as JAX reports it."""
    import jax

    if requested == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif requested == "gpu":
        try:
            jax.devices("gpu")
        except RuntimeError as e:
            raise SystemExit(f"--backend gpu: no GPU is visible to JAX ({e})")
    return jax.default_backend()


def _build_cfg(args) -> RenderConfig:
    spp = AA_PRESETS[args.aa] if args.aa else args.spp
    return RenderConfig(
        width=args.width, height=args.height, spp=spp,
        max_depth=args.depth, nee=args.nee, quantizer=args.quantizer,
        samples_per_batch=args.samples_per_batch,
        pixel_chunk=args.pixel_chunk,
    )


def _get_scene(args, cfg):
    from ..models import scenes

    return scenes.get_scene(args.scene, cfg.aspect_ratio)


def cmd_render(args) -> int:
    import jax

    backend = _select_backend(args.backend)

    cfg = _build_cfg(args)
    scene, camera = _get_scene(args, cfg)
    key_seed = args.seed

    timer = Timer()
    if args.progressive:
        from .progressive import ProgressiveRenderer

        pr = ProgressiveRenderer(scene, camera, cfg, seed=key_seed)
        if args.resume and args.checkpoint:
            pr.load(args.checkpoint)
            print(f"resumed at {pr.frame_index} spp", file=sys.stderr)
        frames = 0
        try:
            while pr.frame_index < cfg.spp:
                todo = min(args.batch, cfg.spp - pr.frame_index)
                pr.step(todo)
                frames += 1
                print(f"progress {pr.progress:5.1f}% "
                      f"({pr.frame_index}/{cfg.spp} spp)", file=sys.stderr)
                if args.checkpoint:
                    pr.save(args.checkpoint)
        except KeyboardInterrupt:
            # stopRender analog (RayTracerFboItem.cpp:334-348): stop cleanly,
            # keep the partial accumulation; --resume continues it.
            if args.checkpoint:
                pr.save(args.checkpoint)
                print(f"\ninterrupted at {pr.frame_index}/{cfg.spp} spp; "
                      f"checkpoint saved to {args.checkpoint} (resume with "
                      f"--resume)", file=sys.stderr)
            else:
                print(f"\ninterrupted at {pr.frame_index}/{cfg.spp} spp",
                      file=sys.stderr)
        img = pr.image()
        stats = RenderStats(cfg.width, cfg.height, pr.frame_index,
                            cfg.max_depth, timer.elapsed_s, frames=frames,
                            backend=backend)
    else:
        from ..core.render import render
        img = np.asarray(render(scene, camera, cfg,
                                jax.random.PRNGKey(key_seed)))
        stats = RenderStats(cfg.width, cfg.height, cfg.spp, cfg.max_depth,
                            timer.elapsed_s, backend=backend)

    if args.out:
        from PIL import Image

        Image.fromarray(img).save(args.out)
        print(f"wrote {args.out}", file=sys.stderr)
    print(stats.text())
    return 0


def cmd_preview(args) -> int:
    _select_backend(args.backend)
    cfg = _build_cfg(args)
    scene, camera = _get_scene(args, cfg)
    from .preview import run_preview

    run_preview(scene, camera, cfg, seed=args.seed, batch=args.batch,
                out_path=args.out, ansi=args.ansi, ansi_cols=args.ansi_cols)
    return 0


def cmd_interactive(args) -> int:
    _select_backend(args.backend)
    cfg = _build_cfg(args)
    scene, camera = _get_scene(args, cfg)
    from .interactive import run_interactive

    return run_interactive(scene, camera, cfg, seed=args.seed,
                           batch=args.batch, ansi_cols=args.ansi_cols)


def cmd_bench(args) -> int:
    import jax

    backend = _select_backend(args.backend)
    cfg = _build_cfg(args)
    scene, camera = _get_scene(args, cfg)
    from ..core.render import render_linear

    key = jax.random.PRNGKey(args.seed)
    out = render_linear(scene, camera, cfg, key)
    jax.block_until_ready(out)       # compile + warmup
    timer = Timer()
    for it in range(args.iters):
        out = render_linear(scene, camera, cfg, jax.random.fold_in(key, it))
    jax.block_until_ready(out)
    stats = RenderStats(cfg.width, cfg.height, cfg.spp, cfg.max_depth,
                        timer.elapsed_s / args.iters, backend=backend)
    print(json.dumps({
        "scene": args.scene, "width": cfg.width, "height": cfg.height,
        "spp": cfg.spp, "depth": cfg.max_depth, "nee": cfg.nee,
        "msamples_per_s": round(stats.msamples_per_s, 3),
        "elapsed_s": round(stats.elapsed_s, 4), "backend": backend,
        "device_kind": stats.device_kind, "device_count": jax.device_count(),
    }))
    return 0


def cmd_invert(args) -> int:
    """Inverse-rendering demo: perturb a sphere albedo, recover it
    (BASELINE config 5, single-host variant)."""
    import dataclasses as dc

    import jax
    import jax.numpy as jnp
    import optax

    from ..diff.inverse import (load_train_state, make_train_step, mean_image,
                                save_train_state)
    from ..models import scenes

    _select_backend(args.backend)
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.depth)
    true_scene, camera = scenes.get_scene(args.scene, cfg.aspect_ratio)
    key = jax.random.PRNGKey(args.seed)
    target = mean_image(true_scene, camera, cfg, key)

    wrong = dc.replace(
        true_scene,
        albedo=true_scene.albedo.at[1].set(jnp.array([0.9, 0.1, 0.5])))
    start_cam = camera
    if args.train_camera:
        delta = jnp.array([0.15, -0.1, 0.1])
        start_cam = dc.replace(
            camera, origin=camera.origin + delta,
            lower_left_corner=camera.lower_left_corner + delta)
    if args.train_camera and not args.edge_aware:
        # Without silhouette gradients, camera parameters need a far gentler
        # step than albedo: the pathwise estimator sees only noisy
        # interior-shading signals. --edge-aware removes the crutch (the
        # boundary term restores the real camera gradient).
        optimizer = optax.multi_transform(
            {"scene": optax.adam(args.lr),
             "camera": optax.adam(args.lr * 0.05)},
            {"scene": "scene", "camera": "camera"})
    else:
        optimizer = optax.adam(args.lr)
    init_state, step_fn, rebuild, rebuild_cam = make_train_step(
        wrong, start_cam, cfg, optimizer, trainable=("albedo",),
        train_camera="pose" if args.train_camera else False,
        edge_aware=args.edge_aware, loss=args.loss)
    state = init_state()
    if args.resume and args.checkpoint:
        state = load_train_state(args.checkpoint, state)
        print(f"resumed at step {int(state.step)}", file=sys.stderr)
    try:
        for it in range(int(state.step), args.steps):
            state, loss = step_fn(state, target,
                                  jax.random.fold_in(key, it + 1))
            if it % 10 == 0 or it == args.steps - 1:
                print(f"step {it:4d} loss {float(loss):.6f}")
            if args.checkpoint and (it + 1) % args.checkpoint_every == 0:
                save_train_state(args.checkpoint, state)
    except KeyboardInterrupt:
        if args.checkpoint:
            save_train_state(args.checkpoint, state)
            print(f"\ninterrupted at step {int(state.step)}; optimizer state "
                  f"saved to {args.checkpoint} (resume with --resume)",
                  file=sys.stderr)
            return 130
        raise
    if args.checkpoint:
        save_train_state(args.checkpoint, state)
    rec = np.asarray(state.params["scene"]["albedo"][1])
    true = np.asarray(true_scene.albedo[1])
    print(f"recovered albedo {np.round(rec, 3).tolist()} "
          f"(true {np.round(true, 3).tolist()}, "
          f"max err {np.abs(rec - true).max():.4f})")
    if args.train_camera:
        rec_o = np.asarray(rebuild_cam(state.params).origin)
        true_o = np.asarray(camera.origin)
        print(f"recovered camera origin {np.round(rec_o, 3).tolist()} "
              f"(true {np.round(true_o, 3).tolist()}, "
              f"err {np.abs(rec_o - true_o).max():.4f})")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="qt_raytracer",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    from ..models.scenes import MESH_SCENES, SCENES
    scene_choices = sorted(SCENES) + sorted(MESH_SCENES)

    def common(sp):
        # Defaults = the reference QML panel (Main.qml:10-13). Every
        # registered scene is renderable from the CLI, mirroring the
        # reference exposing all backend scenes (Main.qml:18-19).
        sp.add_argument("--scene", default="random", choices=scene_choices)
        sp.add_argument("--width", type=int, default=400)
        sp.add_argument("--height", type=int, default=225)
        sp.add_argument("--spp", type=int, default=24)
        sp.add_argument("--aa", choices=sorted(AA_PRESETS),
                        help="AA preset overriding --spp (low=8/medium=24/high=64)")
        sp.add_argument("--depth", type=int, default=10)
        sp.add_argument("--nee", action="store_true",
                        help="next-event estimation (direct light sampling)")
        sp.add_argument("--quantizer", default="cpu", choices=["cpu", "gpu"])
        sp.add_argument("--backend", default="auto",
                        choices=["auto", "gpu", "cpu"],
                        help="auto: JAX's default platform; gpu: fail "
                             "unless a GPU is visible; cpu: pin the host")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--samples-per-batch", type=int, default=1)
        sp.add_argument("--pixel-chunk", type=int, default=0)

    pr = sub.add_parser("render", help="render a scene to PNG")
    common(pr)
    pr.add_argument("--out", default="out.png")
    pr.add_argument("--progressive", action="store_true")
    pr.add_argument("--batch", type=int, default=1,
                    help="spp per progressive step")
    pr.add_argument("--checkpoint", help="checkpoint file for save/resume")
    pr.add_argument("--resume", action="store_true")
    pr.set_defaults(fn=cmd_render)

    pv = sub.add_parser("preview", help="progressive live preview (PNG/ANSI)")
    common(pv)
    pv.add_argument("--out", default="preview.png")
    pv.add_argument("--batch", type=int, default=1)
    pv.add_argument("--ansi", action="store_true",
                    help="render into the terminal (truecolor half-blocks)")
    pv.add_argument("--ansi-cols", type=int, default=80)
    pv.set_defaults(fn=cmd_preview)

    pi2 = sub.add_parser(
        "interactive",
        help="fly the camera in the terminal (progressive ANSI viewport)")
    common(pi2)
    pi2.add_argument("--batch", type=int, default=1,
                     help="spp per refinement step")
    pi2.add_argument("--ansi-cols", type=int, default=100)
    pi2.set_defaults(fn=cmd_interactive)

    pb = sub.add_parser("bench", help="timed render, one JSON line")
    common(pb)
    pb.add_argument("--iters", type=int, default=3)
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("invert", help="inverse-rendering demo")
    common(pi)
    pi.add_argument("--steps", type=int, default=60)
    pi.add_argument("--lr", type=float, default=5e-2)
    pi.add_argument("--train-camera", action="store_true",
                    help="also recover a perturbed camera origin")
    pi.add_argument("--edge-aware", action="store_true",
                    help="silhouette (visibility) gradients — full-strength "
                         "camera recovery, ~2x trace cost")
    pi.add_argument("--checkpoint",
                    help="file for optimizer-state save/resume (.npz)")
    pi.add_argument("--resume", action="store_true",
                    help="restore optimizer state from --checkpoint")
    pi.add_argument("--checkpoint-every", type=int, default=10)
    pi.add_argument("--loss", default="l2", choices=["l2", "dual"],
                    help="image loss: fixed-key L2 or the dual-buffer "
                         "debiased product loss (kills the fixed-key "
                         "noise-fit floor at equal cost)")
    pi.set_defaults(fn=cmd_invert)
    return p


def main(argv=None) -> int:
    from ..runtime.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
