"""Scaling-efficiency harness (north star: >= 90% rays/s, 1 -> N devices).

Measures sharded-render throughput across mesh sizes. The default mode is
ONE process that drives every GPU it sees (one host, four cards joined by
NVLink), timing the px-sharded frame on the first 1, 2, 4 cards:

    python benchmarks/scaling.py --devices 1 2 4

--virtual N simulates N devices on the CPU — useful for validating the
harness and the collective paths, NOT for efficiency numbers (virtual
devices share one socket's FLOPs):

    python benchmarks/scaling.py --virtual 8 --devices 1 2 4 8

Multi-process mode (--processes N) spawns N cooperating OS processes on
localhost (jax.distributed.initialize + CPU collectives, 4 virtual CPU
devices each; it never opens a GPU) and times the cross-process sharded
render — the multi-host coordination path (docs/MULTIHOST.md):

    python benchmarks/scaling.py --processes 2

Prints one JSON line per device count with throughput, the efficiency
relative to the single-device run, and the device as JAX reports it.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--virtual", type=int, default=0,
                    help="simulate N CPU devices (validation only)")
    ap.add_argument("--devices", nargs="*", type=int, default=None)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--processes", type=int, default=0,
                    help="spawn N localhost processes (real multi-process "
                         "path, 4 virtual CPU devices each)")
    ap.add_argument("--_worker", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--_port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.processes and args._worker < 0:
        return _spawn_processes(args)

    if args._worker >= 0:
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        from qt_raytracer.parallel import distributed
        distributed.initialize(f"localhost:{args._port}",
                               num_processes=args.processes,
                               process_id=args._worker)
        return _worker_bench(args)

    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={args.virtual} "
            + os.environ.get("XLA_FLAGS", ""))
        import jax
        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    from qt_raytracer import RenderConfig
    from qt_raytracer.models import scenes
    from qt_raytracer.parallel.sharding import (make_mesh,
                                                    render_linear_sharded)

    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.depth, rng="hash")
    scene, cam = scenes.get_scene("random", cfg.aspect_ratio)
    key = jax.random.PRNGKey(0)
    total = len(jax.devices())
    counts = args.devices or [n for n in (1, 2, 4, 8, 16, 32) if n <= total]

    base = None
    for n in counts:
        mesh = make_mesh(sp=1, px=n, devices=jax.devices()[:n])
        out = render_linear_sharded(scene, cam, cfg, key, mesh)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = render_linear_sharded(scene, cam, cfg, key, mesh)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / args.iters
        ms = cfg.width * cfg.height * cfg.spp / dt / 1e6
        if base is None:
            base = ms
        print(json.dumps({
            "devices": n, "elapsed_s": round(dt, 4),
            "msamples_per_s": round(ms, 3),
            "efficiency_vs_1": round(ms / (base * n), 3),
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
        }))


def _spawn_processes(args):
    """Coordinator: fork N worker copies of this script and relay output."""
    import socket
    import subprocess

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
    env["PYTHONPATH"] = str(pathlib.Path(__file__).resolve().parents[1])
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--processes", str(args.processes),
         "--_worker", str(i), "--_port", str(port),
         "--width", str(args.width), "--height", str(args.height),
         "--spp", str(args.spp), "--depth", str(args.depth),
         "--iters", str(args.iters)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env)
        for i in range(args.processes)]
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        if i == 0:
            sys.stdout.write(out)
        if p.returncode != 0:
            raise SystemExit(f"worker {i} failed rc={p.returncode}")
    return 0


def _worker_bench(args):
    """One distributed process: sharded render over the GLOBAL mesh, with
    the radiance psum crossing the process boundary (sp = #processes)."""
    import jax

    from qt_raytracer import RenderConfig
    from qt_raytracer.models import scenes
    from qt_raytracer.parallel import distributed
    from qt_raytracer.parallel.sharding import render_linear_sharded

    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.depth, rng="hash",
                       samples_per_batch=1)
    scene, cam = scenes.get_scene("random", cfg.aspect_ratio)
    key = jax.random.PRNGKey(0)
    mesh = distributed.global_mesh(sp=args.processes)
    out = render_linear_sharded(scene, cam, cfg, key, mesh)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = render_linear_sharded(scene, cam, cfg, key, mesh)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / args.iters
    ms = cfg.width * cfg.height * cfg.spp / dt / 1e6
    if distributed.is_coordinator():
        print(json.dumps({
            "processes": args.processes,
            "devices": len(jax.devices()),
            "elapsed_s": round(dt, 4),
            "msamples_per_s": round(ms, 3),
            "platform": jax.devices()[0].platform,
        }))
    return 0


if __name__ == "__main__":
    main()
