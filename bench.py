"""Headline benchmark: full-frame path tracing throughput on one device.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "platform",
"device_kind"}, with the device as JAX reports it. A number is a device
number only when "platform" is "gpu".

Workload: the book-cover random scene (reference RayTracer.h:599-643) at
1920x1080, 1 spp, max_depth 10 — the BASELINE.md "rays/s at 1spp 1080p"
config. Throughput metric = Msamples/s = W*H*spp / elapsed, the reference's
own formula (src/app/RayTracerFboItem.cpp:400-404).

vs_baseline: the reference publishes no numbers (BASELINE.md), so the
comparison anchor is a nominal 10 Msamples/s — a generous estimate for the
reference's multithreaded CPU tracer on a desktop workstation (its only
backend that renders this scene; the GPU backends hardcode a 4-sphere scene).

Run: python bench.py
"""

from __future__ import annotations

import json
import time

import jax

BASELINE_MSAMPLES = 10.0


def main() -> None:
    from qt_raytracer import RenderConfig
    from qt_raytracer.core.render import render_linear
    from qt_raytracer.models import scenes
    from qt_raytracer.runtime.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    # pixel_chunk=0 -> auto heuristic (5 x 414720-ray chunks at 1080p);
    # intersector auto -> the Pallas kernels on a GPU.
    cfg = RenderConfig(width=1920, height=1080, spp=1, max_depth=10,
                       rng="hash")
    scene, camera = scenes.get_scene("random", cfg.aspect_ratio)
    key = jax.random.PRNGKey(0)
    dev = jax.devices()[0]

    t0 = time.perf_counter()
    jax.block_until_ready(render_linear(scene, camera, cfg, key))
    compile_and_first = time.perf_counter() - t0

    iters = 4
    keys = [jax.block_until_ready(jax.random.fold_in(key, it))
            for it in range(iters)]
    t0 = time.perf_counter()
    for k in keys:
        out = render_linear(scene, camera, cfg, k)
    jax.block_until_ready(out)
    elapsed = (time.perf_counter() - t0) / iters

    samples = cfg.width * cfg.height * cfg.spp
    msamples = samples / elapsed / 1e6
    print(json.dumps({
        "metric": "path_trace_throughput_1080p_1spp_d10",
        "value": round(msamples, 3),
        "unit": "Msamples/s/device",
        "vs_baseline": round(msamples / BASELINE_MSAMPLES, 3),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "first_call_s": round(compile_and_first, 2),
    }))


if __name__ == "__main__":
    main()
