"""Kernel-width attribution at SMALL feature scales.

Round 4 pinned the dominant edge-estimator residual on the enclosed mesh
Cornell at 48x32 as kernel-width ATTRIBUTION bias: the boundary
contribution is smeared over the W-px kernel band and weighted by the
per-pixel (img - target) loss weights, which vary across that band when
the feature carrying the discontinuity (the 2-3-px ceiling light) is only
a few pixels wide. The order-2 weight already cancels the O(W) kernel
bias of the edge INTEGRAND; this probe asks whether the attribution
residual is ALSO W-dependent — i.e. whether shrinking W below the feature
scale recovers capture (the premise of a feature-scale-adaptive W).

Protocol: camera-translation L2 loss on the mesh Cornell (the
secondary_edge_bound geometry), FD truth per key (W-independent, computed
once), edge-aware autodiff capture at W in {1.0, 0.5, 0.25} x kernel
order in {1, 2}. If capture is flat in W, adaptive W cannot help and the
ledger gets a refutation entry; if capture rises as W drops, wire the
feature-scale rule.

Run (CPU): env PYTHONPATH= JAX_PLATFORMS=cpu python benchmarks/adaptive_w_probe.py
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

from qt_raytracer import RenderConfig
from qt_raytracer.diff import edge as edge_mod
from qt_raytracer.diff.inverse import mean_image
from qt_raytracer.models import meshes


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--keys", type=int, default=2)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--eps", type=float, default=1e-2)
    ap.add_argument("--axis", type=int, default=0)
    ap.add_argument("--widths", nargs="*", type=float,
                    default=[1.0, 0.5, 0.25])
    args = ap.parse_args()

    cfg = RenderConfig(width=48, height=32, spp=args.spp,
                       max_depth=args.depth, nee=True)
    cfg_edge = dc.replace(cfg, edge_aware=True)
    world = meshes.cornell_box_world()
    cam = meshes.cornell_box_mesh_camera(cfg.aspect_ratio)
    key0 = jax.random.PRNGKey(0)
    target = mean_image(world, cam, cfg, key0)
    base = jnp.array([0.12, -0.08, 0.0])
    unit = jnp.zeros(3).at[args.axis].set(1.0)

    def loss(s, c, key):
        delta = base + s * unit
        camp = dc.replace(cam, origin=cam.origin + delta,
                          lower_left_corner=cam.lower_left_corner + delta)
        return jnp.mean((mean_image(world, camp, c, key) - target) ** 2)

    keys = [jax.random.fold_in(key0, ki) for ki in range(args.keys)]
    fds = []
    for key in keys:
        fd = (float(loss(args.eps, cfg, key))
              - float(loss(-args.eps, cfg, key))) / (2 * args.eps)
        fds.append(fd)
    fd_m = float(np.mean(fds))
    print(f"# cornell 48x32 spp={args.spp} d={args.depth} axis={args.axis} "
          f"fd={fd_m:+.5f}±{np.std(fds):.5f}")

    w0, o0 = edge_mod.EDGE_KERNEL_PX, edge_mod.EDGE_KERNEL_ORDER
    try:
        for order in (1, 2):
            for w_px in args.widths:
                edge_mod.EDGE_KERNEL_PX = w_px
                edge_mod.EDGE_KERNEL_ORDER = order
                jax.clear_caches()
                ges = [float(jax.grad(lambda s: loss(s, cfg_edge, key))(0.0))
                       for key in keys]
                ge_m = float(np.mean(ges))
                print(f"order={order} W={w_px}: edge={ge_m:+.5f}"
                      f"±{np.std(ges):.5f} capture={ge_m / fd_m:.1%}")
    finally:
        edge_mod.EDGE_KERNEL_PX, edge_mod.EDGE_KERNEL_ORDER = w0, o0
        jax.clear_caches()


if __name__ == "__main__":
    main()
