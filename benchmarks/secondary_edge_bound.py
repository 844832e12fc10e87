"""Measured bound on the secondary-bounce boundary term.

The edge-aware estimator (diff/edge.py) carries PRIMARY-ray silhouettes
only. What it drops for the BASELINE parameter families:

  - albedo / emission: visibility boundaries do not move under either
    (v_n = 0 along every edge), so their boundary term is IDENTICALLY zero
    at all bounces — no measurement needed.
  - camera pose: primary silhouettes sweep (captured). The dropped part is
    the SECONDARY discontinuity: as the visible point x1 sweeps with the
    camera, it can cross shadow boundaries / reflected silhouettes on the
    surface, whose per-sample visibility jump the detached-decision
    estimator zeroes.

This script measures that dropped share on the enclosed mesh Cornell box
(the worst case: most light is indirect):

    residual = FD(loss) - autodiff_edge(loss)

at high spp over several keys, reported as a fraction of FD. FD of the
same fixed-key render is the full gradient (all bounces, all boundary
terms); the edge-aware autodiff carries interior + primary-boundary; the
residual (beyond noise, which the key spread bounds) is the secondary-
boundary share plus primary-estimator bias (bounded separately by
benchmarks/tri_edge_bias.py).

Run (CPU):  env PYTHONPATH= JAX_PLATFORMS=cpu \
    python benchmarks/secondary_edge_bound.py [--spp 64]
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
from qt_raytracer.diff.inverse import mean_image
from qt_raytracer.models import meshes


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--keys", type=int, default=4)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--eps", type=float, default=1e-2)
    args = ap.parse_args()

    cfg = RenderConfig(width=48, height=32, spp=args.spp,
                       max_depth=args.depth, nee=True)
    cfg_edge = dc.replace(cfg, edge_aware=True)
    world = meshes.cornell_box_world()
    cam = meshes.cornell_box_mesh_camera(cfg.aspect_ratio)
    key0 = jax.random.PRNGKey(0)
    target = mean_image(world, cam, cfg, key0)
    base = jnp.array([0.12, -0.08, 0.0])     # the test's pose perturbation

    print(f"# cornell mesh {cfg.width}x{cfg.height} spp={cfg.spp} "
          f"depth={cfg.max_depth} nee")
    for axis in (0, 1):
        unit = jnp.zeros(3).at[axis].set(1.0)

        def loss(s, c, key):
            delta = base + s * unit
            camp = dc.replace(cam, origin=cam.origin + delta,
                              lower_left_corner=cam.lower_left_corner
                              + delta)
            return jnp.mean((mean_image(world, camp, c, key) - target) ** 2)

        fds, ges, gps = [], [], []
        eps = args.eps
        for ki in range(args.keys):
            key = jax.random.fold_in(key0, ki)
            fd = (float(loss(eps, cfg, key))
                  - float(loss(-eps, cfg, key))) / (2 * eps)
            ge = float(jax.grad(lambda s: loss(s, cfg_edge, key))(0.0))
            gp = float(jax.grad(lambda s: loss(s, cfg, key))(0.0))
            fds.append(fd)
            ges.append(ge)
            gps.append(gp)
        fd_m, fd_s = np.mean(fds), np.std(fds)
        ge_m, ge_s = np.mean(ges), np.std(ges)
        resid = fd_m - ge_m
        print(f"axis={axis}: fd={fd_m:+.5f}±{fd_s:.5f} "
              f"edge={ge_m:+.5f}±{ge_s:.5f} "
              f"plain={np.mean(gps):+.5f} "
              f"residual={resid:+.5f} ({abs(resid)/max(abs(fd_m),1e-12):.1%} "
              f"of fd)")


if __name__ == "__main__":
    main()
