"""Triangle-silhouette estimator bias attribution.

tests/test_mesh_edge_gradients.py measured edge 0.0299 vs FD 0.0502 (60%
capture) on the camera-translation L2 case at 16 spp and left the missing
40% unattributed: MC noise, the 1-px kernel's velocity blur, or a real
estimator defect. This script separates them on the same geometry:

  - FD convergence: central differences at eps in {4e-2, 2e-2, 1e-2, 5e-3}
    at HIGH spp (the FD of a fixed-key discontinuous render has its own
    eps-bias: the silhouette sweeps a finite pixel band);
  - estimator convergence: edge-aware autodiff at spp in {16, 64, 256}
    x EDGE_KERNEL_PX in {0.5, 1.0, 2.0} (O(W) kernel bias shows as a
    linear-in-W trend; MC noise shows as spread over keys);
  - key spread: 4 keys per cell for error bars.

Run (CPU, ~minutes):  env PYTHONPATH= JAX_PLATFORMS=cpu \
    python benchmarks/tri_edge_bias.py [--case l2|rad]
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
from qt_raytracer.accel.mesh import MeshBuilder
from qt_raytracer.core.camera import make_camera
from qt_raytracer.core.scene import SceneBuilder
from qt_raytracer.core.world import World
from qt_raytracer.diff import edge as edge_mod
from qt_raytracer.diff.inverse import mean_image


def quad_world(dx: float = 0.0):
    m = MeshBuilder()
    m.add_quad((-0.5 + dx, -0.5, -3.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
               albedo=(0.8, 0.2, 0.2))
    b = SceneBuilder()
    b.lambertian((0.0, 0.0, 500.0), 1.0, (0.5, 0.5, 0.5))
    return World(spheres=b.build(pad_to=8), mesh=m.build())


def camera(cfg):
    return make_camera(lookfrom=(0, 0, 0), lookat=(0, 0, -1), vup=(0, 1, 0),
                       vfov=60.0, aspect_ratio=cfg.aspect_ratio,
                       aperture=0.0, focus_dist=1.0)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="l2", choices=["l2", "rad"])
    ap.add_argument("--spp", nargs="*", type=int, default=[16, 64, 256])
    args = ap.parse_args()

    base_cfg = RenderConfig(width=64, height=48, spp=16, max_depth=2)
    cam = camera(base_cfg)
    world = quad_world()
    key0 = jax.random.PRNGKey(0)

    def make_loss(cfg, key):
        if args.case == "l2":
            target = mean_image(world, cam, cfg, key0)

            def loss(dx):
                delta = jnp.array([0.10 + dx, 0.0, 0.0])
                c = dc.replace(cam, origin=cam.origin + delta,
                               lower_left_corner=cam.lower_left_corner
                               + delta)
                img = mean_image(world, c, cfg, key)
                return jnp.mean((img - target) ** 2)
        else:
            def loss(dz):
                w = quad_world()
                mesh = w.mesh
                delta = jnp.array([0.0, 0.0, dz])
                mesh = dc.replace(mesh, v0=mesh.v0 + delta,
                                  bvh_min=mesh.bvh_min + delta,
                                  bvh_max=mesh.bvh_max + delta)
                return jnp.mean(mean_image(dc.replace(w, mesh=mesh), cam,
                                           cfg, key))
        return loss

    print(f"# case={args.case}")
    # 1. FD convergence at the highest spp (the "truth" column).
    spp_hi = max(args.spp)
    cfg_hi = dc.replace(base_cfg, spp=spp_hi)
    for eps in (4e-2, 2e-2, 1e-2, 5e-3):
        fds = []
        for ki in range(4):
            loss = make_loss(cfg_hi, jax.random.fold_in(key0, ki))
            fds.append((float(loss(eps)) - float(loss(-eps))) / (2 * eps))
        print(f"fd   spp={spp_hi:4d} eps={eps:7.0e} "
              f"mean={np.mean(fds):+.5f} sd={np.std(fds):.5f}")

    # 2. estimator convergence over spp x kernel width x keys.
    for spp in args.spp:
        for w_px in (0.5, 1.0, 2.0):
            edge_mod.EDGE_KERNEL_PX = w_px
            jax.clear_caches()
            cfg_e = dc.replace(base_cfg, spp=spp, edge_aware=True)
            gs = []
            for ki in range(4):
                loss = make_loss(cfg_e, jax.random.fold_in(key0, ki))
                gs.append(float(jax.grad(loss)(0.0)))
            print(f"edge spp={spp:4d} W={w_px:3.1f} "
                  f"mean={np.mean(gs):+.5f} sd={np.std(gs):.5f}")
    edge_mod.EDGE_KERNEL_PX = 1.0


if __name__ == "__main__":
    main()
