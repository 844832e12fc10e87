"""bf16 candidate-sweep refutation.

Simulates the sphere sweep with all candidate math in bf16 (winner
selection only — the kernel's f32 refinement would still recompute the
winner's t exactly) against the f32 sweep, on real book-scene primary
rays. Measured (device-independent, pure numerics):

    hit fraction f32 0.825 vs bf16 0.956; hit/miss flips 13.6%;
    winner flips among shared hits 79.2%; median relative t error 28%.

The failure is structural: near = (-half_b - sq) / a cancels
|c - o|-scale intermediates down to t-scale results, so for the r=1000
ground sphere (|c - o| ~ 1000, t ~ 1) every bf16 mantissa bit dies in the
subtraction. bf16 candidate search is therefore refuted for BOTH the
sphere sweep and Möller-Trumbore t (same cancellation in t = q.e2/det
when the hit is far from the triangle's vertex origin).

    env PYTHONPATH= JAX_PLATFORMS=cpu python benchmarks/bf16_sweep_analysis.py
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from qt_raytracer import RenderConfig
    from qt_raytracer.core import sampling
    from qt_raytracer.core.camera import get_rays
    from qt_raytracer.core.render import pixel_grid
    from qt_raytracer.models import scenes

    cfg = RenderConfig(width=192, height=108, spp=1, max_depth=10)
    scene, cam = scenes.get_scene("random", cfg.aspect_ratio)
    i, j, _ = pixel_grid(cfg)
    pk = sampling.pixel_keys(jax.random.PRNGKey(0), i.shape[0])
    sk = sampling.sample_keys(pk, 0)
    gen = sampling.stream_uniforms(sk, sampling.STREAM_GEN,
                                   sampling.UNIFORMS_GEN)
    o, d = get_rays(cam, (i + gen[:, 0]) / (cfg.width - 1),
                    (j + gen[:, 1]) / (cfg.height - 1), gen[:, 2], gen[:, 3])

    c = scene.center
    r = scene.radius
    c2r2 = jnp.sum(c * c, -1) - r * r + jnp.where(scene.active, 0.0, 3e38)
    t_min, big = 1e-3, 3e38

    def sweep(dt):
        oo, dd, cc = o.astype(dt), d.astype(dt), c.astype(dt)
        a = jnp.sum(dd * dd, -1)[:, None]
        o_dot_d = jnp.sum(oo * dd, -1)[:, None]
        o2 = jnp.sum(oo * oo, -1)[:, None]
        d_dot_c = dd @ cc.T
        o_dot_c = oo @ cc.T
        half_b = o_dot_d - d_dot_c
        cterm = o2 - 2.0 * o_dot_c + c2r2.astype(dt)[None]
        disc = half_b * half_b - a * cterm
        sq = jnp.sqrt(jnp.maximum(disc, 0).astype(jnp.float32)).astype(dt)
        near = (-half_b - sq) / a
        far = (-half_b + sq) / a
        near_ok = (near >= t_min) & (near <= big)
        far_ok = (far >= t_min) & (far <= big)
        root = jnp.where(near_ok, near, far)
        valid = (disc >= 0) & (near_ok | far_ok)
        tc = jnp.where(valid, root.astype(jnp.float32), big)
        return jnp.min(tc, 1), jnp.argmin(tc, 1)

    tb32, ib32 = sweep(jnp.float32)
    tbbf, ibbf = sweep(jnp.bfloat16)
    hit32, hitbf = tb32 < big, tbbf < big
    both = hit32 & hitbf
    terr = jnp.abs(tbbf[both] - tb32[both]) / jnp.maximum(tb32[both], 1e-6)
    print(f"hit fraction f32={float(hit32.mean()):.3f} "
          f"bf16={float(hitbf.mean()):.3f}")
    print(f"hit/miss flips: {float((hit32 != hitbf).mean()):.4f}")
    print(f"winner flips among hits: "
          f"{float((ib32[both] != ibbf[both]).mean()):.4f}")
    print(f"t rel err median={float(jnp.median(terr)):.3f} "
          f"max={float(terr.max()):.3f}")


if __name__ == "__main__":
    main()
