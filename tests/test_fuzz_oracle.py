"""Randomized renderer-vs-oracle cross-checks.

Seeded fuzz over scene composition (materials, sizes, overlaps), camera
poses, and feature flags — catches interaction bugs the targeted golden
tests might miss. Failures print the seed for replay.
"""

import jax
import numpy as np
import pytest

from qt_raytracer import RenderConfig, SceneBuilder, render_linear
from qt_raytracer.core.camera import make_camera
from qt_raytracer.testing import oracle


def _random_scene(rng, n_spheres):
    b = SceneBuilder()
    b.lambertian((0.0, -1000.0, 0.0), 1000.0, rng.uniform(0.2, 0.8, 3))
    for _ in range(n_spheres):
        kind = rng.integers(0, 4)
        center = rng.uniform(-3, 3, 3) * np.array([1, 0.5, 1]) + [0, 1, 0]
        radius = rng.uniform(0.2, 1.0)
        if kind == 0:
            b.lambertian(center, radius, rng.uniform(0, 1, 3))
        elif kind == 1:
            b.metal(center, radius, rng.uniform(0.4, 1, 3),
                    rng.uniform(0, 1.2))  # exercises fuzz clamp
        elif kind == 2:
            b.dielectric(center, radius, rng.uniform(1.1, 2.0))
        else:
            b.emissive(center, radius, rng.uniform(0, 8, 3))
    return b.build(pad_to=None)


def _random_camera(rng, aspect):
    lookfrom = rng.uniform(-1, 1, 3) * np.array([4, 1, 1]) + [0, 2.0, 7.0]
    return make_camera(lookfrom, (0.0, 1.0, 0.0), vfov=rng.uniform(25, 50),
                       aspect_ratio=aspect, aperture=rng.uniform(0, 0.3),
                       focus_dist=float(np.linalg.norm(lookfrom - [0, 1, 0])))


@pytest.mark.parametrize("seed", [11, 23, 37, 59])
def test_fuzzed_scene_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    cfg = RenderConfig(width=10, height=8, spp=2, max_depth=4,
                       nee=bool(seed % 2), rr_start=3 if seed % 3 == 0 else 0,
                       rng="hash" if seed % 2 else "threefry")
    scene = _random_scene(rng, n_spheres=int(rng.integers(3, 10)))
    cam = _random_camera(rng, cfg.aspect_ratio)
    key = jax.random.PRNGKey(seed)
    got = np.asarray(render_linear(scene, cam, cfg, key), np.float64) / cfg.spp
    want = oracle.render_oracle_linear(scene, cam, cfg, key) / cfg.spp
    mismatch = np.abs(got - want) > (4e-3 + 4e-3 * np.abs(want))
    assert mismatch.mean() <= 0.02, (
        f"seed={seed}: mismatch fraction {mismatch.mean():.4f}")
