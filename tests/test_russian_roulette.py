"""Russian-roulette termination: oracle exactness + unbiasedness."""

import jax
import numpy as np

from qt_raytracer import RenderConfig, render_linear
from qt_raytracer.models import scenes
from qt_raytracer.testing import oracle


def test_rr_matches_oracle():
    cfg = RenderConfig(width=12, height=8, spp=2, max_depth=8, rr_start=2)
    scene, cam = scenes.get_scene("three_sphere", cfg.aspect_ratio,
                                  pad_to=None)
    key = jax.random.PRNGKey(0)
    got = np.asarray(render_linear(scene, cam, cfg, key), np.float64) / cfg.spp
    want = oracle.render_oracle_linear(scene, cam, cfg, key) / cfg.spp
    # RR decisions can flip between f32 and f64 at the survival boundary.
    mismatch = np.abs(got - want) > (2e-3 + 2e-3 * np.abs(want))
    assert mismatch.mean() <= 0.02, mismatch.mean()


def test_rr_unbiased():
    # Estimator means with and without RR agree within MC noise. The enclosed
    # cornell scene has long light paths, which RR truncates aggressively.
    scene, cam = scenes.get_scene("cornell", 1.0, pad_to=None)
    key = jax.random.PRNGKey(3)
    base = dict(width=8, height=8, max_depth=12, samples_per_batch=8,
                nee=True)
    a = np.asarray(render_linear(
        scene, cam, RenderConfig(spp=256, **base), key)) / 256
    b = np.asarray(render_linear(
        scene, cam, RenderConfig(spp=256, rr_start=3, **base), key)) / 256
    assert abs(a.mean() - b.mean()) / a.mean() < 0.08, (a.mean(), b.mean())


def test_rr_off_is_bit_identical_to_before():
    # rr_start=0 must not perturb the reference-semantics path at all.
    cfg0 = RenderConfig(width=10, height=8, spp=2, max_depth=5)
    cfg1 = RenderConfig(width=10, height=8, spp=2, max_depth=5, rr_start=0)
    scene, cam = scenes.get_scene("glossy_dof", cfg0.aspect_ratio)
    key = jax.random.PRNGKey(1)
    a = np.asarray(render_linear(scene, cam, cfg0, key))
    b = np.asarray(render_linear(scene, cam, cfg1, key))
    np.testing.assert_array_equal(a, b)
