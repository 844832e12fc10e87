"""Hash (lowbias32 counter) RNG: statistical quality, oracle agreement, and
mesh invariance. The hash RNG is the fast path (threefry costs far more
per bounce); it must uphold the same guarantees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qt_raytracer import RenderConfig, render_linear
from qt_raytracer.core import sampling
from qt_raytracer.models import scenes
from qt_raytracer.parallel.sharding import make_mesh, render_linear_sharded
from qt_raytracer.testing import oracle


def _states(n=4096, seed=0):
    return sampling.pixel_states(jax.random.PRNGKey(seed),
                                 jnp.arange(n, dtype=jnp.uint32), "hash")


def test_uniformity():
    u = np.asarray(sampling.stream_uniforms(_states(), 3, 8)).ravel()
    assert 0.0 <= u.min() and u.max() < 1.0
    # mean/var of U(0,1): 0.5, 1/12; generous MC bounds for 32k draws
    assert abs(u.mean() - 0.5) < 0.01
    assert abs(u.var() - 1.0 / 12.0) < 0.005
    # chi-square-ish: 16-bin occupancy within 10%
    hist, _ = np.histogram(u, bins=16, range=(0, 1))
    assert (np.abs(hist - u.size / 16) < u.size / 16 * 0.1).all()


def test_stream_and_pixel_decorrelation():
    s = _states()
    a = np.asarray(sampling.stream_uniforms(s, 1, 8))
    b = np.asarray(sampling.stream_uniforms(s, 2, 8))
    # Same pixels, different streams: empirical correlation ~ 0.
    corr = np.corrcoef(a.ravel(), b.ravel())[0, 1]
    assert abs(corr) < 0.02, corr
    # Adjacent pixels, same stream: also uncorrelated.
    corr2 = np.corrcoef(a[:-1].ravel(), a[1:].ravel())[0, 1]
    assert abs(corr2) < 0.02, corr2


def test_sample_index_advances_stream():
    s = _states(256)
    s1 = sampling.sample_keys(s, 0)
    s2 = sampling.sample_keys(s, 1)
    assert (np.asarray(s1) != np.asarray(s2)).mean() > 0.99


def test_hash_render_matches_oracle():
    cfg = RenderConfig(width=12, height=8, spp=2, max_depth=4, rng="hash")
    scene, cam = scenes.get_scene("three_sphere", cfg.aspect_ratio,
                                  pad_to=None)
    key = jax.random.PRNGKey(0)
    got = np.asarray(render_linear(scene, cam, cfg, key), np.float64) / cfg.spp
    want = oracle.render_oracle_linear(scene, cam, cfg, key) / cfg.spp
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)


def test_hash_render_mesh_invariant():
    cfg = RenderConfig(width=16, height=12, spp=4, max_depth=4, rng="hash")
    scene, cam = scenes.get_scene("three_sphere", cfg.aspect_ratio)
    key = jax.random.PRNGKey(0)
    ref = np.asarray(render_linear(scene, cam, cfg, key))
    for sp, px in [(2, 4), (4, 2)]:
        mesh = make_mesh(sp=sp, px=px, devices=jax.devices()[: sp * px])
        img = np.asarray(render_linear_sharded(scene, cam, cfg, key, mesh))
        np.testing.assert_allclose(img, ref, atol=1e-5, rtol=1e-5)


def test_hash_image_statistics_match_threefry():
    # Same scene/key, both RNGs at equal spp: the MC estimates must agree
    # within noise (both unbiased estimators of the same integral).
    scene, cam = scenes.get_scene("three_sphere", 1.5)
    key = jax.random.PRNGKey(1)
    base = dict(width=12, height=8, max_depth=4, spp=64, samples_per_batch=8)
    a = np.asarray(render_linear(scene, cam, RenderConfig(rng="hash", **base),
                                 key)) / 64
    b = np.asarray(render_linear(scene, cam,
                                 RenderConfig(rng="threefry", **base), key)) / 64
    assert np.abs(a - b).mean() < 0.02
