"""Vectorized-f64 oracle: equivalence to the scalar oracle and a
medium-size renderer validation (the full-size check runs in
benchmarks/run_baselines.py --oracle-full and chip_smoke.py)."""

import jax
import numpy as np
import pytest

from qt_raytracer import RenderConfig, render_linear
from qt_raytracer.models import scenes
from qt_raytracer.testing.oracle import render_oracle_linear
from qt_raytracer.testing.oracle_vec import render_oracle_vec


@pytest.mark.parametrize("name,rr", [("three_sphere", 0), ("glossy_dof", 0),
                                     ("random", 2)])
def test_vec_oracle_matches_scalar_oracle(name, rr):
    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=4, rr_start=rr)
    scene, cam = scenes.get_scene(name, cfg.aspect_ratio)
    key = jax.random.PRNGKey(1)
    a = render_oracle_linear(scene, cam, cfg, key)
    b = render_oracle_vec(scene, cam, cfg, key)
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("name", ["cornell", "cornell_mesh"])
def test_vec_oracle_matches_scalar_oracle_nee_mesh(name):
    # NEE + mesh transport (BASELINE config 2 families): the vectorized
    # oracle must reproduce the scalar oracle's MIS estimator exactly.
    cfg = RenderConfig(width=12, height=12, spp=2, max_depth=4, nee=True)
    scene, cam = scenes.get_scene(name, cfg.aspect_ratio)
    key = jax.random.PRNGKey(5)
    a = render_oracle_linear(scene, cam, cfg, key)
    b = render_oracle_vec(scene, cam, cfg, key)
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-13)


def test_renderer_matches_vec_oracle_cornell_mesh():
    # Config-2 geometry (true Cornell box, area light, NEE) at a size the
    # scalar oracle cannot reach: renderer f32 vs vectorized f64 oracle.
    cfg = RenderConfig(width=64, height=64, spp=2, max_depth=4, nee=True)
    scene, cam = scenes.get_scene("cornell_mesh", cfg.aspect_ratio)
    key = jax.random.PRNGKey(7)
    img = np.asarray(render_linear(scene, cam, cfg, key), np.float64)
    ref = render_oracle_vec(scene, cam, cfg, key)
    per = np.max(np.abs(img - ref), axis=-1) / (np.max(ref, axis=-1) + 1e-3)
    mismatch = float((per > 2e-3).mean())
    assert mismatch < 0.04, mismatch


@pytest.mark.slow
def test_oracle_full_cornell_mesh_256():
    # The continuously-run FULL-SIZE config-2 check:
    # 256x256 NEE + mesh + MIS, renderer f32 vs vectorized f64 oracle,
    # per-pixel mismatch fraction asserted every CI run.
    cfg = RenderConfig(width=256, height=256, spp=4, max_depth=6, nee=True,
                       rng="hash")
    scene, cam = scenes.get_scene("cornell_mesh", cfg.aspect_ratio)
    key = jax.random.PRNGKey(0)
    img = np.asarray(render_linear(scene, cam, cfg, key), np.float64)
    ref = render_oracle_vec(scene, cam, cfg, key)
    per = np.max(np.abs(img - ref), axis=-1) / (np.max(ref, axis=-1) + 1e-3)
    mismatch = float((per > 2e-3).mean())
    assert mismatch < 0.04, mismatch


def test_renderer_matches_vec_oracle_at_96x64():
    # A 48x larger crop than the scalar-oracle goldens run (16x16): the
    # whole point of the vectorized oracle. Per-pixel f32-vs-f64 mismatch
    # fraction must stay within the golden-test budget.
    cfg = RenderConfig(width=96, height=64, spp=4, max_depth=6)
    scene, cam = scenes.get_scene("random", cfg.aspect_ratio)
    key = jax.random.PRNGKey(3)
    img = np.asarray(render_linear(scene, cam, cfg, key), np.float64)
    ref = render_oracle_vec(scene, cam, cfg, key)
    per = np.max(np.abs(img - ref), axis=-1) / (np.max(ref, axis=-1) + 1e-3)
    mismatch = float((per > 2e-3).mean())
    # Budget in line with the scalar golden family (1-3% on glass-heavy
    # scenes — f32 stochastic-branch flips dominate at low spp; measured
    # 2.4% here).
    assert mismatch < 0.04, mismatch
