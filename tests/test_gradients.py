"""Differentiability tests: autodiff gradients vs central finite differences
of the SAME fixed-key render (north-star requirement: "pixel gradients must
match finite differences", BASELINE.md). The estimator is pathwise with
detached decisions, so FD of the deterministic fixed-key function is the
exact truth for interior pixels."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from qt_raytracer import RenderConfig
from qt_raytracer.diff.inverse import (image_loss, make_train_step,
                                           mean_image, split_scene)
from qt_raytracer.models import scenes
from qt_raytracer.parallel.sharding import make_mesh


CFG = RenderConfig(width=12, height=8, spp=2, max_depth=3)
KEY = jax.random.PRNGKey(0)


def _fd_check(loss_fn, x0, eps, rtol, atol=1e-4, max_checks=6):
    """Compare jax.grad to central differences on a few coordinates."""
    g = np.asarray(jax.grad(loss_fn)(x0)).ravel()
    x0f = np.asarray(x0, np.float64).ravel()
    idxs = np.argsort(-np.abs(g))[:max_checks]  # check the largest entries
    for i in idxs:
        d = np.zeros_like(x0f)
        d[i] = eps
        lp = float(loss_fn(jnp.asarray((x0f + d).reshape(np.shape(x0)), jnp.float32)))
        lm = float(loss_fn(jnp.asarray((x0f - d).reshape(np.shape(x0)), jnp.float32)))
        fd = (lp - lm) / (2 * eps)
        np.testing.assert_allclose(g[i], fd, rtol=rtol, atol=atol), i


def test_albedo_gradient_matches_fd():
    scene, cam = scenes.get_scene("three_sphere", CFG.aspect_ratio)
    target = mean_image(scene, cam, CFG, jax.random.PRNGKey(9))

    def loss_of_albedo(albedo):
        import dataclasses
        sc = dataclasses.replace(scene, albedo=albedo)
        return image_loss(sc, cam, CFG, KEY, target)

    _fd_check(loss_of_albedo, scene.albedo, eps=1e-2, rtol=5e-2)


def test_emission_gradient_matches_fd():
    scene, cam = scenes.get_scene("cornell", 1.0)
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=3)
    target = mean_image(scene, cam, cfg, jax.random.PRNGKey(9))

    def loss_of_emission(emission):
        import dataclasses
        sc = dataclasses.replace(scene, emission=emission)
        return image_loss(sc, cam, cfg, KEY, target)

    _fd_check(loss_of_emission, scene.emission, eps=1e-2, rtol=5e-2)


def test_camera_origin_gradient_matches_fd():
    # Pathwise (detached-decision) gradients are exact for INTERIOR pixels;
    # silhouette/visibility terms are excluded by construction (edge-aware
    # gradients are a roadmap extension). So measure on a view where the
    # sphere fills the whole frame: no hit/miss flips within eps, and FD of
    # the fixed-key render equals the autodiff gradient.
    import dataclasses
    from qt_raytracer import SceneBuilder
    from qt_raytracer.core.camera import make_camera

    scene = SceneBuilder().lambertian((0.0, 0.0, -5.0), 3.0, (0.6, 0.4, 0.3)) \
                          .build(pad_to=None)
    cam = make_camera((0, 0, 0), (0, 0, -5.0), vfov=20.0,
                      aspect_ratio=CFG.aspect_ratio, aperture=0.0,
                      focus_dist=5.0)
    target = mean_image(scene, cam, CFG, jax.random.PRNGKey(9))

    def loss_of_origin(origin):
        c2 = dataclasses.replace(cam, origin=origin,
                                 lower_left_corner=cam.lower_left_corner
                                 + (origin - cam.origin))
        return image_loss(scene, c2, CFG, KEY, target)

    _fd_check(loss_of_origin, cam.origin, eps=2e-3, rtol=5e-2, atol=5e-4)


def test_gradients_finite_everywhere():
    # All scene fields at once; glossy scene exercises metal+dielectric paths
    # (safe_sqrt / safe_unit_vector guards).
    scene, cam = scenes.get_scene("glossy_dof", CFG.aspect_ratio)
    target = mean_image(scene, cam, CFG, jax.random.PRNGKey(9))
    params, rebuild = split_scene(scene, ("albedo", "emission", "fuzz", "center",
                                          "radius", "ior"))
    grads = jax.grad(
        lambda p: image_loss(rebuild(p), cam, CFG, KEY, target)
    )(params)
    for name, g in grads.items():
        assert np.isfinite(np.asarray(g)).all(), f"non-finite grad in {name}"
    # and something must actually be nonzero
    assert any(np.abs(np.asarray(g)).max() > 0 for g in grads.values())


def test_sharded_gradient_matches_single_device():
    scene, cam = scenes.get_scene("three_sphere", CFG.aspect_ratio)
    target = mean_image(scene, cam, CFG, jax.random.PRNGKey(9))
    mesh = make_mesh(sp=2, px=4)
    import dataclasses

    def loss_single(albedo):
        return image_loss(dataclasses.replace(scene, albedo=albedo), cam, CFG,
                          KEY, target)

    def loss_sharded(albedo):
        return image_loss(dataclasses.replace(scene, albedo=albedo), cam, CFG,
                          KEY, target, mesh=mesh)

    g1 = np.asarray(jax.grad(loss_single)(scene.albedo))
    g2 = np.asarray(jax.grad(loss_sharded)(scene.albedo))
    np.testing.assert_allclose(g1, g2, atol=1e-6, rtol=1e-4)


def test_inverse_rendering_recovers_albedo():
    # BASELINE config 5 (shrunk): perturb a sphere's albedo, recover it by
    # gradient descent on the image loss.
    import dataclasses
    cfg = RenderConfig(width=16, height=12, spp=4, max_depth=3)
    true_scene, cam = scenes.get_scene("three_sphere", cfg.aspect_ratio)
    target = mean_image(true_scene, cam, cfg, jax.random.PRNGKey(42))

    wrong = dataclasses.replace(
        true_scene,
        albedo=true_scene.albedo.at[1].set(jnp.array([0.2, 0.8, 0.6])),
    )
    init_state, step_fn, rebuild, _ = make_train_step(
        wrong, cam, cfg, optax.adam(5e-2), trainable=("albedo",))
    state = init_state()
    losses = []
    for it in range(60):
        state, loss = step_fn(state, target, jax.random.fold_in(KEY, it))
        losses.append(float(loss))
    # The loss bottoms out at the MC-noise floor (target and training renders
    # use different sample keys); measure convergence of the excess loss.
    floor = float(image_loss(true_scene, cam, cfg, jax.random.fold_in(KEY, 60),
                             target))
    assert losses[-1] - floor < 0.3 * max(losses[0] - floor, 1e-9), (
        losses[0], losses[-1], floor)
    rec = np.asarray(state.params["scene"]["albedo"][1])
    true = np.asarray(true_scene.albedo[1])
    assert np.abs(rec - true).max() < 0.15, (rec, true)


def test_train_state_checkpoint_roundtrip(tmp_path):
    # SURVEY.md §5 checkpoint row: optimizer state (params + adam moments +
    # step) must save/restore so a resumed run continues EXACTLY where a
    # straight-through run would be.
    import dataclasses
    cfg = RenderConfig(width=12, height=8, spp=2, max_depth=3)
    true_scene, cam = scenes.get_scene("three_sphere", cfg.aspect_ratio)
    target = mean_image(true_scene, cam, cfg, jax.random.PRNGKey(42))
    wrong = dataclasses.replace(
        true_scene,
        albedo=true_scene.albedo.at[1].set(jnp.array([0.2, 0.8, 0.6])))
    init_state, step_fn, _, _ = make_train_step(
        wrong, cam, cfg, optax.adam(5e-2), trainable=("albedo",))

    # Straight-through: 4 steps.
    ref = init_state()
    for it in range(4):
        ref, _ = step_fn(ref, target, jax.random.fold_in(KEY, it))

    # Interrupted: 2 steps -> save -> restore -> 2 more.
    from qt_raytracer.diff.inverse import (load_train_state,
                                               save_train_state)
    st = init_state()
    for it in range(2):
        st, _ = step_fn(st, target, jax.random.fold_in(KEY, it))
    save_train_state(tmp_path / "ck", st)
    st2 = load_train_state(tmp_path / "ck", init_state())
    assert int(st2.step) == 2
    for it in range(2, 4):
        st2, _ = step_fn(st2, target, jax.random.fold_in(KEY, it))

    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)),
        ref, st2)
