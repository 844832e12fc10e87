"""Edge-aware (silhouette) gradient tests — the view-WITH-silhouettes FD
check (BASELINE north star
"edge-aware gradients").

Geometry: one Lambertian sphere against the sky gradient, sphere fully
inside frame — the mean-radiance functional is dominated by the visibility
boundary, so plain pathwise gradients are ~0 while the true derivative is
large. FD of the SAME fixed-key render is ground truth (pixels flip as the
silhouette sweeps their fixed sample points)."""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qt_raytracer import RenderConfig
from qt_raytracer.core.camera import make_camera
from qt_raytracer.core.scene import SceneBuilder
from qt_raytracer.diff.inverse import mean_image

CFG = RenderConfig(width=64, height=48, spp=16, max_depth=2)
CFG_EDGE = dc.replace(CFG, edge_aware=True)
KEY = jax.random.PRNGKey(0)


def _one_sphere():
    b = SceneBuilder()
    b.lambertian((0.0, 0.0, -3.0), 1.0, (0.8, 0.2, 0.2))
    scene = b.build(pad_to=8)
    cam = make_camera(lookfrom=(0, 0, 0), lookat=(0, 0, -1), vup=(0, 1, 0),
                      vfov=60.0, aspect_ratio=CFG.aspect_ratio,
                      aperture=0.0, focus_dist=1.0)
    return scene, cam


def _mean_rad(scene, cam, cfg):
    return jnp.mean(mean_image(scene, cam, cfg, KEY))


def test_edge_term_is_primal_zero():
    # Forward images must be BITWISE unchanged: the boundary term is exactly
    # zero in the primal (w * (sd - stopgrad(sd)) == 0).
    scene, cam = _one_sphere()
    a = np.asarray(mean_image(scene, cam, CFG, KEY))
    b = np.asarray(mean_image(scene, cam, CFG_EDGE, KEY))
    np.testing.assert_array_equal(a, b)


def test_radius_silhouette_gradient_matches_fd():
    # Radius controls silhouette area almost purely: the cleanest boundary
    # check. Plain pathwise sees ~0; edge-aware must match FD.
    scene, cam = _one_sphere()

    def loss(dr, cfg):
        sc = dc.replace(scene, radius=scene.radius.at[0].add(dr))
        return _mean_rad(sc, cam, cfg)

    eps = 2e-2
    fd = (float(loss(eps, CFG)) - float(loss(-eps, CFG))) / (2 * eps)
    g_plain = float(jax.grad(lambda d: loss(d, CFG))(0.0))
    g_edge = float(jax.grad(lambda d: loss(d, CFG_EDGE))(0.0))
    # Measured: FD ~ -0.267, edge ~ -0.249, plain ~ -0.0002.
    assert abs(g_plain) < 0.1 * abs(fd), (g_plain, fd)
    np.testing.assert_allclose(g_edge, fd, rtol=0.15)


def test_camera_translation_silhouette_gradient():
    # Camera x-translation moves the silhouette across pixels; the plain
    # estimator is blind to it (the round-1 0.05x-lr crutch). Edge-aware
    # must land within 2x of FD with the right sign (FD itself carries MC
    # edge-sampling noise at this size).
    scene, cam = _one_sphere()

    def loss(dx, cfg):
        c = dc.replace(
            cam, origin=cam.origin + jnp.array([dx, 0.0, 0.0]),
            lower_left_corner=cam.lower_left_corner + jnp.array([dx, 0.0, 0.0]))
        return _mean_rad(scene, c, cfg)

    eps = 4e-2
    fd = (float(loss(eps, CFG)) - float(loss(-eps, CFG))) / (2 * eps)
    g_edge = float(jax.grad(lambda d: loss(d, CFG_EDGE))(0.0))
    g_plain = float(jax.grad(lambda d: loss(d, CFG))(0.0))
    assert np.sign(g_edge) == np.sign(fd) and abs(g_edge) > 5 * abs(g_plain)
    np.testing.assert_allclose(g_edge, fd, rtol=1.0)


def test_center_gradient_through_squared_loss():
    # End-to-end through the L2 image loss (the quantity training uses):
    # perturbed-start gradient must point back toward the target and
    # agree with FD of the same fixed-key loss.
    scene, cam = _one_sphere()
    target = mean_image(scene, cam, CFG, KEY)

    def loss(dcx, cfg):
        sc = dc.replace(scene, center=scene.center.at[0, 0].add(0.3 + dcx))
        img = mean_image(sc, cam, cfg, KEY)
        return jnp.mean((img - target) ** 2)

    eps = 2e-2
    fd = (float(loss(eps, CFG)) - float(loss(-eps, CFG))) / (2 * eps)
    g_edge = float(jax.grad(lambda d: loss(d, CFG_EDGE))(0.0))
    assert np.sign(g_edge) == np.sign(fd)
    np.testing.assert_allclose(g_edge, fd, rtol=0.5)


@pytest.mark.slow
def test_edge_aware_kernel_path_matches_xla():
    # The kernel edge path (kernel selection + per-lane exclusion + XLA
    # re-derives) must agree with the xla edge path: identical primal (both
    # primal-zero over their own forward) and matching gradients (same
    # estimator, ulp-level forward differences only).
    scene, cam = _one_sphere()
    cfg_f = dc.replace(CFG, intersector="pallas_interpret")
    cfg_fe = dc.replace(cfg_f, edge_aware=True)

    # Primal-zero on the kernel path: bitwise-identical forward images.
    a = np.asarray(mean_image(scene, cam, cfg_f, KEY))
    b = np.asarray(mean_image(scene, cam, cfg_fe, KEY))
    np.testing.assert_array_equal(a, b)

    def loss(dr, cfg):
        sc = dc.replace(scene, radius=scene.radius.at[0].add(dr))
        return _mean_rad(sc, cam, cfg)

    g_xla = float(jax.grad(lambda d: loss(d, CFG_EDGE))(0.0))
    g_kernel = float(jax.grad(lambda d: loss(d, cfg_fe))(0.0))
    np.testing.assert_allclose(g_kernel, g_xla, rtol=5e-3)

    def loss_cam(dx, cfg):
        c = dc.replace(
            cam, origin=cam.origin + jnp.array([dx, 0.0, 0.0]),
            lower_left_corner=(cam.lower_left_corner
                               + jnp.array([dx, 0.0, 0.0])))
        return _mean_rad(scene, c, cfg)

    gc_xla = float(jax.grad(lambda d: loss_cam(d, CFG_EDGE))(0.0))
    gc_fused = float(jax.grad(lambda d: loss_cam(d, cfg_fe))(0.0))
    np.testing.assert_allclose(gc_fused, gc_xla, rtol=5e-3)


@pytest.mark.slow
def test_radius_gradient_high_spp_tight_tolerance():
    # Nightly-grade estimator-BIAS pin: at spp 256
    # the MC noise of both FD and the boundary estimator is small enough to
    # check magnitude, not just sign. The residual tolerance bounds the
    # 1-px kernel's blur bias of the edge velocity.
    scene, cam = _one_sphere()
    cfg = dc.replace(CFG, spp=256)
    cfg_edge = dc.replace(cfg, edge_aware=True)

    def loss(dr, c):
        sc = dc.replace(scene, radius=scene.radius.at[0].add(dr))
        return jnp.mean(mean_image(sc, cam, c, KEY))

    eps = 2e-2
    fd = (float(loss(eps, cfg)) - float(loss(-eps, cfg))) / (2 * eps)
    g_edge = float(jax.grad(lambda d: loss(d, cfg_edge))(0.0))
    np.testing.assert_allclose(g_edge, fd, rtol=0.05)


def test_camera_pose_recovery_with_edge_gradients():
    # Done-criterion of edge-aware gradients: recover a 0.15-unit camera-origin
    # perturbation WITHOUT the 0.05x-lr crutch. Pose parameterization
    # ("pose": one rigid [3] translation) + edge-aware gradients at full lr.
    # Measured contrast at CLI scale: plain pathwise barely moves
    # (0.15 -> 0.13); edge-aware converges (-> 0.03).
    import optax
    from qt_raytracer.diff.inverse import make_train_step
    from qt_raytracer.models import scenes

    cfg = RenderConfig(width=48, height=32, spp=4, max_depth=3)
    scene, cam = scenes.get_scene("three_sphere", cfg.aspect_ratio)
    target = mean_image(scene, cam, cfg, KEY)
    delta = jnp.array([0.15, -0.1, 0.1])
    start_cam = dc.replace(cam, origin=cam.origin + delta,
                           lower_left_corner=cam.lower_left_corner + delta)
    init_state, step_fn, _, rebuild_cam = make_train_step(
        scene, start_cam, cfg, optax.adam(3e-2), trainable=(),
        train_camera="pose", edge_aware=True)
    state = init_state()
    for it in range(50):
        state, loss = step_fn(state, target, jax.random.fold_in(KEY, it + 1))
    rec = np.asarray(rebuild_cam(state.params).origin)
    err = np.abs(rec - np.asarray(cam.origin)).max()
    assert err < 0.08, (rec, np.asarray(cam.origin), err)
