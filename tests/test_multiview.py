"""Multi-view inverse rendering (BASELINE config 5 at spec, shrunken).

Joint recovery of albedo + emitter radiance + per-view camera pose from M
views of one scene — the full-size version is benchmarks/run_baselines.py
config5; this is the same harness at test scale.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from qt_raytracer import RenderConfig
from qt_raytracer.core.camera import make_camera
from qt_raytracer.core.scene import SceneBuilder
from qt_raytracer.diff.inverse import mean_image
from qt_raytracer.diff.multiview import (make_multiview_train_step,
                                             orbit_cameras, render_targets,
                                             translate_camera)

KEY = jax.random.PRNGKey(11)


def _lit_scene(pad_to=8):
    """Small enclosed scene with an emissive light: floor + ball + emitter."""
    b = SceneBuilder()
    b.lambertian((0.0, -100.5, -1.0), 100.0, (0.6, 0.6, 0.6))
    b.lambertian((0.0, 0.0, -1.5), 0.5, (0.75, 0.25, 0.2))
    b.emissive((0.0, 1.6, -1.5), 0.4, (9.0, 9.0, 9.0))
    return b.build(pad_to=pad_to)


def _base_camera(aspect):
    return make_camera(lookfrom=(0.0, 0.4, 1.2), lookat=(0.0, 0.0, -1.5),
                       vup=(0, 1, 0), vfov=55.0, aspect_ratio=aspect,
                       aperture=0.0, focus_dist=1.0)


def test_render_targets_matches_mean_image():
    # Progressive target accumulation == one batch render at equal spp/key
    # (the ProgressiveRenderer invariant, through the multiview helper).
    cfg = RenderConfig(width=32, height=24, spp=6, max_depth=3, rng="hash",
                       nee=True)
    scene = _lit_scene()
    cams = orbit_cameras(_base_camera(cfg.aspect_ratio), [(0, 0, 0)])
    tgt = render_targets(scene, cams, cfg, seed=5, spp_per_call=2)
    ref = mean_image(scene, cams[0], cfg, jax.random.PRNGKey(5))
    # Same per-sample radiances; partial-sum association differs (progressive
    # adds batch sums), so equality is to f32 reassociation tolerance — the
    # same contract as tests/test_app.py::test_progressive_equals_batch.
    np.testing.assert_allclose(np.asarray(tgt[0]), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.slow
@pytest.mark.parametrize("edge_aware", [False, True])
def test_multiview_joint_recovery(edge_aware):
    # Perturb albedo + emission (+ per-view pose in edge-aware mode); the
    # optimization must reduce every trained param-group error (full
    # convergence is the benchmark's job — this asserts the gradients point
    # the right way through the shared-scene / per-view-pose structure).
    #
    # Pose is trained ONLY in edge-aware mode: plain pathwise camera
    # gradients carry no silhouette term, so adam (which normalizes the
    # tiny noisy interior gradient to full-size steps) random-walks the
    # pose and drags the scene params with it — measured, and exactly the
    # failure edge-aware gradients exist to fix (diff/edge.py).
    # The step key is FIXED across iterations: the detached-decision
    # estimator matches FD on a fixed key, and re-sampling per step turns
    # the L2 of a noisy forward into a variance term that biases emitters
    # DOWN (dimming the light reduces render variance) — measured: emission
    # 5 -> 7.4 -> 0.7 with per-step keys vs 5 -> 8.9 (target 9) fixed.
    cfg = RenderConfig(width=48, height=32, spp=2, max_depth=3, rng="hash",
                       nee=True, samples_per_batch=1)
    scene = _lit_scene()
    base = _base_camera(cfg.aspect_ratio)
    true_cams = orbit_cameras(base, [(0, 0, 0), (0.3, 0.0, 0.0),
                                     (0.0, 0.2, 0.1)])
    targets = render_targets(scene, true_cams, cfg, seed=3, spp_per_call=2)

    wrong_scene = dc.replace(
        scene,
        albedo=scene.albedo.at[1].set(jnp.array([0.2, 0.7, 0.7])),
        emission=scene.emission.at[2].set(jnp.array([5.0, 5.0, 5.0])))
    labels = {"scene": {"albedo": "scene", "emission": "emission"}}
    lrs = {"scene": optax.adam(4e-2), "emission": optax.adam(0.3)}
    if edge_aware:
        pose_err0 = jnp.array([0.12, -0.08, 0.1])
        start_cams = tuple(translate_camera(c, pose_err0)
                           for c in true_cams)
        labels["camera"] = {"translate": "camera"}
        lrs["camera"] = optax.adam(3e-2)
    else:
        start_cams = true_cams

    opt = optax.multi_transform(lrs, labels)
    init_state, step_fn, rebuild_scene, rebuild_cams = \
        make_multiview_train_step(wrong_scene, start_cams, cfg, opt,
                                  trainable=("albedo", "emission"),
                                  train_camera="pose" if edge_aware else False,
                                  edge_aware=edge_aware)
    state = init_state()
    steps = 60 if edge_aware else 30
    for it in range(steps):
        state, loss = step_fn(state, targets, KEY)

    rec = rebuild_scene(state.params["scene"])
    alb_err0 = float(jnp.abs(wrong_scene.albedo[1] - scene.albedo[1]).max())
    alb_err = float(jnp.abs(rec.albedo[1] - scene.albedo[1]).max())
    emi_err0 = float(jnp.abs(wrong_scene.emission[2] - scene.emission[2]).max())
    emi_err = float(jnp.abs(rec.emission[2] - scene.emission[2]).max())
    assert alb_err < 0.6 * alb_err0, (alb_err0, alb_err)
    assert emi_err < 0.6 * emi_err0, (emi_err0, emi_err)

    if edge_aware:
        # Pose error must shrink for EVERY view (edge gradients drive it).
        t = np.asarray(state.params["camera"]["translate"])
        err0 = float(np.abs(np.asarray(pose_err0)).max())
        err = np.abs(t + np.asarray(pose_err0)).max(axis=1)
        assert (err < err0).all(), (err, err0)


@pytest.mark.slow
def test_perview_step_matches_scanned_step():
    # make_multiview_train_step_perview (one device call per view, grads
    # accumulated between calls) must compute the SAME update as the
    # scanned single-call step: the scanned loss is (1/M) sum_v loss_v, so
    # its gradient equals the mean of the per-view gradients. Tolerance is
    # f32 reassociation (the accumulation order differs), not bitwise.
    from qt_raytracer.diff.multiview import \
        make_multiview_train_step_perview

    cfg = RenderConfig(width=32, height=24, spp=2, max_depth=3, rng="hash",
                       nee=True, samples_per_batch=1)
    scene = _lit_scene()
    cams = orbit_cameras(_base_camera(cfg.aspect_ratio),
                         [(0, 0, 0), (0.3, 0.0, 0.0)])
    targets = render_targets(scene, cams, cfg, seed=3, spp_per_call=2)
    wrong = dc.replace(scene,
                       albedo=scene.albedo.at[1].set(
                           jnp.array([0.2, 0.7, 0.7])))
    kw = dict(trainable=("albedo", "emission"), train_camera="pose",
              edge_aware=True)
    opt = optax.adam(2e-2)
    init_a, step_a, _, _ = make_multiview_train_step(
        wrong, cams, cfg, opt, **kw)
    init_b, step_b, _, _ = make_multiview_train_step_perview(
        wrong, cams, cfg, opt, **kw)
    sa, sb = init_a(), init_b()
    for _ in range(2):
        sa, loss_a = step_a(sa, targets, KEY)
        sb, loss_b = step_b(sb, targets, KEY)
    np.testing.assert_allclose(float(loss_a), float(loss_b),
                               rtol=1e-5, atol=1e-6)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a),
                                                np.asarray(b),
                                                rtol=2e-4, atol=2e-5),
        sa.params, sb.params)


@pytest.mark.slow
def test_perview_checkpoint_resume_continues_trajectory(tmp_path):
    # The resume semantics of benchmarks/run_baselines.py config5:
    # save at step k, restore into a fresh init_state template, continue —
    # the resumed trajectory must equal the straight-through one (the step
    # key is fixed, the state carries params + adam moments + step).
    from qt_raytracer.diff.inverse import (load_train_state,
                                               save_train_state)
    from qt_raytracer.diff.multiview import \
        make_multiview_train_step_perview

    cfg = RenderConfig(width=24, height=16, spp=2, max_depth=3, rng="hash",
                       nee=True, samples_per_batch=1)
    scene = _lit_scene()
    cams = orbit_cameras(_base_camera(cfg.aspect_ratio),
                         [(0, 0, 0), (0.2, 0.1, 0.0)])
    targets = render_targets(scene, cams, cfg, seed=3, spp_per_call=2)
    wrong = dc.replace(scene,
                       albedo=scene.albedo.at[1].set(
                           jnp.array([0.3, 0.6, 0.7])))
    init_state, step_fn, _, _ = make_multiview_train_step_perview(
        wrong, cams, cfg, optax.adam(2e-2),
        trainable=("albedo",), train_camera="pose", edge_aware=True)

    straight = init_state()
    for _ in range(4):
        straight, _ = step_fn(straight, targets, KEY)

    half = init_state()
    for _ in range(2):
        half, _ = step_fn(half, targets, KEY)
    save_train_state(tmp_path / "ck", half)
    resumed = load_train_state(tmp_path / "ck", init_state())
    assert int(resumed.step) == 2
    for _ in range(2):
        resumed, _ = step_fn(resumed, targets, KEY)

    assert int(resumed.step) == int(straight.step) == 4
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)),
        straight.params, resumed.params)


def test_baselines_at_spec_flag():
    # The recorded config-5 JSON lines must be self-describing about spec
    # conformance (BASELINE configs[4]: 1080p multi-view): at_spec is true
    # only at the literal 1920x1080 with >= 2 views.
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "benchmarks"))
    from run_baselines import _at_spec
    assert _at_spec(1920, 1080, 4) is True
    assert _at_spec(1920, 1080, 2) is True
    assert _at_spec(1920, 1080, 1) is False    # single view is sub-spec
    assert _at_spec(518, 291, 2) is False      # reduced resolution
    assert _at_spec(960, 540, 4) is False


def test_edge_aware_clamps_samples_per_batch():
    # edge_aware needs per-sample pixel coordinates; the config CLAMPS
    # samples_per_batch to 1 (the reference clamps panel inputs rather
    # than throwing, RayTracerFboItem.cpp:189-228).
    cfg = RenderConfig(width=32, height=24, spp=4, samples_per_batch=4,
                       edge_aware=True)
    assert cfg.samples_per_batch == 1


@pytest.mark.slow
def test_dual_buffer_loss_trains_against_independent_targets():
    # The dual-buffer debiased loss (diff/inverse.dual_image_loss): two
    # fixed half-spp streams, product loss. Against INDEPENDENT
    # high-spp targets — the regime where fixed-key L2 develops a
    # noise-fit parameter floor — the dual loss must still drive the
    # trained errors down (the gradient never pairs a speckle with its
    # own stream's sensitivity). Convergence-to-floor comparisons are the
    # benchmark's job (run_baselines --loss dual); this pins the
    # machinery: finite loss (it CAN go negative transiently), shrinking
    # errors, and the loss plumbing through both step builders.
    cfg = RenderConfig(width=48, height=32, spp=2, max_depth=3, rng="hash",
                       nee=True, samples_per_batch=1)
    scene = _lit_scene()
    cams = orbit_cameras(_base_camera(cfg.aspect_ratio),
                         [(0, 0, 0), (0.3, 0.0, 0.0)])
    tcfg = dc.replace(cfg, spp=32)
    targets = render_targets(scene, cams, tcfg, seed=3, spp_per_call=8)
    wrong = dc.replace(
        scene,
        albedo=scene.albedo.at[1].set(jnp.array([0.2, 0.7, 0.7])),
        emission=scene.emission.at[2].set(jnp.array([5.0, 5.0, 5.0])))
    opt = optax.multi_transform(
        {"scene": optax.adam(4e-2), "emission": optax.adam(0.3)},
        {"scene": {"albedo": "scene", "emission": "emission"}})
    init_state, step_fn, rebuild_scene, _ = make_multiview_train_step(
        wrong, cams, cfg, opt, trainable=("albedo", "emission"),
        train_camera=False, loss="dual")
    state = init_state()
    for _ in range(40):
        state, loss = step_fn(state, targets, KEY)
    assert np.isfinite(float(loss))
    rec = rebuild_scene(state.params["scene"])
    alb0 = float(jnp.abs(wrong.albedo[1] - scene.albedo[1]).max())
    alb = float(jnp.abs(rec.albedo[1] - scene.albedo[1]).max())
    emi0 = float(jnp.abs(wrong.emission[2] - scene.emission[2]).max())
    emi = float(jnp.abs(rec.emission[2] - scene.emission[2]).max())
    assert alb < 0.6 * alb0, (alb0, alb)
    assert emi < 0.6 * emi0, (emi0, emi)
