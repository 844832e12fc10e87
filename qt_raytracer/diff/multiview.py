"""Multi-view inverse rendering: BASELINE config 5 at its actual spec.

The spec (BASELINE.json configs[4]): recover albedo / EMITTER radiance /
CAMERA pose by gradient descent on high-resolution MULTI-VIEW renders,
sharded over the device mesh. This module assembles the ingredients that
already exist — the differentiable integrator with kernel selection and
XLA re-derives, edge-aware silhouette gradients (diff/edge.py), the
gauge-free pose parameterization (diff/inverse.py), and (sp, px) shard_map
sharding — into one joint optimization over M cameras of a single scene.

Design notes:
  - The M per-view renders run as ONE lax.scan over the view axis inside a
    single jitted step: camera pytrees are stacked into [M, ...] leaves and
    the body renders/losses one view, so the view trace is COMPILED ONCE
    regardless of M (the unrolled form compiles M copies of the full render
    graph); gradients of the shared scene parameters accumulate across scan
    iterations automatically by autodiff.
  - Per-view camera pose uses the same rigid-translation parameterization as
    make_train_step(train_camera="pose"): a [M, 3] translate table applied
    to origin AND lower_left_corner — gauge-free (no origin/corner
    compensation drift).
  - Targets are rendered progressively (render_targets): spp accumulates in
    batches of bounded device-call size; the accumulated mean equals a
    batch render at equal spp/key (the ProgressiveRenderer invariant,
    tested in tests/test_app.py).

No reference counterpart (the reference is forward-only; SURVEY.md north-star
extension).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import optax

from ..core.config import RenderConfig
from ..core.render import render_sample_batch
from .inverse import (DEFAULT_TRAINABLE, TrainState, dual_image_loss,
                      image_loss, split_scene)


def translate_camera(camera, t):
    """Rigid world-space translation of a thin-lens camera (pose class of
    BASELINE config 5): origin and lower_left_corner move together, the
    basis (horizontal/vertical/u/v/w) is unchanged."""
    return dataclasses.replace(
        camera, origin=camera.origin + t,
        lower_left_corner=camera.lower_left_corner + t)


def render_targets(scene, cameras: Sequence[Any], cfg: RenderConfig, seed: int,
                   spp_per_call: int = 8):
    """Ground-truth mean-radiance targets [M, H, W, 3], rendered
    progressively in batches of spp_per_call samples per device call.

    Equal to mean_image at the same spp/seed (progressive == batch
    invariant); per-view RNG decorrelates by seed offset."""
    targets = []
    for v, cam in enumerate(cameras):
        key = jax.random.PRNGKey(seed + 1000 * v)
        acc = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
        done = 0
        while done < cfg.spp:
            n = min(spp_per_call, cfg.spp - done)
            acc = acc + render_sample_batch(scene, cam, cfg, key,
                                            jnp.int32(done), n)
            done += n
        targets.append(acc / cfg.spp)
    return jnp.stack(targets)


def make_multiview_train_step(
    scene,
    cameras: Sequence[Any],
    cfg: RenderConfig,
    optimizer: optax.GradientTransformation,
    trainable=DEFAULT_TRAINABLE,
    train_camera: bool | str = "pose",
    mesh=None,
    edge_aware: bool = False,
    loss: str = "l2",
):
    """Build (init_state, step_fn, rebuild_scene, rebuild_cameras) for joint
    multi-view recovery of scene fields + per-view camera poses.

    loss: "l2" (fixed-key L2) or "dual" (dual-buffer debiased product loss,
    diff/inverse.dual_image_loss — removes the fixed-key noise-fit floor
    at equal compute; spp is split across the two streams).

    step_fn(state, targets [M,H,W,3], key) -> (state, loss): one step on the
    joint params {"scene": {...}, "camera": {"translate": [M,3]}}. Scene
    gradients sum over views (shared parameters); pose gradients are
    per-view. With a device mesh, every view's forward/backward shards over
    ("sp", "px") and shard_map's transpose psums parameter gradients across
    devices.
    """
    if edge_aware and not cfg.edge_aware:
        cfg = dataclasses.replace(cfg, edge_aware=True)
    cameras = tuple(cameras)
    m = len(cameras)
    scene_params, rebuild_scene = split_scene(scene, trainable)
    params = {"scene": scene_params}
    if train_camera == "pose":
        params["camera"] = {"translate": jnp.zeros((m, 3), jnp.float32)}
    elif train_camera:
        raise ValueError("multiview supports train_camera='pose' or False")

    def rebuild_cameras(p):
        cp = p.get("camera")
        if cp is None:
            return cameras
        return tuple(translate_camera(cam, cp["translate"][v])
                     for v, cam in enumerate(cameras))

    # Stacked [M, ...] camera leaves: the scan body un-stacks one view per
    # iteration, so the render graph compiles once for any M. The body is
    # rematerialized (jax.checkpoint): without it the scan's backward saves
    # every view's per-bounce residuals simultaneously (measured OOM at
    # M=4 960x540 edge-aware: ~20 x 63.5 MB HLO temps); with it the
    # backward recomputes one view's forward at a time.
    cams_stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *cameras)

    loss_impl = image_loss if loss == "l2" else dual_image_loss

    @jax.checkpoint
    def view_loss(sc, cam_v, tgt_v, tr_v, v, key):
        cam = translate_camera(cam_v, tr_v)
        return loss_impl(sc, cam, cfg, jax.random.fold_in(key, v),
                         tgt_v, mesh)

    def loss_fn(p, targets, key):
        sc = rebuild_scene(p["scene"])
        cp = p.get("camera")
        tr = (cp["translate"] if cp is not None
              else jnp.zeros((m, 3), jnp.float32))

        def body(acc, xs):
            cam_v, tgt_v, tr_v, v = xs
            return acc + view_loss(sc, cam_v, tgt_v, tr_v, v, key), None

        total, _ = jax.lax.scan(
            body, jnp.float32(0.0),
            (cams_stacked, targets, tr, jnp.arange(m)))
        return total / m

    def init_state():
        return TrainState(params=params, opt_state=optimizer.init(params),
                          step=jnp.zeros((), jnp.int32))

    @jax.jit
    def step_fn(state: TrainState, targets, key):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, targets, key)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        new_params = optax.apply_updates(state.params, updates)
        if "albedo" in new_params["scene"]:
            new_params["scene"]["albedo"] = jnp.clip(
                new_params["scene"]["albedo"], 0.0, 1.0)
        if "emission" in new_params["scene"]:
            new_params["scene"]["emission"] = jnp.maximum(
                new_params["scene"]["emission"], 0.0)
        return TrainState(new_params, opt_state, state.step + 1), loss

    return init_state, step_fn, rebuild_scene, rebuild_cameras


def make_multiview_train_step_perview(
    scene,
    cameras: Sequence[Any],
    cfg: RenderConfig,
    optimizer: optax.GradientTransformation,
    trainable=DEFAULT_TRAINABLE,
    train_camera: bool | str = "pose",
    mesh=None,
    edge_aware: bool = False,
    loss: str = "l2",
):
    """Per-VIEW-device-call variant of make_multiview_train_step.

    Same estimator, same update, different execution shape: instead of one
    jitted step scanning all M views (one device call of M x view cost),
    step_fn issues one jitted value_and_grad call PER VIEW and accumulates
    gradients on device between calls, then a small jitted optimizer-update
    call. Each device call stays at single-view cost.

    Gradient equivalence with the scanned step: the scanned loss is
    (1/M) * sum_v loss_v, so d/dp = (1/M) * sum_v d(loss_v)/dp — exactly
    the mean of the per-view gradients accumulated here (the per-view
    translate rows are disjoint, scene grads sum over views). The view
    RNG (fold_in(key, v)) and remat structure match, so per-view renders
    are identical to the scanned body's.

    Returns (init_state, step_fn, rebuild_scene, rebuild_cameras) with the
    same step_fn(state, targets [M,H,W,3], key) signature.
    """
    if edge_aware and not cfg.edge_aware:
        cfg = dataclasses.replace(cfg, edge_aware=True)
    cameras = tuple(cameras)
    m = len(cameras)
    scene_params, rebuild_scene = split_scene(scene, trainable)
    params = {"scene": scene_params}
    if train_camera == "pose":
        params["camera"] = {"translate": jnp.zeros((m, 3), jnp.float32)}
    elif train_camera:
        raise ValueError("multiview supports train_camera='pose' or False")

    def rebuild_cameras(p):
        cp = p.get("camera")
        if cp is None:
            return cameras
        return tuple(translate_camera(cam, cp["translate"][v])
                     for v, cam in enumerate(cameras))

    cams_stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *cameras)

    loss_impl = image_loss if loss == "l2" else dual_image_loss

    @jax.jit
    def view_value_and_grad(p, cam_v, tgt_v, v, key):
        # v is a traced scalar: one compile covers every view.
        def lf(p):
            sc = rebuild_scene(p["scene"])
            cp = p.get("camera")
            tr_v = (cp["translate"][v] if cp is not None
                    else jnp.zeros(3, jnp.float32))
            cam = translate_camera(cam_v, tr_v)
            return loss_impl(sc, cam, cfg, jax.random.fold_in(key, v),
                             tgt_v, mesh)
        return jax.value_and_grad(lf)(p)

    @jax.jit
    def apply_update(state: TrainState, grads, loss):
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        new_params = optax.apply_updates(state.params, updates)
        if "albedo" in new_params["scene"]:
            new_params["scene"]["albedo"] = jnp.clip(
                new_params["scene"]["albedo"], 0.0, 1.0)
        if "emission" in new_params["scene"]:
            new_params["scene"]["emission"] = jnp.maximum(
                new_params["scene"]["emission"], 0.0)
        return TrainState(new_params, opt_state, state.step + 1), loss

    def init_state():
        return TrainState(params=params, opt_state=optimizer.init(params),
                          step=jnp.zeros((), jnp.int32))

    def step_fn(state: TrainState, targets, key):
        grads = None
        total = jnp.float32(0.0)
        for v in range(m):
            cam_v = jax.tree.map(lambda x: x[v], cams_stacked)
            loss_v, g = view_value_and_grad(state.params, cam_v, targets[v],
                                            jnp.int32(v), key)
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
            total = total + loss_v
        grads = jax.tree.map(lambda x: x / m, grads)
        return apply_update(state, grads, total / m)

    return init_state, step_fn, rebuild_scene, rebuild_cameras


def orbit_cameras(base_camera, offsets):
    """M camera rig: the base camera rigidly translated by each offset [3]
    (multi-view captures of one scene from nearby vantage points)."""
    return tuple(translate_camera(base_camera, jnp.asarray(o, jnp.float32))
                 for o in offsets)
