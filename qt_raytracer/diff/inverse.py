"""Differentiable/inverse rendering.

No reference counterpart (the reference is forward-only; SURVEY.md §2.6) —
this is the north-star extension: the renderer is differentiable w.r.t.
material albedo, emitter radiance and camera parameters, so scenes can be
*recovered* from images by gradient descent.

Gradient estimator: detached-decision pathwise ("reparameterized") gradients —
all sampling decisions (which bounce branch, reflect-vs-refract, hit
structure via argmin) are functions of counter-based uniforms and are held
fixed; derivatives flow through the continuous transport factors
(attenuations, normals, hit points, camera rays). This matches finite
differences of the same fixed-key render exactly, and is unbiased for
interior (non-silhouette) pixels. Edge-aware visibility gradients are a later
extension (PAPERS.md reparameterization literature).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax

from ..core.config import RenderConfig
from ..core.render import render_linear
from ..core.scene import SphereScene
from ..parallel.sharding import render_linear_sharded

# Scene fields exposed to the optimizer by default.
DEFAULT_TRAINABLE = ("albedo", "emission")


def split_scene(scene: SphereScene, trainable=DEFAULT_TRAINABLE):
    """Partition a scene into (params dict, rebuild closure)."""
    params = {name: getattr(scene, name) for name in trainable}

    def rebuild(p):
        return dataclasses.replace(scene, **p)

    return params, rebuild


def mean_image(scene, camera, cfg: RenderConfig, key, mesh=None):
    """Per-sample mean linear radiance image — the differentiable target."""
    if mesh is None:
        acc = render_linear(scene, camera, cfg, key)
    else:
        acc = render_linear_sharded(scene, camera, cfg, key, mesh)
    return acc / cfg.spp


def image_loss(scene, camera, cfg: RenderConfig, key, target, mesh=None):
    """L2 loss in linear radiance space against a target image [H,W,3]."""
    img = mean_image(scene, camera, cfg, key, mesh)
    return jnp.mean((img - target) ** 2)


def dual_image_loss(scene, camera, cfg: RenderConfig, key, target,
                    mesh=None):
    """Dual-buffer DEBIASED image loss (the two-stream product form used
    by differentiable renderers to de-bias stochastic L2; cf. the
    sample-splitting estimator in the inverse-rendering literature).

    Plain fixed-key L2 has a noise-fit floor: d||r - t||^2 = 2 (r - t)·dr
    self-correlates the render's speckle with its own sensitivity, so the
    optimizer compensates the FIXED residual speckle with parameter bias —
    measured on config 5 at 1080p spp 2: albedo stalls at ~0.138 from
    step ~100 while loss keeps descending (round-5 ledger; round 4's
    'step-count-limited' attribution is REFUTED by the longer horizon).
    Rendering TWO fixed half-spp streams A/B on disjoint fold_in branches
    and minimizing mean((rA - t) * (rB - t)) keeps the same compute and
    the same expectation, but the gradient (rA-t)·drB + (rB-t)·drA never
    pairs a speckle with its own stream's sensitivity — the noise-fit
    term vanishes identically instead of as 1/spp.
    """
    half = dataclasses.replace(cfg, spp=max(cfg.spp // 2, 1))
    ra = mean_image(scene, camera, half, jax.random.fold_in(key, 101), mesh)
    rb = mean_image(scene, camera, half, jax.random.fold_in(key, 202), mesh)
    return jnp.mean((ra - target) * (rb - target))


class TrainState(NamedTuple):
    params: Any            # dict of trainable scene fields (+ optional camera)
    opt_state: Any
    step: jnp.ndarray


def save_train_state(path, state: TrainState) -> None:
    """Checkpoint the FULL optimization state (params + optimizer moments +
    step) to one .npz file, so long inverse renders are restartable exactly
    like progressive renders (SURVEY.md §5 checkpoint row: "render
    accumulator ... and inverse-rendering optimizer state")."""
    from ..runtime.checkpoint import save_pytree

    save_pytree(path, state)


def load_train_state(path, template: TrainState) -> TrainState:
    """Restore a TrainState saved by save_train_state. ``template`` (e.g. a
    fresh ``init_state()``) supplies the pytree structure — the optimizer
    and trainable set must match the saved run."""
    from ..runtime.checkpoint import load_pytree

    return load_pytree(path, template)


def make_train_step(
    scene: SphereScene,
    camera,
    cfg: RenderConfig,
    optimizer: optax.GradientTransformation,
    trainable=DEFAULT_TRAINABLE,
    train_camera: bool = False,
    mesh=None,
    edge_aware: bool = False,
    loss: str = "l2",
):
    """Build (init_state, step_fn) for inverse rendering.

    loss: "l2" (default) or "dual" (dual-buffer debiased product loss —
    see dual_image_loss; removes the fixed-key noise-fit floor).

    step_fn(state, target, key) -> (state, loss): one SGD step on the
    trainable scene fields (and optionally every camera field). With a mesh,
    the forward/backward shards over ("sp","px") and shard_map's transpose
    psums the parameter gradients across devices automatically.

    edge_aware: include silhouette (visibility) gradients via the
    screen-space boundary term (diff/edge.py) — required for reliable
    camera/geometry recovery; ~2x trace cost.
    """
    if edge_aware and not cfg.edge_aware:
        cfg = dataclasses.replace(cfg, edge_aware=True)
    scene_params, rebuild_scene = split_scene(scene, trainable)
    params = {"scene": scene_params}
    if train_camera == "pose":
        # Gauge-free pose parameterization: a single [3] world-space camera
        # translation, applied to origin AND lower_left_corner together (a
        # rigid translation of the whole camera — the perturbation class of
        # BASELINE config 5). Optimizing the raw Camera pytree instead is
        # overparameterized: origin and lower_left_corner can compensate
        # each other, so the image converges while the pose does not.
        params["camera"] = {"translate": jnp.zeros(3, jnp.float32)}
    elif train_camera:
        params["camera"] = camera

    def rebuild_camera(p):
        cp = p.get("camera")
        if cp is None:
            return camera
        if isinstance(cp, dict):
            t = cp["translate"]
            return dataclasses.replace(
                camera, origin=camera.origin + t,
                lower_left_corner=camera.lower_left_corner + t)
        return cp

    loss_impl = image_loss if loss == "l2" else dual_image_loss

    def loss_fn(p, target, key):
        sc = rebuild_scene(p["scene"])
        cam = rebuild_camera(p)
        return loss_impl(sc, cam, cfg, key, target, mesh)

    def init_state():
        return TrainState(params=params, opt_state=optimizer.init(params),
                          step=jnp.zeros((), jnp.int32))

    @jax.jit
    def step_fn(state: TrainState, target, key):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, target, key)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        new_params = optax.apply_updates(state.params, updates)
        # Keep physical ranges: albedo in [0,1], emission >= 0.
        if "albedo" in new_params["scene"]:
            new_params["scene"]["albedo"] = jnp.clip(
                new_params["scene"]["albedo"], 0.0, 1.0)
        if "emission" in new_params["scene"]:
            new_params["scene"]["emission"] = jnp.maximum(
                new_params["scene"]["emission"], 0.0)
        return TrainState(new_params, opt_state, state.step + 1), loss

    return init_state, step_fn, rebuild_scene, rebuild_camera
