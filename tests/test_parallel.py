"""Multi-device sharding tests on the virtual 8-device CPU mesh
(SURVEY.md §4: multi-node-without-a-cluster via
--xla_force_host_platform_device_count=8, set in conftest.py)."""

import jax
import numpy as np
import pytest

from qt_raytracer import RenderConfig, render_linear
from qt_raytracer.models import scenes
from qt_raytracer.parallel.sharding import make_mesh, render_linear_sharded


@pytest.fixture(scope="module")
def setup():
    cfg = RenderConfig(width=16, height=12, spp=4, max_depth=4)
    scene, cam = scenes.get_scene("three_sphere", cfg.aspect_ratio)
    key = jax.random.PRNGKey(0)
    ref = np.asarray(render_linear(scene, cam, cfg, key))
    return cfg, scene, cam, key, ref


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("sp,px", [(1, 8), (2, 4), (4, 2), (4, 1), (1, 1)])
def test_sharded_render_matches_single_device(setup, sp, px):
    # Mesh-shape invariance from the counter-based RNG: every sample is
    # keyed on GLOBAL (pixel, sample) ids, so pixel-partitioning ("px") is
    # BITWISE invariant — asserted exactly. Sample-partitioning ("sp")
    # reassociates the per-pixel spp sum ((s0+s1)+(s2+s3) vs sequential),
    # which moves results by <= a few ulps; asserted to 1-ulp-scale tol.
    cfg, scene, cam, key, ref = setup
    devices = jax.devices()[: sp * px]
    mesh = make_mesh(sp=sp, px=px, devices=devices)
    img = np.asarray(render_linear_sharded(scene, cam, cfg, key, mesh))
    if sp == 1:
        np.testing.assert_array_equal(img, ref)
    else:
        np.testing.assert_allclose(img, ref, rtol=3e-7, atol=3e-7)


def test_nondivisible_pixels_padded(setup):
    # 16x12 = 192 pixels over px=5 devices does not divide; padding must be
    # sliced off invisibly.
    cfg, scene, cam, key, ref = setup
    mesh = make_mesh(sp=1, px=5, devices=jax.devices()[:5])
    img = np.asarray(render_linear_sharded(scene, cam, cfg, key, mesh))
    # Not asserted bitwise: the ragged 39-pixel shard width changes CPU
    # autovectorization (measured: 1-ulp flips on 2/192 pixels), unlike the
    # divisible px shardings above which ARE exact.
    np.testing.assert_allclose(img, ref, rtol=3e-7, atol=3e-7)


def test_sharded_mesh_world_matches_single_device():
    # World with triangle mesh through shard_map (BVH while-loop traversal
    # inside the sharded region).
    from qt_raytracer.models import meshes
    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=3)
    world = meshes.icosphere_world(subdiv=1, builder="python")
    cam = meshes.icosphere_camera(cfg.aspect_ratio)
    key = jax.random.PRNGKey(0)
    ref = np.asarray(render_linear(world, cam, cfg, key))
    mesh = make_mesh(sp=2, px=4)
    img = np.asarray(render_linear_sharded(world, cam, cfg, key, mesh))
    np.testing.assert_allclose(img, ref, atol=1e-5, rtol=1e-5)


def test_distributed_helpers_single_process():
    from qt_raytracer.parallel import distributed
    # Single-process: global_mesh spans the 8 virtual devices; gather is a
    # no-op passthrough; coordinator is process 0.
    mesh = distributed.global_mesh(sp=1)
    assert mesh.shape["px"] == len(jax.devices())
    assert distributed.is_coordinator()
    x = jax.numpy.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(distributed.gather_image(x), np.asarray(x))


def test_spp_not_divisible_raises(setup):
    cfg, scene, cam, key, _ = setup
    mesh = make_mesh(sp=3, px=1, devices=jax.devices()[:3])
    with pytest.raises(ValueError, match="not divisible"):
        render_linear_sharded(scene, cam, cfg, key, mesh)


def test_sharded_terrain_world_px_bitwise():
    # The ACTUAL config-4 terrain world (100k tris, real cluster counts)
    # through render_linear_sharded: px-sharding must be BITWISE invariant
    # on the mesh path too (the reference's tile-pool decomposition being
    # subsumed, RayTracerFboItem.cpp:72-89).
    from qt_raytracer.models import meshes
    cfg = RenderConfig(width=96, height=54, spp=2, max_depth=3, rng="hash")
    world = meshes.terrain_world()
    cam = meshes.terrain_camera(cfg.aspect_ratio)
    key = jax.random.PRNGKey(0)
    ref = np.asarray(render_linear(world, cam, cfg, key))
    mesh = make_mesh(sp=1, px=8)
    img = np.asarray(render_linear_sharded(world, cam, cfg, key, mesh))
    np.testing.assert_array_equal(img, ref)


@pytest.mark.parametrize("what", ["render", "train_step"])
@pytest.mark.parametrize("scene_name", ["three_sphere", "cornell_mesh"])
def test_sharded_kernel_path_lowers_for_cuda(monkeypatch, scene_name, what):
    # The compiled kernels under shard_map: their outputs must carry the
    # mesh axes the rays vary over, or tracing fails on a multi-GPU mesh.
    # Lowering to Triton IR needs no GPU (the interpreter cannot run
    # there: it evaluates the kernel with mixed varying/invariant values).
    import dataclasses

    import optax

    from qt_raytracer.diff.inverse import make_train_step

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=2, nee=True,
                       rng="hash", intersector="pallas")
    scene, cam = scenes.get_scene(scene_name, cfg.aspect_ratio)
    mesh = make_mesh(sp=2, px=2, devices=jax.devices()[:4])
    key = jax.random.PRNGKey(0)
    if what == "render":
        fn = jax.jit(lambda s, c, k: render_linear_sharded(s, c, cfg, k,
                                                           mesh))
        args = (scene, cam, key)
    else:
        init_state, step_fn, _, _ = make_train_step(
            scene, cam, dataclasses.replace(cfg, edge_aware=True),
            optax.adam(1e-2), trainable=(), train_camera="pose",
            edge_aware=True, mesh=mesh)
        target = jax.numpy.zeros((cfg.height, cfg.width, 3))
        fn, args = step_fn, (init_state(), target, key)
    text = fn.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    kernel = "bvh_search" if scene_name == "cornell_mesh" else "sphere_search"
    assert kernel in text
