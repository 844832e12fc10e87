"""World (spheres + mesh) rendering: golden vs oracle, gradients, NEE
interaction with mesh occluders/emitters."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from qt_raytracer import RenderConfig, render_linear, SceneBuilder
from qt_raytracer.accel.mesh import build_mesh
from qt_raytracer.core.world import World
from qt_raytracer.models import meshes
from qt_raytracer.testing import oracle


def _small_world(emissive_mesh=False, light=False):
    verts, faces = meshes.icosphere(subdiv=1, radius=1.0, center=(0, 1.0, 0))
    mesh = build_mesh(
        verts, faces, mat_type=3 if emissive_mesh else 0,
        albedo=(0.7, 0.3, 0.2), emission=(6.0, 5.0, 4.0) if emissive_mesh
        else (0, 0, 0), builder="python")
    b = SceneBuilder()
    b.lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    b.metal((2.2, 1.0, -0.5), 1.0, (0.8, 0.8, 0.9), 0.0)
    if light:
        b.emissive((-2.0, 2.5, 1.0), 0.5, (12.0, 11.0, 10.0))
    return World(spheres=b.build(pad_to=None), mesh=mesh)


def test_mesh_world_matches_oracle():
    cfg = RenderConfig(width=12, height=8, spp=2, max_depth=4)
    world = _small_world()
    cam = meshes.icosphere_camera(cfg.aspect_ratio)
    key = jax.random.PRNGKey(0)
    got = np.asarray(render_linear(world, cam, cfg, key), np.float64) / cfg.spp
    want = oracle.render_oracle_linear(world, cam, cfg, key) / cfg.spp
    # f32-vs-f64 containment flips at shared triangle edges change a whole
    # sample path; tolerate a small fraction of affected channels.
    mismatch = np.abs(got - want) > (3e-3 + 3e-3 * np.abs(want))
    assert mismatch.mean() <= 0.02, mismatch.mean()


def test_mesh_world_nee_matches_oracle():
    # Mesh occluders + sphere light + NEE, all mirrored by the oracle.
    cfg = RenderConfig(width=12, height=8, spp=2, max_depth=4, nee=True)
    world = _small_world(light=True)
    cam = meshes.icosphere_camera(cfg.aspect_ratio)
    key = jax.random.PRNGKey(1)
    got = np.asarray(render_linear(world, cam, cfg, key), np.float64) / cfg.spp
    want = oracle.render_oracle_linear(world, cam, cfg, key) / cfg.spp
    mismatch = np.abs(got - want) > (4e-3 + 4e-3 * np.abs(want))
    # shadow rays grazing mesh silhouettes can flip occluded/lit between
    # f32 and f64 — one affected pixel-sample changes 3 channels
    assert mismatch.mean() <= 0.02, mismatch.mean()


def test_emissive_mesh_matches_oracle_with_nee():
    # Emissive mesh faces ARE in the unified light table (round 2): the
    # icosphere's 80 faces become 80 area lights, exercising many-triangle
    # light picking + per-face MIS weights against the oracle.
    cfg = RenderConfig(width=10, height=8, spp=2, max_depth=4, nee=True)
    world = _small_world(emissive_mesh=True)
    cam = meshes.icosphere_camera(cfg.aspect_ratio)
    key = jax.random.PRNGKey(2)
    got = np.asarray(render_linear(world, cam, cfg, key), np.float64) / cfg.spp
    want = oracle.render_oracle_linear(world, cam, cfg, key) / cfg.spp
    np.testing.assert_allclose(got, want, atol=4e-3, rtol=4e-3)


def test_mesh_gradients_flow():
    # Mesh albedo AND vertex positions are gradient targets.
    cfg = RenderConfig(width=10, height=8, spp=1, max_depth=3)
    world = _small_world()
    cam = meshes.icosphere_camera(cfg.aspect_ratio)
    key = jax.random.PRNGKey(0)

    def loss(albedo, v0):
        w2 = World(spheres=world.spheres,
                   mesh=dataclasses.replace(world.mesh, albedo=albedo, v0=v0))
        return jnp.mean(render_linear(w2, cam, cfg, key))

    ga, gv = jax.grad(loss, argnums=(0, 1))(world.mesh.albedo, world.mesh.v0)
    assert np.isfinite(np.asarray(ga)).all() and np.abs(np.asarray(ga)).max() > 0
    assert np.isfinite(np.asarray(gv)).all()


def test_bare_scene_still_works():
    # Public API: SphereScene without mesh remains valid (as_world wrap).
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2)
    scene = SceneBuilder().lambertian((0, 0, -3), 1.0, (0.5, 0.5, 0.5)).build()
    from qt_raytracer.core.camera import make_camera
    cam = make_camera((0, 0, 0), (0, 0, -3), vfov=40, aspect_ratio=1.0)
    img = np.asarray(render_linear(scene, cam, cfg, jax.random.PRNGKey(0)))
    assert np.isfinite(img).all()
