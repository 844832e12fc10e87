"""NEE shadow-edge boundary term.

Isolation scene: the camera sees ONLY a lambertian floor; the occluder
hangs above/behind the camera and the emissive quad light is far overhead
— neither is in frame, so primary silhouettes contribute NOTHING and the
full FD gradient of the loss under occluder translation is carried by the
SHADOW sweeping across the floor. Plain pathwise and the silhouette-only
edge estimator are both exactly 0 here; the first-vertex shadow term
(diff/edge.py) must carry the whole signal.

Measured (CPU f32, 48x48, spp 64, eps 4e-2): fd +0.00439,
edge+shadow +0.00408 (93%), edge-without-shadow +0.00000, plain +0.00000.
"""

import dataclasses as dc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qt_raytracer import RenderConfig
from qt_raytracer.accel.mesh import MeshBuilder
from qt_raytracer.core.camera import make_camera
from qt_raytracer.core.scene import SceneBuilder
from qt_raytracer.core.world import World
from qt_raytracer.diff.inverse import mean_image

KEY = jax.random.PRNGKey(0)
BASE_DX = 0.15


def shadow_world(dx: float = 0.0):
    m = MeshBuilder()
    m.add_quad((-3.0, 0.0, -3.0), (6.0, 0.0, 0.0), (0.0, 0.0, 6.0),
               albedo=(0.8, 0.8, 0.8))                     # floor (visible)
    m.add_quad((-0.5 + dx, 4.0, -0.5), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0),
               albedo=(0.5, 0.5, 0.5))                     # occluder (above cam)
    m.add_quad((-1.0, 8.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0),
               mat_type=3, albedo=(0.0, 0.0, 0.0),
               emission=(12.0, 12.0, 12.0))                # light (out of frame)
    b = SceneBuilder()
    b.lambertian((0.0, -500.0, 0.0), 1.0, (0.5, 0.5, 0.5))
    return World(spheres=b.build(pad_to=8), mesh=m.build())


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    jax.clear_caches()     # same LLVM compile-cache pressure fix as the
    yield                  # mesh edge-gradient module


@pytest.mark.slow
def test_shadow_edge_carries_occluder_gradient():
    cfg = RenderConfig(width=48, height=48, spp=64, max_depth=1, nee=True)
    cfg_edge = dc.replace(cfg, edge_aware=True)
    cam = make_camera(lookfrom=(0, 3, 0), lookat=(0, 0, 0.01),
                      vup=(0, 0, 1), vfov=45.0, aspect_ratio=1.0,
                      aperture=0.0, focus_dist=3.0)
    target = mean_image(shadow_world(), cam, cfg, KEY)

    def loss(dx, c):
        w = shadow_world()
        mesh = w.mesh
        nt = mesh.num_triangles
        sel = ((jnp.arange(nt) >= 2) & (jnp.arange(nt) < 4))[:, None]
        mesh = dc.replace(
            mesh, v0=mesh.v0 + sel * jnp.array([BASE_DX + dx, 0.0, 0.0]))
        img = mean_image(dc.replace(w, mesh=mesh), cam, c, KEY)
        return jnp.mean((img - target) ** 2)

    def loss_fd(dx):
        img = mean_image(shadow_world(BASE_DX + dx), cam, cfg, KEY)
        return jnp.mean((img - target) ** 2)

    eps = 4e-2
    fd = (float(loss_fd(eps)) - float(loss_fd(-eps))) / (2 * eps)
    g_plain = float(jax.grad(lambda d: loss(d, cfg))(0.0))
    g_edge = float(jax.grad(lambda d: loss(d, cfg_edge))(0.0))
    os.environ["QTRT_EDGE_SHADOW"] = "0"
    jax.clear_caches()
    try:
        g_noshadow = float(jax.grad(lambda d: loss(d, cfg_edge))(0.0))
    finally:
        os.environ.pop("QTRT_EDGE_SHADOW", None)
        jax.clear_caches()

    assert abs(fd) > 1e-3, fd                 # the loss really sees the shadow
    assert abs(g_plain) < 0.05 * abs(fd)      # pathwise drops it entirely
    assert abs(g_noshadow) < 0.05 * abs(fd)   # silhouette-only term: nothing
    assert np.sign(g_edge) == np.sign(fd)
    np.testing.assert_allclose(g_edge, fd, rtol=0.3)


def test_shadow_edge_is_primal_zero():
    # Forward images bitwise unchanged by the shadow term.
    cfg = RenderConfig(width=32, height=32, spp=4, max_depth=2, nee=True)
    cfg_edge = dc.replace(cfg, edge_aware=True)
    cam = make_camera(lookfrom=(0, 3, 0), lookat=(0, 0, 0.01),
                      vup=(0, 0, 1), vfov=45.0, aspect_ratio=1.0,
                      aperture=0.0, focus_dist=3.0)
    w = shadow_world(0.1)
    a = np.asarray(mean_image(w, cam, cfg, KEY))
    b = np.asarray(mean_image(w, cam, cfg_edge, KEY))
    np.testing.assert_array_equal(a, b)


def sphere_shadow_scene(dx: float = 0.0):
    """All-sphere analog of shadow_world: visible floor sphere; sphere
    occluder above the camera; emissive sphere light overhead. Neither
    occluder nor light is in frame, so the shadow sweep carries the whole
    FD gradient (as in the mesh case)."""
    b = SceneBuilder()
    b.lambertian((0.0, -500.5, 0.0), 500.0, (0.8, 0.8, 0.8))   # floor
    b.lambertian((dx, 4.0, 0.0), 0.5, (0.5, 0.5, 0.5))         # occluder
    b.emissive((0.0, 8.0, 0.0), 1.0, (12.0, 12.0, 12.0))       # light
    return b.build(pad_to=8)


@pytest.mark.slow
def test_shadow_edge_sphere_scene_kernel_path():
    # The shadow term on a pure sphere scene with the sphere kernel doing
    # every selection (bounce-0 winner, shadow ray, background re-trace),
    # through the interpreter on the CPU; same isolation methodology as the
    # mesh test above.
    import dataclasses

    cfg = RenderConfig(width=48, height=48, spp=64, max_depth=1, nee=True,
                       intersector="pallas_interpret")
    cfg_edge = dc.replace(cfg, edge_aware=True)
    cam = make_camera(lookfrom=(0, 3, 0), lookat=(0, 0, 0.01),
                      vup=(0, 0, 1), vfov=45.0, aspect_ratio=1.0,
                      aperture=0.0, focus_dist=3.0)
    target = mean_image(sphere_shadow_scene(), cam, cfg, KEY)

    def loss(dx, c):
        sc = sphere_shadow_scene()
        sc = dataclasses.replace(
            sc, center=sc.center.at[1].add(
                jnp.array([BASE_DX, 0.0, 0.0]) + dx * jnp.array([1.0, 0, 0])))
        img = mean_image(sc, cam, c, KEY)
        return jnp.mean((img - target) ** 2)

    def loss_fd(dx):
        img = mean_image(sphere_shadow_scene(BASE_DX + dx), cam, cfg, KEY)
        return jnp.mean((img - target) ** 2)

    eps = 4e-2
    fd = (float(loss_fd(eps)) - float(loss_fd(-eps))) / (2 * eps)
    g_plain = float(jax.grad(lambda d: loss(d, cfg))(0.0))
    g_edge = float(jax.grad(lambda d: loss(d, cfg_edge))(0.0))

    assert abs(fd) > 1e-4, fd                 # the loss really sees the shadow
    assert abs(g_plain) < 0.05 * abs(fd), (g_plain, fd)
    assert np.sign(g_edge) == np.sign(fd), (g_edge, fd)
    np.testing.assert_allclose(g_edge, fd, rtol=0.35)
