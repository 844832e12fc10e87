"""Sphere closest-hit kernel (kernels/sphere_search.py) against the XLA
search: the kernel runs in the Pallas interpreter here; its compiled form is
checked on the card by the `gpu` test below and by chip_smoke.py.

Agreement rule (the same on the card): hit/miss agrees on >= 99.9% of rays,
the winner index agrees wherever both hit apart from exact ties, and where
the winners agree the refined t agrees to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qt_raytracer import RenderConfig, render_linear
from qt_raytracer.core.intersect import BIG, intersect_spheres, sphere_hit_ts
from qt_raytracer.core.render import pixel_grid
from qt_raytracer.core import camera as cam_mod
from qt_raytracer.kernels.sphere_search import sphere_search
from qt_raytracer.models import scenes

SCENES = ["three_sphere", "random", "glossy_dof", "four_sphere_gpu",
          "cornell"]


def scene_rays(name, n_random=256, seed=0):
    """Primary rays of a 32x24 image of the scene plus n_random rays from
    random points in the scene's bounds (bounce-like directions)."""
    scene, cam = scenes.get_scene(name, 4 / 3)
    cfg = RenderConfig(width=32, height=24)
    i, j, _ = pixel_grid(cfg)
    key = jax.random.PRNGKey(seed)
    u = jax.random.uniform(key, (i.shape[0], 4))
    o, d = cam_mod.get_rays(cam, (i + u[:, 0]) / 31, (j + u[:, 1]) / 23,
                            u[:, 2], u[:, 3])
    k1, k2 = jax.random.split(jax.random.fold_in(key, 1))
    c = scene.center[: int(np.asarray(scene.active).sum())]
    lo = jnp.maximum(c.min(0), -6.0)
    hi = jnp.minimum(c.max(0), 6.0)
    o2 = lo + (hi - lo) * jax.random.uniform(k1, (n_random, 3))
    d2 = jax.random.normal(k2, (n_random, 3))
    return scene, jnp.concatenate([o, o2]), jnp.concatenate([d, d2])


def assert_agrees(scene, o, d, t_k, i_k, ref, exclude=None):
    """The module's agreement rule, kernel (t_k, i_k) vs XLA Hits ref."""
    t_k, i_k = np.asarray(t_k), np.asarray(i_k)
    hit_k = t_k < BIG
    hit_x = np.asarray(ref.hit)
    assert (hit_k == hit_x).mean() >= 0.999
    both = hit_k & hit_x
    i_x = np.asarray(ref.prim_idx)
    differ = both & (i_k != i_x)
    if differ.any():
        # Only exact ties may pick another winner.
        ts = np.asarray(sphere_hit_ts(scene, o, d, 1e-3, BIG,
                                      exclude=exclude))
        rows = np.nonzero(differ)[0]
        np.testing.assert_allclose(ts[rows, i_k[rows]], ts[rows, i_x[rows]],
                                   rtol=1e-6)
    return both & ~differ


@pytest.mark.parametrize("mode", ["plain", "alive", "exclude"])
@pytest.mark.parametrize("name", SCENES)
def test_kernel_matches_xla_search(name, mode):
    scene, o, d = scene_rays(name)
    n = o.shape[0]
    alive = excl = None
    if mode == "alive":
        alive = jax.random.bernoulli(jax.random.PRNGKey(4), 0.5, (n,))
    if mode == "exclude":
        h0 = intersect_spheres(scene, o, d, 1e-3, backend="xla")
        excl = jnp.where(h0.hit & (jnp.arange(n) % 2 == 0), h0.prim_idx, -1)
    ref = intersect_spheres(scene, o, d, 1e-3, backend="xla", exclude=excl)
    t_k, i_k = sphere_search(scene, o, d, 1e-3, alive=alive, exclude=excl,
                             interpret=True)
    if mode == "alive":
        dead = ~np.asarray(alive)
        assert np.all(np.asarray(t_k)[dead] == BIG)
        assert np.all(np.asarray(i_k)[dead] == 0)
        live = ~dead
        same = assert_agrees(scene, o[live], d[live], np.asarray(t_k)[live],
                             np.asarray(i_k)[live],
                             jax.tree.map(lambda x: x[live], ref))
        assert same.sum() > 0
        return
    same = assert_agrees(scene, o, d, t_k, i_k, ref, exclude=excl)
    assert same.sum() > 0
    if mode == "exclude":
        hit_k = np.asarray(t_k) < BIG
        assert not np.any(hit_k & (np.asarray(i_k) == np.asarray(excl)))
    # Refined t through the full intersect_spheres path, where winners agree.
    h_k = intersect_spheres(scene, o, d, 1e-3, backend="pallas_interpret",
                            exclude=excl)
    np.testing.assert_allclose(np.asarray(h_k.t)[same],
                               np.asarray(ref.t)[same], rtol=1e-5)


@pytest.mark.parametrize("n_rays,name", [(333, "random"),
                                          (256, "glossy_dof")])
def test_kernel_pads_rays_and_spheres(n_rays, name):
    # N not a multiple of the ray block; unpadded glossy_dof has S = 5
    # slots, not a power of two.
    scene, _ = scenes.get_scene(name, 1.0, pad_to=None)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    o = jax.random.uniform(k1, (n_rays, 3), minval=-6.0, maxval=6.0)
    d = jax.random.normal(k2, (n_rays, 3))
    d = d.at[:, 1].set(-jnp.abs(d[:, 1]))     # downward: most rays hit
    ref = intersect_spheres(scene, o, d, 1e-3, backend="xla")
    t_k, i_k = sphere_search(scene, o, d, 1e-3, interpret=True)
    assert t_k.shape == (n_rays,) and i_k.shape == (n_rays,)
    assert i_k.dtype == jnp.int32
    same = assert_agrees(scene, o, d, t_k, i_k, ref)
    assert same.sum() > 0


@pytest.mark.parametrize("with_exclude", [False, True])
def test_kernel_lowers_for_cuda(with_exclude):
    # Lowering to Triton IR needs no GPU; this catches primitives the
    # Triton route refuses before a chip run does.
    scene, o, d = scene_rays("random", n_random=0)
    excl = jnp.full((o.shape[0],), -1, jnp.int32) if with_exclude else None

    def f(scene, o, d, alive):
        return sphere_search(scene, o, d, 1e-3, alive=alive, exclude=excl)

    alive = jnp.ones((o.shape[0],), bool)
    text = jax.jit(f).trace(scene, o, d, alive).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "sphere_search" in text


def test_kernel_render_matches_xla_render():
    cfg_x = RenderConfig(width=16, height=12, spp=2, max_depth=4,
                         intersector="xla")
    cfg_k = RenderConfig(width=16, height=12, spp=2, max_depth=4,
                         intersector="pallas_interpret")
    scene, cam = scenes.get_scene("three_sphere", cfg_x.aspect_ratio)
    key = jax.random.PRNGKey(0)
    a = np.asarray(render_linear(scene, cam, cfg_x, key))
    b = np.asarray(render_linear(scene, cam, cfg_k, key))
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


def test_kernel_path_gradients_equal_xla_path():
    # Kernel outputs are detached; gradients flow through the XLA
    # refinement, so they equal the xla path's wherever selections agree.
    import dataclasses

    scene, cam = scenes.get_scene("three_sphere", 1.0)
    key = jax.random.PRNGKey(0)

    def grads(intersector):
        cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2,
                           intersector=intersector)

        def loss(albedo):
            sc = dataclasses.replace(scene, albedo=albedo)
            return jnp.mean(render_linear(sc, cam, cfg, key))

        return np.asarray(jax.grad(loss)(scene.albedo))

    g_k, g_x = grads("pallas_interpret"), grads("xla")
    assert np.isfinite(g_k).all() and np.abs(g_k).max() > 0
    np.testing.assert_allclose(g_k, g_x, rtol=1e-4, atol=1e-7)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu):
    # 1080p primary rays of the book-cover scene, compiled for the card.
    scene, cam = scenes.get_scene("random", 16 / 9)
    cfg = RenderConfig(width=1920, height=1080)
    i, j, _ = pixel_grid(cfg)
    o, d = cam_mod.get_rays(cam, i / 1919, j / 1079, i * 0 + 0.5,
                            j * 0 + 0.5)
    o, d, scene = jax.device_put((o, d, scene), gpu)
    ref = intersect_spheres(scene, o, d, 1e-3, backend="xla")
    t_k, i_k = sphere_search(scene, o, d, 1e-3)
    same = assert_agrees(scene, o, d, t_k, i_k, ref)
    h_k = intersect_spheres(scene, o, d, 1e-3, backend="pallas")
    np.testing.assert_allclose(np.asarray(h_k.t)[same],
                               np.asarray(ref.t)[same], rtol=1e-5)
