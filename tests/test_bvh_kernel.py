"""BVH triangle-search kernel (kernels/bvh_search.py) against brute force:
the kernel runs in the Pallas interpreter here; its compiled form is checked
on the card by the `gpu` test below and by chip_smoke.py.

Agreement rule: hit/miss agrees on every ray, the winning triangle agrees
wherever both hit apart from exact ties (shared edges), and t agrees to
rtol 1e-5 where the winners agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qt_raytracer import RenderConfig, build_mesh, render_linear
from qt_raytracer.accel.mesh import moller_trumbore
from qt_raytracer.accel.traverse import BIG, intersect_mesh
from qt_raytracer.kernels.bvh_search import bvh_search
from qt_raytracer.models import meshes, scenes

MESHES = ["cornell", "terrain48", "soup"]


def _mesh(name):
    if name == "cornell":
        return meshes.cornell_box_world(builder="python").mesh
    if name == "terrain48":
        return meshes.terrain_world(nx=48, nz=48, builder="python").mesh
    rng = np.random.default_rng(3)
    centers = rng.uniform(-1.0, 1.0, (300, 1, 3))
    verts = (centers + 0.15 * rng.normal(size=(300, 3, 3))).reshape(-1, 3)
    return build_mesh(verts, np.arange(900).reshape(300, 3),
                      builder="python")


def _rays(mesh, n=1024, seed=0):
    """Rays from around the mesh's bounds toward random points inside it."""
    lo = np.asarray(mesh.bvh_min[0])
    hi = np.asarray(mesh.bvh_max[0])
    rng = np.random.default_rng(seed)
    span = hi - lo
    o = lo - 0.25 * span + 1.5 * span * rng.random((n, 3))
    target = lo + span * rng.random((n, 3))
    d = target - o
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def _brute(mesh, o, d, cap=None, excl=None):
    """(t, idx) by brute force, with the kernel's cap/exclusion semantics."""
    t_max = BIG if cap is None else cap[:, None]
    ts = moller_trumbore(mesh.v0, mesh.e1, mesh.e2, o, d, 1e-3, t_max)
    if excl is not None:
        ts = jnp.where(jnp.arange(ts.shape[1])[None, :] == excl[:, None],
                       BIG, ts)
    idx = jnp.argmin(ts, axis=1)
    return np.asarray(ts), np.asarray(jnp.min(ts, axis=1)), np.asarray(idx)


def assert_agrees(ts, t_b, i_b, t_k, i_k):
    t_k, i_k = np.asarray(t_k), np.asarray(i_k)
    hit_k, hit_b = t_k < BIG, t_b < BIG
    np.testing.assert_array_equal(hit_k, hit_b)
    differ = hit_k & (i_k != i_b)
    rows = np.nonzero(differ)[0]
    # Another winner only at an exact tie (an edge shared by two faces).
    np.testing.assert_allclose(ts[rows, i_k[rows]], ts[rows, i_b[rows]],
                               rtol=1e-6)
    same = hit_k & ~differ
    np.testing.assert_allclose(t_k[same], t_b[same], rtol=1e-5)
    return same


@pytest.mark.parametrize("mode", ["plain", "alive", "exclude", "t_cap"])
@pytest.mark.parametrize("name", MESHES)
def test_kernel_matches_brute_force(name, mode):
    mesh = _mesh(name)
    o, d = _rays(mesh)
    n = o.shape[0]
    alive = excl = cap = None
    ts, t_b, i_b = _brute(mesh, o, d)
    if mode == "alive":
        alive = jnp.asarray(np.random.default_rng(1).random(n) < 0.5)
        t_b = np.where(np.asarray(alive), t_b, BIG)
    if mode == "exclude":
        excl = jnp.asarray(np.where((t_b < BIG) & (np.arange(n) % 2 == 0),
                                    i_b, -1), jnp.int32)
        ts, t_b, i_b = _brute(mesh, o, d, excl=excl)
    if mode == "t_cap":
        cap = jnp.asarray(np.where(np.arange(n) % 2 == 0,
                                   0.9 * np.minimum(t_b, 10.0), BIG),
                          jnp.float32)
        ts, t_b, i_b = _brute(mesh, o, d, cap=cap)
    t_k, i_k = bvh_search(mesh, o, d, 1e-3, alive=alive, exclude=excl,
                          t_cap=cap, interpret=True)
    same = assert_agrees(ts, t_b, i_b, t_k, i_k)
    assert same.sum() > 0
    if mode == "alive":
        dead = ~np.asarray(alive)
        assert np.all(np.asarray(t_k)[dead] == BIG)
        assert np.all(np.asarray(i_k)[dead] == 0)
    if mode == "exclude":
        assert not np.any((np.asarray(t_k) < BIG)
                          & (np.asarray(i_k) == np.asarray(excl)))


def test_kernel_matches_xla_traversal_on_padded_block():
    # N not a multiple of the ray block; same contract as intersect_mesh.
    mesh = _mesh("terrain48")
    o, d = _rays(mesh, n=333, seed=2)
    ref = intersect_mesh(mesh, o, d, 1e-3)
    t_k, i_k = bvh_search(mesh, o, d, 1e-3, interpret=True)
    assert t_k.shape == (333,) and i_k.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(t_k) < BIG, np.asarray(ref.hit))
    same = np.asarray(ref.hit) & (np.asarray(i_k) == np.asarray(ref.tri_idx))
    assert same.mean() > 0.9 * np.asarray(ref.hit).mean()
    np.testing.assert_allclose(np.asarray(t_k)[same],
                               np.asarray(ref.t)[same], rtol=1e-5)


@pytest.mark.parametrize("with_exclude", [False, True])
def test_kernel_lowers_for_cuda(with_exclude):
    # Lowering to Triton IR needs no GPU (see test_sphere_kernel.py).
    mesh = _mesh("cornell")
    o, d = _rays(mesh, n=256)
    excl = jnp.full((256,), -1, jnp.int32) if with_exclude else None

    def f(mesh, o, d, alive, cap):
        return bvh_search(mesh, o, d, 1e-3, alive=alive, exclude=excl,
                          t_cap=cap)

    text = jax.jit(f).trace(mesh, o, d, jnp.ones((256,), bool),
                            jnp.full((256,), BIG)).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "bvh_search" in text


def test_kernel_mesh_render_and_gradients_match_xla():
    # Mesh-world render and vertex gradients through the kernel equal the
    # xla traversal's (selection only differs at exact ties).
    import dataclasses

    world, cam = scenes.get_scene("cornell_mesh", 1.0)
    key = jax.random.PRNGKey(0)

    def run(intersector):
        cfg = RenderConfig(width=12, height=12, spp=1, max_depth=2, nee=True,
                           intersector=intersector)

        def loss(v0):
            w = dataclasses.replace(
                world, mesh=dataclasses.replace(world.mesh, v0=v0))
            return jnp.mean(render_linear(w, cam, cfg, key))

        val, g = jax.value_and_grad(loss)(world.mesh.v0)
        return float(val), np.asarray(g)

    (v_k, g_k), (v_x, g_x) = run("pallas_interpret"), run("xla")
    assert np.isfinite(g_k).all() and np.abs(g_k).max() > 0
    np.testing.assert_allclose(v_k, v_x, rtol=1e-5)
    np.testing.assert_allclose(g_k, g_x, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
def test_compiled_kernel_matches_traversal_on_gpu(gpu):
    # 1080p primary rays of the 100k-triangle terrain, compiled for the card.
    from qt_raytracer.core import camera as cam_mod
    from qt_raytracer.core.render import pixel_grid

    world = meshes.terrain_world()
    cfg = RenderConfig(width=1920, height=1080)
    cam = meshes.terrain_camera(cfg.aspect_ratio)
    i, j, _ = pixel_grid(cfg)
    o, d = cam_mod.get_rays(cam, i / 1919, j / 1079, i * 0 + 0.5,
                            j * 0 + 0.5)
    o, d, mesh = jax.device_put((o, d, world.mesh), gpu)
    ref = intersect_mesh(mesh, o, d, 1e-3)
    t_k, i_k = bvh_search(mesh, o, d, 1e-3)
    hit_k, hit_x = np.asarray(t_k) < BIG, np.asarray(ref.hit)
    assert (hit_k == hit_x).mean() >= 0.999
    same = hit_k & hit_x & (np.asarray(i_k) == np.asarray(ref.tri_idx))
    assert same.sum() >= 0.999 * (hit_k & hit_x).sum()
    np.testing.assert_allclose(np.asarray(t_k)[same],
                               np.asarray(ref.t)[same], rtol=1e-5)
