"""BVH build + triangle mesh intersection: structural invariants, traversal
vs brute force, and the reference's BVH test family (BvhTests.cpp:12-62
semantics: union box, nearest hit, miss, empty-throws)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qt_raytracer.accel.bvh import build_bvh, validate_bvh
from qt_raytracer.accel.mesh import build_mesh
from qt_raytracer.accel.traverse import (intersect_mesh,
                                             intersect_mesh_brute)


def _random_tris(f, seed=0, spread=5.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (f, 1, 3))
    tri = base + rng.uniform(-0.4, 0.4, (f, 3, 3))
    verts = tri.reshape(-1, 3)
    faces = np.arange(3 * f).reshape(f, 3)
    return verts, faces


def test_bvh_build_invariants():
    rng = np.random.default_rng(1)
    lo = rng.uniform(-10, 10, (257, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.01, 2.0, (257, 3)).astype(np.float32)
    bvh = build_bvh(lo, hi, max_leaf=4)
    validate_bvh(bvh, lo, hi)
    # Root box is the union of all (BvhTests: union box property).
    np.testing.assert_allclose(bvh.bbox_min[0], lo.min(0), atol=1e-6)
    np.testing.assert_allclose(bvh.bbox_max[0], hi.max(0), atol=1e-6)


def test_bvh_empty_raises():
    with pytest.raises(ValueError):  # RayTracer.h:399 empty-range throw
        build_bvh(np.zeros((0, 3)), np.zeros((0, 3)))


def test_bvh_single_primitive():
    lo = np.array([[0.0, 0.0, 0.0]], np.float32)
    hi = np.array([[1.0, 1.0, 1.0]], np.float32)
    bvh = build_bvh(lo, hi)
    validate_bvh(bvh, lo, hi)


def test_traversal_matches_brute_force():
    verts, faces = _random_tris(300, seed=2)
    mesh = build_mesh(verts, faces, builder="python")
    rng = np.random.default_rng(3)
    o = jnp.asarray(rng.uniform(-8, 8, (512, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(512, 3)), jnp.float32)
    hb = intersect_mesh_brute(mesh, o, d, 1e-3)
    ht = intersect_mesh(mesh, o, d, 1e-3)
    np.testing.assert_array_equal(np.asarray(hb.hit), np.asarray(ht.hit))
    hit = np.asarray(hb.hit)
    np.testing.assert_allclose(np.asarray(ht.t)[hit], np.asarray(hb.t)[hit],
                               rtol=1e-5, atol=1e-6)
    # idx can differ only at exact-tie t (coplanar shared edges)
    same = np.asarray(ht.tri_idx) == np.asarray(hb.tri_idx)
    assert same[hit].mean() > 0.99


def test_traversal_nearest_of_two():
    # BvhTests nearest-hit: two triangles along one ray; nearest wins.
    verts = np.array([
        [-1, -1, -2], [1, -1, -2], [0, 1, -2],     # tri at z=-2
        [-1, -1, -5], [1, -1, -5], [0, 1, -5],     # tri at z=-5
    ], np.float64)
    faces = np.array([[0, 1, 2], [3, 4, 5]])
    mesh = build_mesh(verts, faces, builder="python")
    o = jnp.array([[0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    h = intersect_mesh(mesh, o, d, 1e-3)
    assert bool(h.hit[0])
    np.testing.assert_allclose(float(h.t[0]), 2.0, atol=1e-6)


def test_traversal_miss():
    verts, faces = _random_tris(50, seed=4)
    mesh = build_mesh(verts, faces, builder="python")
    o = jnp.array([[100.0, 100.0, 100.0]])
    d = jnp.array([[0.0, 1.0, 0.0]])
    h = intersect_mesh(mesh, o, d, 1e-3)
    assert not bool(h.hit[0])


def test_alive_mask_forces_miss():
    verts, faces = _random_tris(50, seed=5)
    mesh = build_mesh(verts, faces, builder="python")
    rng = np.random.default_rng(6)
    o = jnp.asarray(rng.uniform(-6, 6, (64, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(64, 3)), jnp.float32)
    alive = jnp.arange(64) % 2 == 0
    h = intersect_mesh(mesh, o, d, 1e-3, alive=alive)
    assert not np.asarray(h.hit)[1::2].any()
