"""Exact-value intersection tests — ports the reference's SphereTests /
HitableListTests / geometry families (tests/unit/SphereTests.cpp:9-36,
HitableListTests.cpp:9-25) to the batched search."""

import jax.numpy as jnp
import numpy as np

from qt_raytracer import SceneBuilder
from qt_raytracer.core.intersect import BIG, intersect_spheres


def _unit_sphere_scene(pad_to=None):
    return SceneBuilder().lambertian((0.0, 0.0, -2.0), 1.0, (1, 1, 1)).build(pad_to=pad_to)


def test_sphere_hit_t_normal_front_face():
    # Ray from origin down -z at a unit sphere centered (0,0,-2): t=1,
    # normal (0,0,1), front face (SphereTests.cpp:9-27 semantics).
    scene = _unit_sphere_scene()
    o = jnp.array([[0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    h = intersect_spheres(scene, o, d, 1e-3)
    assert bool(h.hit[0])
    np.testing.assert_allclose(h.t[0], 1.0, atol=1e-6)
    np.testing.assert_allclose(h.point[0], [0.0, 0.0, -1.0], atol=1e-6)
    np.testing.assert_allclose(h.normal[0], [0.0, 0.0, 1.0], atol=1e-6)
    assert bool(h.front_face[0])


def test_sphere_inside_hit_back_face():
    # Origin inside the sphere: near root is behind t_min=1e-3? near root is
    # negative -> far root t=1 with flipped normal, front_face False.
    scene = SceneBuilder().lambertian((0.0, 0.0, 0.0), 1.0, (1, 1, 1)).build(pad_to=None)
    o = jnp.array([[0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    h = intersect_spheres(scene, o, d, 1e-3)
    assert bool(h.hit[0])
    np.testing.assert_allclose(h.t[0], 1.0, atol=1e-6)
    assert not bool(h.front_face[0])
    # forward-facing normal points back toward the ray origin side
    np.testing.assert_allclose(h.normal[0], [0.0, 0.0, 1.0], atol=1e-6)


def test_sphere_miss():
    scene = _unit_sphere_scene()
    o = jnp.array([[0.0, 5.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    h = intersect_spheres(scene, o, d, 1e-3)
    assert not bool(h.hit[0])
    assert float(h.t[0]) >= float(BIG)


def test_closest_hit_ordering():
    # Two spheres along the ray; nearest must win regardless of insert order
    # (HitableListTests.cpp:9-25).
    b = SceneBuilder()
    b.lambertian((0.0, 0.0, -5.0), 1.0, (1, 0, 0))
    b.lambertian((0.0, 0.0, -2.0), 0.5, (0, 1, 0))
    scene = b.build(pad_to=None)
    o = jnp.array([[0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    h = intersect_spheres(scene, o, d, 1e-3)
    assert int(h.prim_idx[0]) == 1
    np.testing.assert_allclose(h.t[0], 1.5, atol=1e-6)


def test_t_min_epsilon_respected():
    # A hit closer than t_min (shadow-acne epsilon, RayTracer.h:585) is
    # skipped in favor of the far root.
    scene = _unit_sphere_scene()
    o = jnp.array([[0.0, 0.0, -1.0 + 1e-4]])  # just outside the near surface
    d = jnp.array([[0.0, 0.0, -1.0]])
    h = intersect_spheres(scene, o, d, 1e-3)
    assert bool(h.hit[0])
    # must take the far surface (t ~ 2), not the nearby near-root
    assert float(h.t[0]) > 1.0


def test_inactive_padding_never_hits():
    scene = _unit_sphere_scene(pad_to=8)
    assert scene.num_spheres == 8
    o = jnp.tile(jnp.array([[0.0, 0.0, 0.0]]), (4, 1))
    d = jnp.array([[0, 0, -1.0], [0, 0, 1.0], [1, 0, 0.0], [0, 1, 0.0]])
    h = intersect_spheres(scene, o, d, 1e-3)
    assert bool(h.hit[0])
    assert not bool(h.hit[1]) and not bool(h.hit[2]) and not bool(h.hit[3])


def test_large_sphere_precision_refinement():
    # Ground sphere r=1000: the refinement pass must deliver f64-grade t.
    b = SceneBuilder().lambertian((0.0, -1000.0, 0.0), 1000.0, (1, 1, 1))
    scene = b.build(pad_to=None)
    o = jnp.array([[0.0, 2.0, 0.0]])
    d = jnp.array([[0.6, -0.8, 0.0]])
    h = intersect_spheres(scene, o, d, 1e-3)
    # f64 truth
    oc = np.array([0.0, 1002.0, 0.0])
    dd = np.array([0.6, -0.8, 0.0])
    a = dd @ dd
    half_b = oc @ dd
    c = oc @ oc - 1000.0**2
    t_true = (-half_b - np.sqrt(half_b**2 - a * c)) / a
    np.testing.assert_allclose(float(h.t[0]), t_true, rtol=1e-5)
