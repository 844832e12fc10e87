"""AABB slab-test family — ports tests/unit/AabbTests.cpp:11-74 (hit/miss,
union boxes, bounding boxes) to the batched traversal helpers."""

import jax.numpy as jnp
import numpy as np

from qt_raytracer.accel.bvh import build_bvh
from qt_raytracer.accel.traverse import _slab_test


def _one(bmin, bmax, o, d, t_min=1e-3, t_max=3e38):
    r = _slab_test(jnp.asarray([bmin], jnp.float32),
                   jnp.asarray([bmax], jnp.float32),
                   jnp.asarray([o], jnp.float32),
                   1.0 / jnp.asarray([d], jnp.float32), t_min, t_max)
    return bool(r[0])


def test_slab_hit_through_center():
    assert _one([-1, -1, -1], [1, 1, 1], [0, 0, -5], [0, 0, 1])


def test_slab_miss_parallel_offset():
    assert not _one([-1, -1, -1], [1, 1, 1], [0, 5, -5], [0, 0, 1])


def test_slab_hit_negative_direction():
    # inv_d < 0 swaps t0/t1 (RayTracer.h:234-236 semantics).
    assert _one([-1, -1, -1], [1, 1, 1], [0, 0, 5], [0, 0, -1])


def test_slab_behind_origin_misses():
    assert not _one([-1, -1, -1], [1, 1, 1], [0, 0, 5], [0, 0, 1])


def test_slab_respects_t_max():
    r = _slab_test(jnp.asarray([[-1, -1, -1]], jnp.float32),
                   jnp.asarray([[1, 1, 1]], jnp.float32),
                   jnp.asarray([[0, 0, -5]], jnp.float32),
                   1.0 / jnp.asarray([[0, 0, 1]], jnp.float32)
                   if False else 1.0 / jnp.asarray([[1e-30, 1e-30, 1.0]],
                                                   jnp.float32),
                   1e-3, 2.0)  # box entry at t=4 > t_max=2
    assert not bool(r[0])


def test_axis_parallel_ray_inside_slab():
    # Ray along +x inside the box's y/z slabs: infinite inv_d handled.
    assert _one([-1, -1, -1], [1, 1, 1], [-5, 0, 0], [1, 1e-30, 1e-30])


def test_union_box_is_root_bbox():
    # surrounding_box (RayTracer.h:251-265) analog: the BVH root box is the
    # union of all primitive boxes.
    lo = np.array([[0, 0, 0], [2, -1, 3]], np.float32)
    hi = np.array([[1, 1, 1], [3, 0.5, 4]], np.float32)
    bvh = build_bvh(lo, hi)
    np.testing.assert_allclose(bvh.bbox_min[0], [0, -1, 0])
    np.testing.assert_allclose(bvh.bbox_max[0], [3, 1, 4])
