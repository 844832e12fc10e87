"""Native runtime components: C++ SAH BVH builder and OBJ loader (ctypes).
Skipped gracefully if no toolchain is available (pure-python fallbacks are
exercised everywhere else)."""

import numpy as np
import pytest

from qt_raytracer.runtime.native_lib import load_native

pytestmark = pytest.mark.skipif(load_native() is None,
                                reason="native library unavailable")


def test_native_bvh_invariants_and_traversal():
    import jax.numpy as jnp

    from qt_raytracer.accel.bvh import validate_bvh
    from qt_raytracer.accel.mesh import build_mesh
    from qt_raytracer.accel.traverse import (intersect_mesh,
                                                 intersect_mesh_brute)
    from qt_raytracer.runtime.native_bvh import build_bvh_native

    rng = np.random.default_rng(0)
    lo = rng.uniform(-5, 5, (1000, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.01, 0.5, (1000, 3)).astype(np.float32)
    bvh = build_bvh_native(lo, hi, max_leaf=4)
    validate_bvh(bvh, lo, hi)

    # End-to-end: native-built mesh traversal == brute force.
    base = rng.uniform(-4, 4, (400, 1, 3))
    tri = base + rng.uniform(-0.3, 0.3, (400, 3, 3))
    verts = tri.reshape(-1, 3)
    faces = np.arange(1200).reshape(400, 3)
    mesh = build_mesh(verts, faces, builder="native")
    o = jnp.asarray(rng.uniform(-6, 6, (256, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(256, 3)), jnp.float32)
    hb = intersect_mesh_brute(mesh, o, d, 1e-3)
    ht = intersect_mesh(mesh, o, d, 1e-3)
    np.testing.assert_array_equal(np.asarray(hb.hit), np.asarray(ht.hit))
    hit = np.asarray(hb.hit)
    np.testing.assert_allclose(np.asarray(ht.t)[hit], np.asarray(hb.t)[hit],
                               rtol=1e-5, atol=1e-6)


def test_native_sah_beats_or_matches_median_quality():
    # SAH trees should not be (much) deeper-costed than median on clustered
    # input; sanity: node count bounded and all leaves small.
    from qt_raytracer.runtime.native_bvh import build_bvh_native

    rng = np.random.default_rng(1)
    lo = rng.uniform(-10, 10, (5000, 3)).astype(np.float32)
    hi = lo + 0.1
    bvh = build_bvh_native(lo, hi, max_leaf=8)
    assert (bvh.prim_count <= 8).all()
    assert len(bvh.escape) <= 2 * 5000


def test_obj_loader_roundtrip(tmp_path):
    from qt_raytracer.runtime.native_bvh import (_load_obj_python,
                                                     load_obj)

    p = tmp_path / "quad.obj"
    p.write_text(
        "# comment\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
        "f 1 2 3\nf 2/1 4/2 3/3\nf -4//1 -3//2 -2//3\n")
    v, f = load_obj(str(p))
    v2, f2 = _load_obj_python(str(p))
    np.testing.assert_allclose(v, v2)
    np.testing.assert_array_equal(f, f2)
    assert v.shape == (4, 3) and f.shape == (3, 3)
