"""Material scatter invariants — ports MaterialTests.cpp:9-66 to the masked
batched scatter."""

import jax
import jax.numpy as jnp
import numpy as np

from qt_raytracer import SceneBuilder
from qt_raytracer.core import materials, vecmath as vm


def _scatter_single(builder, in_dir, normal=(0.0, 0.0, 1.0), front_face=True,
                    uniforms=None, key=0):
    scene = builder.build(pad_to=None)
    n = jnp.asarray([normal], jnp.float32)
    d = jnp.asarray([in_dir], jnp.float32)
    if uniforms is None:
        uniforms = jax.random.uniform(jax.random.PRNGKey(key), (1, 8))
    else:
        uniforms = jnp.asarray([uniforms], jnp.float32)
    ff = jnp.asarray([front_face])
    return materials.scatter(
        scene.mat_type[:1], scene.albedo[:1], scene.fuzz[:1], scene.ior[:1],
        scene.emission[:1], d, n, ff, uniforms)


def test_lambertian_albedo_passthrough_and_nonzero_dir():
    albedo = (0.8, 0.4, 0.2)
    sc = _scatter_single(SceneBuilder().lambertian((0, 0, 0), 1.0, albedo),
                         in_dir=(0.0, 0.0, -1.0))
    np.testing.assert_allclose(np.asarray(sc.attenuation[0]), albedo, atol=1e-6)
    assert bool(sc.ok[0])
    assert float(vm.length_squared(sc.direction[0])) > 1e-8


def test_lambertian_degenerate_guard():
    # Force the sampled unit vector to be ~-normal: u0=1 -> z=-1. Direction
    # collapses -> guard substitutes the normal (RayTracer.h:479-480).
    sc = _scatter_single(
        SceneBuilder().lambertian((0, 0, 0), 1.0, (0.5, 0.5, 0.5)),
        in_dir=(0.0, 0.0, -1.0),
        uniforms=[1.0 - 1e-8, 0.0, 0, 0, 0, 0, 0, 0],
    )
    np.testing.assert_allclose(np.asarray(sc.direction[0]), [0.0, 0.0, 1.0],
                               atol=1e-3)


def test_fuzz0_metal_reflects_exactly():
    # MaterialTests.cpp:37-52: fuzz=0 metal is a perfect mirror.
    in_dir = (1.0, 0.0, -1.0)
    sc = _scatter_single(SceneBuilder().metal((0, 0, 0), 1.0, (0.9, 0.9, 0.9), 0.0),
                         in_dir=in_dir)
    expect = np.array([1.0, 0.0, 1.0]) / np.sqrt(2.0)
    np.testing.assert_allclose(np.asarray(sc.direction[0]), expect, atol=1e-6)
    assert bool(sc.ok[0])


def test_metal_absorbs_below_horizon():
    # Grazing + large fuzz can push the scattered ray below the surface:
    # ok must go False (RayTracer.h:498). Engineer it deterministically:
    # reflect of grazing ray ~ parallel to surface; fuzz sample with z<0.
    sc = _scatter_single(
        SceneBuilder().metal((0, 0, 0), 1.0, (0.9, 0.9, 0.9), 1.0),
        in_dir=(1.0, 0.0, -1e-3),
        uniforms=[0.99, 0.0, 1.0, 0, 0, 0, 0, 0],  # u0~1 -> z~-1 fuzz vector
    )
    assert not bool(sc.ok[0])


def test_dielectric_attenuation_white():
    # MaterialTests.cpp:54-66.
    sc = _scatter_single(SceneBuilder().dielectric((0, 0, 0), 1.0, 1.5),
                         in_dir=(0.0, 0.0, -1.0))
    np.testing.assert_allclose(np.asarray(sc.attenuation[0]), [1, 1, 1], atol=0)
    assert bool(sc.ok[0])


def test_dielectric_total_internal_reflection():
    # Exit glass->air at a grazing angle: ratio*sin_theta > 1 forces reflect.
    in_dir = (0.9, 0.0, -0.1)
    sc = _scatter_single(SceneBuilder().dielectric((0, 0, 0), 1.0, 1.5),
                         in_dir=in_dir, front_face=False,
                         uniforms=[0, 0, 0, 1.0 - 1e-7, 0, 0, 0, 0])
    d = np.asarray(sc.direction[0])
    expect = vm.reflect(np.asarray(in_dir) / np.linalg.norm(in_dir),
                        np.array([0.0, 0.0, 1.0]))
    np.testing.assert_allclose(d, np.asarray(expect), atol=1e-6)


def test_dielectric_refraction_snell():
    # Head-on air->glass entry with u3=1 (never Schlick-reflect): straight
    # through (sin 0 = 0).
    sc = _scatter_single(SceneBuilder().dielectric((0, 0, 0), 1.0, 1.5),
                         in_dir=(0.0, 0.0, -1.0), front_face=True,
                         uniforms=[0, 0, 0, 1.0 - 1e-7, 0, 0, 0, 0])
    np.testing.assert_allclose(np.asarray(sc.direction[0]), [0, 0, -1.0],
                               atol=1e-6)


def test_emissive_terminates_with_radiance():
    emission = (4.0, 3.0, 2.0)
    sc = _scatter_single(SceneBuilder().emissive((0, 0, 0), 1.0, emission),
                         in_dir=(0.0, 0.0, -1.0))
    assert not bool(sc.ok[0])
    np.testing.assert_allclose(np.asarray(sc.emitted[0]), emission, atol=1e-6)


def test_metal_fuzz_clamped_to_one():
    scene = SceneBuilder().metal((0, 0, 0), 1.0, (1, 1, 1), 7.5).build(pad_to=None)
    assert float(scene.fuzz[0]) == 1.0  # RayTracer.h:492 constructor clamp
