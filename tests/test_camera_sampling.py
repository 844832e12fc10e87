"""Camera + sampler tests — ports CameraTests.cpp and the statistical sampler
invariants of MathUtilsTests.cpp:23-33 to the closed-form samplers."""

import jax
import jax.numpy as jnp
import numpy as np

from qt_raytracer.core import sampling, vecmath as vm
from qt_raytracer.core.camera import get_rays, make_camera


def test_zero_aperture_center_ray_hits_lookat():
    # CameraTests.cpp:9-24: the (0.5, 0.5) ray of an aperture-0 camera passes
    # through lookat.
    lookfrom = (3.0, 2.0, 5.0)
    lookat = (-1.0, 0.5, 0.0)
    cam = make_camera(lookfrom, lookat, vfov=45.0, aspect_ratio=1.5,
                      aperture=0.0, focus_dist=7.0)
    s = jnp.array([0.5])
    t = jnp.array([0.5])
    o, d = get_rays(cam, s, t, jnp.zeros(1), jnp.zeros(1))
    np.testing.assert_allclose(np.asarray(o[0]), lookfrom, atol=1e-5)
    # lookat - lookfrom must be parallel to d
    to_target = np.asarray(lookat) - np.asarray(lookfrom)
    dn = np.asarray(vm.unit_vector(d))[0]
    np.testing.assert_allclose(dn, to_target / np.linalg.norm(to_target), atol=1e-5)


def test_lens_offsets_within_aperture_in_lens_plane():
    # CameraTests.cpp:26-38: origins stay within aperture/2 of lookfrom, in
    # the (u, v) lens plane.
    aperture = 0.6
    cam = make_camera((0, 0, 5.0), (0, 0, 0), vfov=40.0, aspect_ratio=1.0,
                      aperture=aperture, focus_dist=5.0)
    k = jax.random.PRNGKey(0)
    u1, u2 = jax.random.uniform(k, (2, 128))
    s = jnp.full((128,), 0.3)
    t = jnp.full((128,), 0.7)
    o, _ = get_rays(cam, s, t, u1, u2)
    offsets = np.asarray(o) - np.array([0.0, 0.0, 5.0])
    radii = np.linalg.norm(offsets, axis=-1)
    assert (radii <= aperture / 2 + 1e-6).all()
    # lens plane: no component along w (w = +z here)
    assert np.abs(offsets[:, 2]).max() < 1e-6


def test_unit_vector_sampler_on_sphere():
    k = jax.random.PRNGKey(1)
    u = jax.random.uniform(k, (2, 256))
    v = np.asarray(sampling.random_unit_vector(u[0], u[1]))
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)
    # statistical isotropy: mean should be near zero
    assert np.abs(v.mean(axis=0)).max() < 0.15


def test_in_unit_sphere_inside():
    k = jax.random.PRNGKey(2)
    u = jax.random.uniform(k, (3, 256))
    v = np.asarray(sampling.random_in_unit_sphere(u[0], u[1], u[2]))
    assert (np.linalg.norm(v, axis=-1) <= 1.0 + 1e-6).all()


def test_in_unit_disk_inside_and_planar():
    # MathUtilsTests.cpp:23-33: inside the disk and z == 0.
    k = jax.random.PRNGKey(3)
    u = jax.random.uniform(k, (2, 256))
    v = np.asarray(sampling.random_in_unit_disk(u[0], u[1]))
    assert (np.linalg.norm(v[:, :2], axis=-1) <= 1.0 + 1e-6).all()
    np.testing.assert_array_equal(v[:, 2], 0.0)


def test_rng_streams_shard_invariant():
    # Splitting the pixel range must produce identical uniforms per pixel:
    # the counter-based hierarchy is independent of batch decomposition.
    base = jax.random.PRNGKey(5)
    keys = sampling.pixel_keys(base, 64)
    full = sampling.stream_uniforms(sampling.sample_keys(keys, 3), 2, 8)
    lo = sampling.stream_uniforms(sampling.sample_keys(keys[:32], 3), 2, 8)
    hi = sampling.stream_uniforms(sampling.sample_keys(keys[32:], 3), 2, 8)
    np.testing.assert_array_equal(np.asarray(full), np.concatenate([lo, hi]))
