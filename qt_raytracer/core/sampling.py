"""Closed-form random samplers and counter-based RNG key derivation.

The reference uses per-thread xorshift64* state plus *rejection* sampling for
disk/sphere points (include/raytracer/RayTracer.h:25-55,155-173). Rejection
loops are unbounded data-dependent control flow — hostile to XLA — so this
framework replaces them with closed-form equal-distribution samplers driven by
a counter-based (threefry) key hierarchy:

    pixel_key  = fold_in(base_key, pixel_index)
    sample_key = fold_in(pixel_key, sample_index)
    uniforms   = uniform(fold_in(sample_key, stream_id), (k,))

which makes every pixel/sample/bounce stream independent of how the image is
sharded across chips (SURVEY.md "RNG determinism under resharding").

All samplers take explicit uniforms u in [0,1) so the scalar oracle
(qt_raytracer/testing/oracle.py) can consume the *identical* stream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

TWO_PI = 6.283185307179586

# Stream ids (fold_in tags) inside one sample. Bounce b uses STREAM_BOUNCE0+b.
STREAM_GEN = 0        # pixel jitter (2) + lens disk (2)
STREAM_BOUNCE0 = 1

# Uniform slot layout of the per-bounce [*, 8] block (must match the oracle):
#   0,1   -> unit-vector / in-unit-sphere angles (z, phi)
#   2     -> in-unit-sphere radius (metal fuzz)
#   3     -> dielectric reflect-vs-refract choice
#   4..7  -> reserved (NEE light pick / light surface point)
UNIFORMS_PER_BOUNCE = 8
UNIFORMS_GEN = 4


def random_unit_vector(u1, u2):
    """Uniform direction on the unit sphere (closed-form).

    Replaces normalize(rejection-sample ball) of RayTracer.h:155-173; both are
    the uniform sphere-surface distribution.
    """
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(1.0e-20, 1.0 - z * z))
    phi = TWO_PI * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def random_in_unit_sphere(u1, u2, u3):
    """Uniform point inside the unit ball (closed-form).

    Replaces the rejection loop at RayTracer.h:155-161: direction uniform on
    the sphere, radius ~ cbrt(u) for uniform volume density.
    """
    return random_unit_vector(u1, u2) * jnp.cbrt(u3)[..., None]


def random_in_unit_disk(u1, u2):
    """Uniform point in the unit disk, z=0 (closed-form polar).

    Replaces the rejection loop at RayTracer.h:163-169.
    """
    r = jnp.sqrt(u1)
    phi = TWO_PI * u2
    zero = jnp.zeros_like(r)
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), zero], axis=-1)


def pixel_keys(base_key: jax.Array, num_pixels: int) -> jax.Array:
    """One threefry key per pixel: fold_in(base, pixel_index)."""
    idx = jnp.arange(num_pixels, dtype=jnp.uint32)
    return jax.vmap(lambda i: jax.random.fold_in(base_key, i))(idx)


def sample_keys(pix_keys: jax.Array, sample_index) -> jax.Array:
    """Per-pixel state for one sample index (traced int OK inside scan);
    sample_index may also be a per-pixel [N] vector (merged sample batches).

    Dtype dispatch: uint32 states take the hash path, threefry keys the
    fold_in path — downstream code is RNG-agnostic.
    """
    if _is_hash_state(pix_keys):
        ids = jnp.asarray(sample_index, jnp.uint32)
        return _lowbias32(pix_keys ^ ids * GOLDEN)
    if jnp.ndim(sample_index) == 0:
        return jax.vmap(lambda k: jax.random.fold_in(k, sample_index))(
            pix_keys)
    return jax.vmap(jax.random.fold_in)(pix_keys, jnp.asarray(sample_index))


def stream_uniforms(samp_keys: jax.Array, stream_id, n: int) -> jax.Array:
    """[N, n] uniforms for a given stream id of each sample state."""
    if _is_hash_state(samp_keys):
        counters = (samp_keys[:, None]
                    + jnp.uint32(stream_id) * GOLDEN
                    + jnp.arange(n, dtype=jnp.uint32)[None, :] * WEYL2)
        bits = _lowbias32(_lowbias32(counters) + GOLDEN)
        return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(2.0 ** -24)
    def one(k):
        return jax.random.uniform(jax.random.fold_in(k, stream_id), (n,))
    return jax.vmap(one)(samp_keys)


# ------------------------------------------------- counter-based hash RNG
# A pure integer-arithmetic alternative to threefry, far cheaper per bounce,
# while keeping the same counter-based hierarchy (and therefore the same shard /
# mesh invariance). Far stronger than the reference GPU kernels' single-pass
# hash32 (GpuPathTracer.cpp:151-162); statistical quality is validated in
# tests (uniformity + stream decorrelation).
GOLDEN = np.uint32(0x9E3779B9)   # 2^32 / phi (Weyl increment); np not jnp:
#                                  import must not init the XLA backend
WEYL2 = np.uint32(0x85EBCA77)


def _is_hash_state(x) -> bool:
    # Hash states are flat [N] uint32; legacy threefry keys are [N, 2] uint32
    # and typed keys have a key dtype — ndim disambiguates.
    return (hasattr(x, "dtype") and x.dtype == jnp.uint32
            and x.ndim == 1)


def _lowbias32(x):
    """Wellons' lowbias32 integer permutation (public domain constants)."""
    x = jnp.asarray(x, jnp.uint32)
    x ^= x >> jnp.uint32(16)
    x *= jnp.uint32(0x7FEB352D)
    x ^= x >> jnp.uint32(15)
    x *= jnp.uint32(0x846CA68B)
    x ^= x >> jnp.uint32(16)
    return x


def hash_pixel_states(base_key: jax.Array, pixel_index: jax.Array) -> jax.Array:
    """[N] uint32 per-pixel hash states from a threefry base key + indices."""
    data = jax.random.key_data(base_key).astype(jnp.uint32).reshape(-1)
    seed = data[0] ^ _lowbias32(data[-1])
    return _lowbias32(pixel_index.astype(jnp.uint32) * GOLDEN + _lowbias32(seed))


def pixel_states(base_key: jax.Array, pixel_index: jax.Array,
                 rng: str = "threefry") -> jax.Array:
    """Per-pixel RNG states for explicit pixel indices [N]."""
    if rng == "hash":
        return hash_pixel_states(base_key, pixel_index)
    if rng != "threefry":
        raise ValueError(f"unknown rng {rng!r}")
    return jax.vmap(lambda i: jax.random.fold_in(base_key, i))(
        pixel_index.astype(jnp.uint32))
