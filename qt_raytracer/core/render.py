"""Top-level render API: render(scene, camera, config, key) -> image.

Replaces the reference's render orchestration (RenderWorker tile loop,
src/app/RayTracerFboItem.cpp:46-143): tiles + a dynamic work queue become a
flat SoA ray batch (devices are SPMD — sharding lives in parallel/), and the
per-pixel sample loop becomes a ``lax.scan`` over sample batches with a donated
accumulator.

Pixel conventions match the reference exactly (RayTracerFboItem.cpp:102-127):
row 0 is the TOP of the image, the viewport v coordinate uses j = height-1-row,
u = (i + jitter)/(width-1), v = (j + jitter)/(height-1).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import camera as cam_mod
from . import sampling, tonemap
from .config import RenderConfig
from .integrator import trace
from .scene import SphereScene


def resolve_intersector(cfg: RenderConfig) -> str:
    """Map cfg.intersector "auto" to the platform's search: the Pallas
    kernels on a GPU, the portable XLA search elsewhere. "pallas" needs a
    GPU and raises on any other platform; the interpreter runs only when
    asked for by name ("pallas_interpret")."""
    platform = jax.default_backend()
    if cfg.intersector == "auto":
        return "pallas" if platform == "gpu" else "xla"
    if cfg.intersector == "pallas" and platform != "gpu":
        raise ValueError(
            f'intersector "pallas" needs a GPU (default backend: {platform}); '
            'use "xla", or "pallas_interpret" for the kernel interpreter')
    return cfg.intersector


# Auto-chunk heuristic (the chooseTileSize/chooseMaxUploadsPerFrame analog,
# RayTracerFboItem.cpp:793-848): ~400Ki-ray chunks bound the per-bounce
# working set at 1080p (5 chunks), and below 256Ki rays the image is traced
# in one piece. Chunks are rounded up to whole kernel blocks.
_CHUNK_TILE = 1024
_CHUNK_TARGET = 414720
_CHUNK_MIN_RAYS = 262144


def resolve_pixel_chunk(cfg: RenderConfig) -> int:
    """Effective pixel chunk size: cfg.pixel_chunk, or the auto heuristic
    when it is 0 (-1 disables chunking). Returns 0 for "no chunking"."""
    if cfg.pixel_chunk > 0:
        return cfg.pixel_chunk
    if cfg.pixel_chunk < 0:
        return 0
    n = cfg.num_pixels
    if n < _CHUNK_MIN_RAYS:
        return 0
    n_chunks = max(2, round(n / _CHUNK_TARGET))
    per_chunk = -(-n // n_chunks)
    return -(-per_chunk // _CHUNK_TILE) * _CHUNK_TILE


def _trace_dispatch(scene, origins, directions, samp_keys, cfg: RenderConfig):
    """Trace one wavefront with the resolved intersector."""
    return trace(scene, origins, directions, samp_keys, cfg.max_depth,
                 cfg.t_min, intersector=resolve_intersector(cfg),
                 nee=cfg.nee, rr_start=cfg.rr_start)


def pixel_grid(cfg: RenderConfig, dtype=jnp.float32):
    """Flat per-pixel (i, j) viewport integer coordinates, image order.

    Returns (i [N], j [N], pixel_index [N]) with pixel_index = row*W + col,
    row 0 = top; j = height-1-row is the bottom-origin coordinate used by the
    reference's v computation.
    """
    h, w = cfg.height, cfg.width
    rows = jnp.arange(h)
    cols = jnp.arange(w)
    py, px = jnp.meshgrid(rows, cols, indexing="ij")  # [h,w]
    i = px.reshape(-1).astype(dtype)
    j = (h - 1 - py).reshape(-1).astype(dtype)
    pixel_index = (py * w + px).reshape(-1).astype(jnp.uint32)
    return i, j, pixel_index


def _sample_radiance(scene, camera, cfg: RenderConfig, pix_keys, i, j, sample_idx):
    """Trace one sample for every pixel; returns [N,3] linear radiance."""
    if cfg.edge_aware:
        from ..diff.edge import sample_radiance_edge_aware

        return sample_radiance_edge_aware(scene, camera, cfg, pix_keys,
                                          i, j, sample_idx)
    samp_keys = sampling.sample_keys(pix_keys, sample_idx)
    gen = sampling.stream_uniforms(samp_keys, sampling.STREAM_GEN,
                                  sampling.UNIFORMS_GEN)
    inv_w = 1.0 / max(cfg.width - 1, 1)
    inv_h = 1.0 / max(cfg.height - 1, 1)
    s = (i + gen[:, 0]) * inv_w
    t = (j + gen[:, 1]) * inv_h
    origins, directions = cam_mod.get_rays(camera, s, t, gen[:, 2], gen[:, 3])
    return _trace_dispatch(scene, origins, directions, samp_keys, cfg)


def _merged_batch_radiance(scene, camera, cfg: RenderConfig, pix_keys, i, j,
                           batch_idx, spb: int):
    """Trace spb samples of every pixel as ONE merged wavefront.

    Small images underfill the device per launch (fixed per-bounce costs
    dominate below ~1M rays); concatenating the batch's samples into a
    single [spb*N] ray population amortizes them. Per-sample keys/uniforms
    are identical to the scan path, and the per-pixel sum runs in ascending
    sample order, so results match the one-sample-at-a-time path bitwise.
    """
    n = i.shape[0]
    rep = lambda x: jnp.concatenate([x] * spb, axis=0)
    sample_ids = batch_idx * spb + jnp.repeat(
        jnp.arange(spb, dtype=jnp.uint32), n)
    samp_keys = sampling.sample_keys(rep(pix_keys), sample_ids)
    gen = sampling.stream_uniforms(samp_keys, sampling.STREAM_GEN,
                                   sampling.UNIFORMS_GEN)
    inv_w = 1.0 / max(cfg.width - 1, 1)
    inv_h = 1.0 / max(cfg.height - 1, 1)
    s = (rep(i) + gen[:, 0]) * inv_w
    t = (rep(j) + gen[:, 1]) * inv_h
    origins, directions = cam_mod.get_rays(camera, s, t, gen[:, 2], gen[:, 3])
    rad = _trace_dispatch(scene, origins, directions, samp_keys, cfg)
    return jnp.sum(rad.reshape(spb, n, 3), axis=0)


@partial(jax.jit, static_argnames=("cfg",))
def render_linear(
    scene: SphereScene, camera, cfg: RenderConfig, key: jax.Array
) -> jnp.ndarray:
    """Sum of spp linear radiance samples, shape [H, W, 3] (row 0 = top).

    Divide by cfg.spp (or use tonemap.resolve) for the mean image. Keeping the
    un-normalized sum makes progressive accumulation and cross-device psum exact.
    """
    i, j, pixel_index = pixel_grid(cfg)
    pix_keys = sampling.pixel_states(key, pixel_index, cfg.rng)

    spb = cfg.samples_per_batch
    num_batches = cfg.spp // spb

    # Rematerialize each sample-batch's trace: identical program for
    # forward-only renders, but under differentiation the backward
    # recomputes one batch at a time instead of saving EVERY
    # (chunk, batch, bounce) residual simultaneously — the chunked
    # backward materialized [chunks, batches, depth, chunk_rays] HLO
    # temps and OOMed HBM at 1080p multi-view training (config 5 at
    # spec; ~20 x 63 MB temps measured in the OOM report).
    @jax.checkpoint
    def _one_batch(scene, camera, pix_keys_c, i_c, j_c, batch_idx):
        if spb == 1:
            return _sample_radiance(scene, camera, cfg, pix_keys_c,
                                    i_c, j_c, batch_idx)
        return _merged_batch_radiance(scene, camera, cfg, pix_keys_c,
                                      i_c, j_c, batch_idx, spb)

    def render_chunk(pix_keys_c, i_c, j_c):
        def batch_step(accum, batch_idx):
            out = _one_batch(scene, camera, pix_keys_c, i_c, j_c, batch_idx)
            return accum + out, None

        accum = jnp.zeros((i_c.shape[0], 3), jnp.float32)
        accum, _ = jax.lax.scan(batch_step, accum, jnp.arange(num_batches))
        return accum

    n = cfg.num_pixels
    chunk = resolve_pixel_chunk(cfg)
    if chunk <= 0 or chunk >= n:
        accum = render_chunk(pix_keys, i, j)
    else:
        # Pad to a whole number of chunks; padding replays pixel 0 (its keys
        # are real, results are sliced off) so every chunk is full-size.
        n_pad = (-n) % chunk
        pad = lambda x: jnp.concatenate([x, x[:n_pad]]) if n_pad else x
        c = lambda x: pad(x).reshape((-1, chunk) + x.shape[1:])
        accum = jax.lax.map(
            lambda args: render_chunk(*args), (c(pix_keys), c(i), c(j))
        ).reshape(-1, 3)[:n]
    return accum.reshape(cfg.height, cfg.width, 3)


def render(scene: SphereScene, camera, cfg: RenderConfig, key: jax.Array):
    """Full batch render -> uint8 image [H, W, 3] (gamma-2, quantized)."""
    accum = render_linear(scene, camera, cfg, key)
    return tonemap.to_uint8(accum, cfg.spp, cfg.quantizer)


@partial(jax.jit, static_argnames=("cfg", "num_samples"))
def render_sample_batch(
    scene: SphereScene, camera, cfg: RenderConfig, key: jax.Array,
    start_sample: jnp.ndarray, num_samples: int,
) -> jnp.ndarray:
    """Linear radiance sum for samples [start, start+num) — the progressive
    building block (1-spp-per-frame accumulation of the GPU backends,
    GpuPathTracer.cpp:279-282, generalized to any batch size)."""
    i, j, pixel_index = pixel_grid(cfg)
    pix_keys = sampling.pixel_states(key, pixel_index, cfg.rng)

    def one_sample(acc, k):
        return acc + _sample_radiance(scene, camera, cfg, pix_keys, i, j,
                                      start_sample + k), None

    accum = jnp.zeros((cfg.num_pixels, 3), jnp.float32)
    accum, _ = jax.lax.scan(one_sample, accum, jnp.arange(num_samples))
    return accum.reshape(cfg.height, cfg.width, 3)
