"""Multi-device rendering via shard_map over a (sample, pixel) device mesh.

The reference's only parallel decomposition is a single-host thread pool
pulling tiles from an atomic counter (src/app/RayTracerFboItem.cpp:72-89) and
merging under a mutex. Here the devices run one SPMD program: the dynamic
queue becomes a *static* 2-axis sharding

    mesh axes:  "sp" — sample-parallel (spp split across devices)
                "px" — pixel-parallel (ray batch split across devices)

with exactly one collective: a psum of partial radiance sums over "sp"
(plus, in training, the automatic psum of scene-parameter gradients that
shard_map's transpose inserts — the gradient all-reduce of SURVEY.md §2.6,
which XLA hands to NCCL on GPUs). The counter-based RNG (core/sampling.py)
keys off *global* pixel and sample indices, so every sample's radiance is
bitwise independent of the mesh shape: pixel-partitioning ("px") gives
BITWISE-identical images, and sample-partitioning ("sp") moves results only
by reassociating the per-pixel spp sum across shards (<= a few f32 ulps) —
both tested (tests/test_parallel.py).

The cards of one host are joined all to all (NVLink), so the mesh shape
follows the algorithm only. Across hosts the same mesh spans every process's
devices via jax.distributed.initialize(); "sp" then maps to the host axis
since it reduces once.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import camera as cam_mod
from ..core import sampling
from ..core.config import RenderConfig
from ..core.integrator import trace
from ..core.render import _sample_radiance


def make_mesh(sp: int = 1, px: int | None = None, devices=None) -> Mesh:
    """Build an ("sp", "px") mesh. px defaults to (#devices / sp)."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if px is None:
        px = devices.size // sp
    if sp * px != devices.size:
        raise ValueError(f"sp*px = {sp}*{px} != {devices.size} devices")
    return Mesh(devices.reshape(sp, px), ("sp", "px"))


def _padded_pixels(cfg: RenderConfig, n_px: int) -> int:
    n = cfg.num_pixels
    return ((n + n_px - 1) // n_px) * n_px


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def render_linear_sharded(
    scene, camera, cfg: RenderConfig, key: jax.Array, mesh: Mesh
) -> jnp.ndarray:
    """Distributed render_linear: sum of spp samples, [H, W, 3].

    Output is replicated over "sp" (psum) and sharded over "px" rows; spp must
    be divisible by the "sp" axis size.
    """
    n_sp = mesh.shape["sp"]
    n_px = mesh.shape["px"]
    if cfg.spp % n_sp != 0:
        raise ValueError(f"spp={cfg.spp} not divisible by sp axis {n_sp}")
    local_spp = cfg.spp // n_sp

    n_padded = _padded_pixels(cfg, n_px)
    # Global pixel index per padded slot; padding slots replay pixel 0 and are
    # sliced off after (cheap, avoids ragged shards).
    pixel_index = jnp.arange(n_padded, dtype=jnp.uint32) % cfg.num_pixels
    h, w = cfg.height, cfg.width
    py = (pixel_index // w).astype(jnp.float32)
    i = (pixel_index % w).astype(jnp.float32)
    j = (h - 1) - py

    def shard_fn(pixel_index, i, j, scene, camera, key):
        pix_keys = sampling.pixel_states(key, pixel_index, cfg.rng)
        sp_idx = jax.lax.axis_index("sp")

        def one_sample(acc, k):
            sample_idx = sp_idx * local_spp + k
            return acc + _sample_radiance(scene, camera, cfg, pix_keys, i, j,
                                          sample_idx), None

        # Mark the init carry as "varying" over both mesh axes so it
        # type-matches the loop output (jax >= 0.9 shard_map check).
        accum = jax.lax.pcast(
            jnp.zeros((pixel_index.shape[0], 3), jnp.float32),
            ("sp", "px"), to="varying",
        )
        accum, _ = jax.lax.scan(one_sample, accum, jnp.arange(local_spp))
        return jax.lax.psum(accum, "sp")

    accum = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("px"), P("px"), P("px"), P(), P(), P()),
        out_specs=P("px"),
    )(pixel_index, i, j, scene, camera, key)

    return accum[: cfg.num_pixels].reshape(h, w, 3)


def device_put_replicated(tree, mesh: Mesh):
    """Place a pytree fully replicated on the mesh (scene/camera weights)."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)
