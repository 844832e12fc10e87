"""Multi-host execution helpers.

The reference has no distributed execution at all (SURVEY.md §2.6). Here the
same shard_map render/training path (parallel/sharding.py) scales to several
hosts; this module wraps the host-bootstrap plumbing:

  - initialize(): jax.distributed.initialize(); after this, jax.devices()
    spans all hosts and the (sp, px) mesh simply covers them. Scene-parameter
    gradient psums ride the intra-host links and the inter-host network,
    emitted by the same shard_map transpose and overlapped by XLA's
    latency-hiding scheduler.
  - global_mesh(): an (sp, px) mesh over ALL processes' devices, with "px"
    contiguous within hosts so pixel traffic stays inside a host and only
    the one "sp" radiance/grad reduction crosses hosts.
  - gather_image(): process_allgather for host-0 preview/IO of a sharded
    render (the tile-gather of SURVEY §2.6).

Scaling-efficiency measurement (north star: >=90% rays/s from 1 to N hosts)
runs the identical bench on 1 host and N hosts; the counter-based RNG makes
the images bitwise identical, so only wall-clock changes.
"""

from __future__ import annotations

import jax
import numpy as np

from .sharding import make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize.

    Pass the coordinator address (host:port), the process count and this
    process's id; without them JAX relies on a cluster environment to
    discover them. Call once per process before any backend use.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def global_mesh(sp: int = 1):
    """(sp, px) mesh over every device of every process.

    Device order from jax.devices() groups devices by process, so the "px"
    axis is host-contiguous: pixel-tile collectives stay inside each host
    and only the single "sp" psum crosses hosts.
    """
    return make_mesh(sp=sp, devices=jax.devices())


def gather_image(image) -> np.ndarray:
    """All-gather a sharded render result to every host (for preview/IO)."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(image, tiled=True))


def is_coordinator() -> bool:
    return jax.process_index() == 0
