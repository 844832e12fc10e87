"""Worker process for tests/test_distributed.py: one of two cooperating
JAX processes on localhost (CPU collectives), each with 4 virtual devices.

Exercises the REAL multi-process path round-1 never executed
(parallel/distributed.py): jax.distributed.initialize with an explicit
coordinator, a global (sp=2, px=4) mesh whose "sp" psum crosses the process
boundary, a sharded render, and a parameter-gradient psum from shard_map's
transpose. Prints checksums for the parent to compare across processes and
against a single-process reference.
"""

import os
import sys

pid = int(sys.argv[1])
port = sys.argv[2]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from qt_raytracer import RenderConfig  # noqa: E402
from qt_raytracer.models import scenes  # noqa: E402
from qt_raytracer.parallel import distributed  # noqa: E402
from qt_raytracer.parallel.sharding import render_linear_sharded  # noqa: E402

distributed.initialize(f"localhost:{port}", num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.local_device_count() == 4
assert jax.device_count() == 8
assert distributed.is_coordinator() == (pid == 0)

cfg = RenderConfig(width=16, height=12, spp=4, max_depth=3)
scene, cam = scenes.get_scene("three_sphere", cfg.aspect_ratio)
key = jax.random.PRNGKey(0)

# Device order groups by process, so reshape(sp=2, px=4) puts process 0 on
# the sp=0 row and process 1 on sp=1: the radiance psum over "sp" is a REAL
# cross-process collective. The output (P("px"), replicated over sp) is
# fully addressable on both hosts.
mesh = distributed.global_mesh(sp=2)
img = render_linear_sharded(scene, cam, cfg, key, mesh)
img_np = np.asarray(img)

# Parameter gradient: shard_map's transpose psums albedo grads over the
# whole mesh — including the cross-host axis.
def loss_fn(albedo):
    import dataclasses
    sc = dataclasses.replace(scene, albedo=albedo)
    out = render_linear_sharded(sc, cam, cfg, key, mesh)
    return jnp.mean(out ** 2)

grad = np.asarray(jax.grad(loss_fn)(scene.albedo))

print(f"CHECKSUM img={img_np.sum():.6f} gsum={grad.sum():.8f} "
      f"gabs={np.abs(grad).sum():.8f}", flush=True)
