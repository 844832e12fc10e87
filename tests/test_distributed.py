"""TWO-PROCESS distributed execution test: spawns two
real OS processes that form a JAX distributed system over localhost and run
the sharded render + gradient path with genuine cross-process collectives.
Fails if parallel/distributed.py regresses."""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

WORKER = Path(__file__).parent / "distributed_worker.py"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_render_and_grad_psum():
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
    env["PYTHONPATH"] = str(WORKER.parent.parent)
    procs = [
        subprocess.Popen([sys.executable, str(WORKER), str(i), str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        lines = [ln for ln in out.splitlines() if ln.startswith("CHECKSUM")]
        assert lines, f"no checksum in output:\n{out}\n{err}"
        outs.append(lines[0])

    # Both processes must agree exactly (they hold replicated results of the
    # same cross-process computation).
    assert outs[0] == outs[1], outs

    # And match a single-process reference of the same fixed-key render.
    from qt_raytracer import RenderConfig, render_linear
    from qt_raytracer.models import scenes

    cfg = RenderConfig(width=16, height=12, spp=4, max_depth=3)
    scene, cam = scenes.get_scene("three_sphere", cfg.aspect_ratio)
    key = jax.random.PRNGKey(0)
    ref = np.asarray(render_linear(scene, cam, cfg, key))

    def loss_fn(albedo):
        sc = dataclasses.replace(scene, albedo=albedo)
        return jnp.mean(render_linear(sc, cam, cfg, key) ** 2)

    gref = np.asarray(jax.grad(loss_fn)(scene.albedo))
    img_sum = float(outs[0].split("img=")[1].split()[0])
    gsum = float(outs[0].split("gsum=")[1].split()[0])
    gabs = float(outs[0].split("gabs=")[1].split()[0])
    np.testing.assert_allclose(img_sum, ref.sum(), rtol=1e-5)
    np.testing.assert_allclose(gsum, gref.sum(), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(gabs, np.abs(gref).sum(), rtol=1e-4,
                               atol=1e-7)
