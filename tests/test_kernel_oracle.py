"""Oracle goldens through the kernel path: the standard integrator with both
Pallas kernels (intersector="pallas_interpret") against the scalar float64
oracle, with the same tolerances as the XLA path's goldens
(tests/test_oracle_golden.py). Kernel and XLA search differ only at
FMA-contraction ulp level, which can flip a stochastic branch for a
borderline sample, so a small mismatch fraction is budgeted."""

import jax
import numpy as np
import pytest

from qt_raytracer import RenderConfig, render_linear
from qt_raytracer.models import scenes
from qt_raytracer.testing import oracle


def _cfg(**kw):
    return RenderConfig(intersector="pallas_interpret", **kw)


@pytest.mark.parametrize("scene_name,cfg,max_mismatch", [
    ("three_sphere", _cfg(width=16, height=12, spp=2, max_depth=4), 0.01),
    ("four_sphere_gpu", _cfg(width=16, height=12, spp=2, max_depth=4), 0.01),
    ("glossy_dof", _cfg(width=16, height=12, spp=2, max_depth=6), 0.01),
    ("cornell", _cfg(width=12, height=12, spp=2, max_depth=5, nee=True),
     0.03),
    ("cornell", _cfg(width=12, height=12, spp=2, max_depth=6, nee=True,
                     rr_start=2, rng="hash"), 0.03),
], ids=["three_sphere", "four_sphere_gpu", "glossy_dof", "cornell_nee",
        "cornell_nee_rr_hash"])
def test_kernel_path_matches_oracle(scene_name, cfg, max_mismatch):
    scene, cam = scenes.get_scene(scene_name, cfg.aspect_ratio, pad_to=None)
    key = jax.random.PRNGKey(0)
    got = np.asarray(render_linear(scene, cam, cfg, key), np.float64)
    want = oracle.render_oracle_linear(scene, cam, cfg, key)
    got /= cfg.spp
    want /= cfg.spp
    mismatch = np.abs(got - want) > (4e-3 + 4e-3 * np.abs(want))
    assert mismatch.mean() <= max_mismatch, (
        f"mismatch fraction {mismatch.mean():.4f} > {max_mismatch}")
