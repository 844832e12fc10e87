"""Progressive rendering with checkpoint/resume.

Subsumes the reference's progressive GPU mode — 1 spp per frame with a
running-mean accumulation image and reset support (GpuPathTracer.cpp:279-282,
resetAccumulation :85-95, frame loop RayTracerFboItem.cpp:467-494) — and adds
what the reference lacks (SURVEY.md §5): the accumulator state
(accum_sum, sample_count, base_key) IS a checkpoint, one .npz file
(runtime/checkpoint.py), so long renders survive restarts and can migrate
hosts.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import tonemap
from ..core.config import RenderConfig
from ..core.render import render_sample_batch


@dataclasses.dataclass
class ProgressiveState:
    """Resumable accumulator: linear radiance SUM (not mean) + sample count."""

    accum: jnp.ndarray      # [H, W, 3] f32 sum of samples
    sample_count: int
    seed: int               # base key seed (stored, key re-derived)


class ProgressiveRenderer:
    """Stateful progressive renderer: call step() per "frame".

    Matches the GPU backends' accumulation semantics exactly: after k steps of
    n spp each, the displayed image equals a batch render at k*n spp with the
    same base key (render modes are interchangeable — tested).
    """

    def __init__(self, scene, camera, cfg: RenderConfig, seed: int = 0):
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.seed = seed
        self.reset()

    def reset(self) -> None:
        """resetAccumulation (GpuPathTracer.cpp:85-95)."""
        self.state = ProgressiveState(
            accum=jnp.zeros((self.cfg.height, self.cfg.width, 3), jnp.float32),
            sample_count=0,
            seed=self.seed,
        )

    @property
    def frame_index(self) -> int:
        """Progressive frame counter (CudaPathTracer frameIndex analog)."""
        return self.state.sample_count

    @property
    def progress(self) -> float:
        """Percent of cfg.spp completed (RayTracerFboItem.cpp:469-471)."""
        return min(100.0, 100.0 * self.state.sample_count / self.cfg.spp)

    def step(self, num_samples: int = 1) -> jnp.ndarray:
        """Trace num_samples more spp; returns current mean linear image."""
        key = jax.random.PRNGKey(self.state.seed)
        batch = render_sample_batch(
            self.scene, self.camera, self.cfg, key,
            jnp.int32(self.state.sample_count), num_samples)
        self.state = ProgressiveState(
            accum=self.state.accum + batch,
            sample_count=self.state.sample_count + num_samples,
            seed=self.state.seed,
        )
        return self.state.accum / max(self.state.sample_count, 1)

    def image(self) -> np.ndarray:
        """Current tonemapped uint8 image [H, W, 3]."""
        n = max(self.state.sample_count, 1)
        return np.asarray(tonemap.to_uint8(self.state.accum, n,
                                           self.cfg.quantizer))

    # ------------------------------------------------------------ checkpoint
    def save(self, path: str | Path) -> None:
        """Serialize the resumable triple (runtime/checkpoint.py)."""
        from ..runtime.checkpoint import save_pytree

        save_pytree(path, self._as_tree(self.state))

    def load(self, path: str | Path) -> None:
        from ..runtime.checkpoint import load_pytree

        restored = load_pytree(path, self._as_tree(self.state))
        self.state = ProgressiveState(
            accum=restored["accum"],
            sample_count=int(restored["sample_count"]),
            seed=int(restored["seed"]),
        )
        self.seed = self.state.seed

    @staticmethod
    def _as_tree(state: ProgressiveState) -> dict:
        return {"accum": state.accum,
                "sample_count": np.int64(state.sample_count),
                "seed": np.int64(state.seed)}
