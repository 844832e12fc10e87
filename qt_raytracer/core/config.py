"""Render configuration.

Subsumes the reference's three config tiers (CLI flag, QML-validated runtime
properties, CMake build options — ``src/app/main.cpp:112-121``,
``resources/qml/Main.qml:55-102``, ``src/app/RayTracerFboItem.cpp:189-228``)
into one frozen dataclass with the same clamping rules, passed to ``jit`` as a
static argument.
"""

from __future__ import annotations

import dataclasses

# Validation ranges mirrored from the reference UI
# (resources/qml/Main.qml:394,426,458,491 and RayTracerFboItem.cpp:189-228).
MIN_DIM = 1          # item setters clamp to >=64; QML allows >=100; we allow tiny test images
MAX_WIDTH = 3840
MAX_HEIGHT = 2160
MIN_SPP = 1
MAX_SPP = 1000
MIN_DEPTH = 1
MAX_DEPTH = 100

# AA presets (resources/qml/Main.qml:91-102).
AA_PRESETS = {"low": 8, "medium": 24, "high": 64}


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (hashable; used as a jit static arg).

    Defaults match the reference QML panel (resources/qml/Main.qml:10-13):
    400x225, 24 spp, max depth 10.
    """

    width: int = 400
    height: int = 225
    spp: int = 24
    max_depth: int = 10
    # t interval for valid hits; 1e-3 is the reference's shadow-acne epsilon
    # (include/raytracer/RayTracer.h:585).
    t_min: float = 1.0e-3
    # Quantizer variant: "cpu" = int(256*clamp(c,0,.999))  (RayTracerFboItem.cpp:115-127)
    #                    "gpu" = uint(c*255)               (GpuPathTracer.cpp shader out)
    quantizer: str = "cpu"
    # How many samples to trace per scan step of the sample loop. Larger values
    # give XLA bigger fused batches (better device occupancy on small images)
    # at the cost of 'samples_per_batch' times the ray-state memory.
    samples_per_batch: int = 1
    # Russian roulette: probabilistically terminate low-energy paths from
    # this bounce on (0 = off = reference semantics). Unbiased (throughput
    # compensated); big speedup at high max_depth.
    rr_start: int = 0
    # RNG: "threefry" (jax counter-based, gold standard) or "hash"
    # (lowbias32 counter hash, far cheaper per bounce than threefry, same
    # shard-invariance; quality validated by tests). Both are deterministic
    # functions of (key, pixel, sample, bounce, slot).
    rng: str = "threefry"
    # Next-event estimation: sample emissive spheres directly at diffuse hits
    # (shadow-ray wavefront per bounce). Unbiased; essential for enclosed
    # emissive scenes (BASELINE config 2 Cornell box). Default off to match
    # the reference's pure BSDF-sampling transport.
    nee: bool = False
    # Closest-hit search: "auto" (the Pallas kernels on a GPU, xla
    # elsewhere), "xla", "pallas" (GPU only), or "pallas_interpret" (the
    # kernels in the Pallas interpreter, for CPU tests).
    intersector: str = "auto"
    # Trace pixels in chunks of this many rays (lax.scan over chunks).
    # Bounds the per-bounce working set: at 1080p the unchunked ray state +
    # intersection intermediates exceed what stays cache-friendly in HBM
    # traffic terms. 0 = auto (the chooseTileSize analog,
    # RayTracerFboItem.cpp:793-820: ~400Ki-ray chunks, unchunked below
    # 256Ki rays — see
    # core/render.resolve_pixel_chunk); -1 = never chunk; >0 = explicit.
    pixel_chunk: int = 0
    # Edge-aware (silhouette) gradients: add the primal-zero screen-space
    # boundary term of diff/edge.py to every primary sample. Forward images
    # are UNCHANGED (the term is exactly zero in the primal); gradients gain
    # the visibility-discontinuity contribution that the detached-decision
    # pathwise estimator drops. Every trace of the term uses the resolved
    # intersector (the kernels carry per-lane exclusion operands). Requires
    # samples_per_batch == 1.
    edge_aware: bool = False

    def __post_init__(self):
        object.__setattr__(self, "width", _clamp(self.width, MIN_DIM, MAX_WIDTH))
        object.__setattr__(self, "height", _clamp(self.height, MIN_DIM, MAX_HEIGHT))
        object.__setattr__(self, "spp", _clamp(self.spp, MIN_SPP, MAX_SPP))
        object.__setattr__(self, "max_depth", _clamp(self.max_depth, MIN_DEPTH, MAX_DEPTH))
        if self.quantizer not in ("cpu", "gpu"):
            raise ValueError(f"quantizer must be 'cpu' or 'gpu', got {self.quantizer!r}")
        if self.intersector not in ("auto", "xla", "pallas",
                                    "pallas_interpret"):
            raise ValueError(f"unknown intersector {self.intersector!r}")
        if self.rng not in ("threefry", "hash"):
            raise ValueError(f"unknown rng {self.rng!r}")
        if self.pixel_chunk < -1:
            raise ValueError(f"pixel_chunk must be >= -1, got {self.pixel_chunk}")
        if self.edge_aware and self.samples_per_batch != 1:
            # Clamp, don't throw (the reference clamps every panel input,
            # RayTracerFboItem.cpp:189-228): the boundary term needs
            # per-sample pixel coordinates, so edge-aware renders trace one
            # sample per scan step.
            object.__setattr__(self, "samples_per_batch", 1)
        if self.spp % self.samples_per_batch != 0:
            # round batch down to a divisor of spp so the scan is exact
            spb = self.samples_per_batch
            while self.spp % spb != 0:
                spb -= 1
            object.__setattr__(self, "samples_per_batch", spb)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height


def _clamp(x: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, int(x)))
