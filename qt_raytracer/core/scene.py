"""SoA scene representation.

The reference keeps FOUR independent scene copies — a pointer-chasing
``HitableList`` of ``shared_ptr<Hitable>`` on the CPU (RayTracer.h:324-372,
599-643) and a hardcoded 4-sphere array in each GPU kernel
(src/backends/GpuPathTracer.cpp:217-240, CudaPathTracerKernel.cu:113-116,
resources/shaders/pathtrace_vulkan.comp:70-105). This framework unifies them
into ONE structure-of-arrays pytree: spheres are parallel arrays, materials are
per-primitive parameter arrays selected by an integer tag. This is what lets
intersection run as one fused [N,S] search or one GPU kernel and materials
evaluate as masked vector ops — no virtual dispatch, no pointers.

Material tags:
    0 = Lambertian  (albedo)                RayTracer.h:473-488
    1 = Metal       (albedo, fuzz<=1)       RayTracer.h:490-504
    2 = Dielectric  (ior; white attenuation) RayTracer.h:506-540
    3 = Emissive    (emission; north-star NEE extension, no reference analog)
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils.pytree import pytree_dataclass

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
EMISSIVE = 3


@pytree_dataclass
class SphereScene:
    """Structure-of-arrays sphere scene; every field is differentiable.

    S = number of sphere slots (may include inactive padding so scenes of
    similar size share one compiled shape).
    """

    center: jnp.ndarray    # [S, 3] f32
    radius: jnp.ndarray    # [S]    f32
    mat_type: jnp.ndarray  # [S]    i32 material tag
    albedo: jnp.ndarray    # [S, 3] f32 (lambertian/metal)
    fuzz: jnp.ndarray      # [S]    f32 (metal; pre-clamped <= 1)
    ior: jnp.ndarray       # [S]    f32 (dielectric)
    emission: jnp.ndarray  # [S, 3] f32 (emissive radiance)
    active: jnp.ndarray    # [S]    bool (False for padding slots)
    light_idx: jnp.ndarray  # [L] i32 indices of emissive spheres (shape [0]
    #                         if none); static shape L = host-known light
    #                         count, used by next-event estimation

    @property
    def num_spheres(self) -> int:
        return self.center.shape[0]

    @property
    def num_lights(self) -> int:
        """Static light count (shape of the emissive-sphere index table)."""
        return self.light_idx.shape[0]

    # Backward-compatible alias (pre-round-2 name).
    max_lights = num_lights


def _morton_order(centers: np.ndarray) -> np.ndarray:
    """Sort order along a 3D Morton (Z-order) curve, 10 bits per axis."""
    lo = centers.min(0)
    span = np.maximum(centers.max(0) - lo, 1e-12)
    q = np.clip(((centers - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))
    return np.argsort(code, kind="stable")


class SceneBuilder:
    """Host-side accumulation of primitives, then freeze to a SphereScene.

    Plays the role of HitableList::add (RayTracer.h:330) at build time only;
    the frozen SoA is what crosses into jit.
    """

    def __init__(self):
        self._rows = []  # (center, radius, mat_type, albedo, fuzz, ior, emission)

    def add_sphere(self, center, radius, mat_type=LAMBERTIAN,
                   albedo=(0.0, 0.0, 0.0), fuzz=0.0, ior=1.0,
                   emission=(0.0, 0.0, 0.0)) -> "SceneBuilder":
        # Metal constructor clamps fuzz to <= 1 (RayTracer.h:492).
        fuzz = min(float(fuzz), 1.0)
        self._rows.append((tuple(center), float(radius), int(mat_type),
                           tuple(albedo), float(fuzz), float(ior), tuple(emission)))
        return self

    def lambertian(self, center, radius, albedo):
        return self.add_sphere(center, radius, LAMBERTIAN, albedo=albedo)

    def metal(self, center, radius, albedo, fuzz=0.0):
        return self.add_sphere(center, radius, METAL, albedo=albedo, fuzz=fuzz)

    def dielectric(self, center, radius, ior=1.5):
        return self.add_sphere(center, radius, DIELECTRIC, ior=ior)

    def emissive(self, center, radius, emission):
        return self.add_sphere(center, radius, EMISSIVE, emission=emission)

    def build(self, pad_to: int | None = 128, dtype=jnp.float32,
              spatial_sort: bool | None = None) -> SphereScene:
        """Freeze to SoA. pad_to: round S up to a multiple (lane alignment);
        padded slots are inactive and never hit.

        spatial_sort: Morton-order the spheres so consecutive rows are
        spatially coherent — this is what makes the Pallas kernel's cluster
        culling effective. Default: auto (on for scenes with >= 64 spheres;
        small scenes keep insertion order so index-based tests/tooling stay
        stable). Sorting changes primitive ids but not rendered images
        (closest-hit ties aside, which are measure-zero).
        """
        n = len(self._rows)
        if n == 0:
            raise ValueError("scene has no primitives")
        if spatial_sort is None:
            spatial_sort = n >= 64
        if spatial_sort and n > 1:
            centers = np.array([r[0] for r in self._rows], np.float64)
            order = _morton_order(centers)
            self._rows = [self._rows[i] for i in order]
        total = n
        if pad_to:
            total = ((n + pad_to - 1) // pad_to) * pad_to
        center = np.zeros((total, 3), np.float64)
        radius = np.zeros((total,), np.float64)
        mat_type = np.zeros((total,), np.int32)
        albedo = np.zeros((total, 3), np.float64)
        fuzz = np.zeros((total,), np.float64)
        ior = np.ones((total,), np.float64)
        emission = np.zeros((total, 3), np.float64)
        active = np.zeros((total,), bool)
        for i, (c, r, mt, alb, fz, io, em) in enumerate(self._rows):
            center[i] = c
            radius[i] = r
            mat_type[i] = mt
            albedo[i] = alb
            fuzz[i] = fz
            ior[i] = io
            emission[i] = em
            active[i] = True
        # Park padding far away so degenerate zero-radius tangent hits are impossible.
        center[n:] = 1.0e9
        # Static light table for NEE: indices of emissive spheres (shape [0]
        # when none — NEE is then compiled out entirely).
        lights = np.nonzero(mat_type == EMISSIVE)[0].astype(np.int32)
        return SphereScene(
            center=jnp.asarray(center, dtype),
            radius=jnp.asarray(radius, dtype),
            mat_type=jnp.asarray(mat_type),
            albedo=jnp.asarray(albedo, dtype),
            fuzz=jnp.asarray(fuzz, dtype),
            ior=jnp.asarray(ior, dtype),
            emission=jnp.asarray(emission, dtype),
            active=jnp.asarray(active),
            light_idx=jnp.asarray(lights),
        )
