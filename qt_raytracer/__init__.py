"""qt_raytracer — a differentiable path-tracing framework in JAX.

Brand-new JAX/Pallas/pjit framework subsuming the capabilities of the
reference Qt/C++/CUDA path tracer (spirlness/qt-raytracer): one SoA scene
representation, one wavefront integrator lowered by XLA, batch + progressive
rendering, multi-device sharding, and differentiability w.r.t. materials,
emitters and camera.

Public API:
    render(scene, camera, config, key) -> uint8 image [H, W, 3]
    render_linear(...)                 -> f32 linear radiance sum
    RenderConfig, Camera, make_camera, SceneBuilder, SphereScene
    models.scenes — scene zoo (three_sphere, four_sphere_gpu, random,
                    glossy_dof, cornell)
"""

from .accel.mesh import TriangleMesh, build_mesh
from .core.camera import Camera, make_camera
from .core.config import AA_PRESETS, RenderConfig
from .core.render import render, render_linear, render_sample_batch
from .core.scene import (DIELECTRIC, EMISSIVE, LAMBERTIAN, METAL,
                         SceneBuilder, SphereScene)
from .core.world import World, as_world
from .core import tonemap

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "make_camera",
    "RenderConfig",
    "AA_PRESETS",
    "render",
    "render_linear",
    "render_sample_batch",
    "SceneBuilder",
    "SphereScene",
    "World",
    "as_world",
    "TriangleMesh",
    "build_mesh",
    "LAMBERTIAN",
    "METAL",
    "DIELECTRIC",
    "EMISSIVE",
    "tonemap",
]
