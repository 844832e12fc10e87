"""Tonemap quantizers and config clamping — ports the reference's two
quantizer formulas (RayTracerFboItem.cpp:115-127 vs GPU shaders) and the
QML/setter validation rules (Main.qml:394-491, RayTracerFboItem.cpp:189-228)."""

import jax.numpy as jnp
import numpy as np
import pytest

from qt_raytracer import AA_PRESETS, RenderConfig, tonemap


def test_cpu_quantizer_exact():
    # int(256 * clamp(c, 0, 0.999))
    g = jnp.array([[-0.5, 0.0, 0.25, 0.999, 1.0, 2.0]])
    q = np.asarray(tonemap.quantize(g, "cpu"))
    np.testing.assert_array_equal(q[0], [0, 0, 64, 255, 255, 255])


def test_gpu_quantizer_exact():
    # uint(c * 255)
    g = jnp.array([[-0.5, 0.0, 0.25, 1.0, 2.0]])
    q = np.asarray(tonemap.quantize(g, "gpu"))
    np.testing.assert_array_equal(q[0], [0, 0, 63, 255, 255])


def test_resolve_gamma2():
    # mean over spp then sqrt (gamma 2), RayTracerFboItem.cpp:115-118.
    accum = jnp.full((2, 2, 3), 8.0)
    out = np.asarray(tonemap.resolve(accum, 2))
    np.testing.assert_allclose(out, 2.0, atol=1e-6)


def test_config_clamps():
    cfg = RenderConfig(width=100000, height=0, spp=5000, max_depth=0)
    assert cfg.width == 3840 and cfg.height == 1
    assert cfg.spp == 1000 and cfg.max_depth == 1


def test_config_defaults_match_reference_panel():
    cfg = RenderConfig()
    assert (cfg.width, cfg.height, cfg.spp, cfg.max_depth) == (400, 225, 24, 10)


def test_aa_presets():
    assert AA_PRESETS == {"low": 8, "medium": 24, "high": 64}


def test_bad_quantizer_rejected():
    with pytest.raises(ValueError):
        RenderConfig(quantizer="hdr")


def test_samples_per_batch_rounded_to_divisor():
    cfg = RenderConfig(spp=24, samples_per_batch=7)
    assert cfg.spp % cfg.samples_per_batch == 0


def test_pixel_chunk_auto_heuristic():
    # The chooseTileSize analog: 0 = auto, -1 = off.
    from qt_raytracer.core.render import resolve_pixel_chunk
    from qt_raytracer.core.config import RenderConfig
    # Small images: one launch already underfills the chip -> no chunking.
    assert resolve_pixel_chunk(RenderConfig(width=400, height=225)) == 0
    # 1080p: ~400Ki-ray chunks, multiples of the 1024-ray kernel tile.
    c = resolve_pixel_chunk(RenderConfig(width=1920, height=1080))
    assert c == 414720 and c % 1024 == 0
    # 4K: still chunked in tile multiples covering the image.
    c4 = resolve_pixel_chunk(RenderConfig(width=3840, height=2160))
    assert c4 % 1024 == 0 and 0 < c4 <= 3840 * 2160
    # Explicit values pass through; -1 disables.
    assert resolve_pixel_chunk(
        RenderConfig(width=1920, height=1080, pixel_chunk=2048)) == 2048
    assert resolve_pixel_chunk(
        RenderConfig(width=1920, height=1080, pixel_chunk=-1)) == 0
