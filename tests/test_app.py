"""App layer: progressive accumulation, checkpoint/resume, CLI, stats."""

import json

import jax
import numpy as np
import pytest

from qt_raytracer import RenderConfig, render_linear
from qt_raytracer.app.progressive import ProgressiveRenderer
from qt_raytracer.app.stats import RenderStats
from qt_raytracer.models import scenes

CFG = RenderConfig(width=16, height=12, spp=6, max_depth=3)


@pytest.fixture(scope="module")
def scene_cam():
    return scenes.get_scene("three_sphere", CFG.aspect_ratio)


def test_progressive_equals_batch(scene_cam):
    # k progressive steps of n spp must equal one batch render at k*n spp
    # with the same base key (the GPU backends' running-mean accumulation,
    # GpuPathTracer.cpp:279-282, made exactly interchangeable with batch).
    scene, cam = scene_cam
    pr = ProgressiveRenderer(scene, cam, CFG, seed=0)
    pr.step(2)
    pr.step(3)
    pr.step(1)
    assert pr.frame_index == 6
    assert pr.progress == 100.0
    batch = np.asarray(render_linear(scene, cam, CFG, jax.random.PRNGKey(0)))
    np.testing.assert_allclose(np.asarray(pr.state.accum), batch,
                               atol=1e-5, rtol=1e-5)


def test_progressive_reset(scene_cam):
    scene, cam = scene_cam
    pr = ProgressiveRenderer(scene, cam, CFG, seed=0)
    pr.step(2)
    pr.reset()
    assert pr.frame_index == 0
    assert float(np.abs(np.asarray(pr.state.accum)).max()) == 0.0


def test_checkpoint_resume(tmp_path, scene_cam):
    # Interrupt at 3 spp, save, restore into a fresh renderer, finish: must
    # equal the uninterrupted 6-spp accumulation (SURVEY §5: the
    # (accum, count, key) triple IS the checkpoint).
    scene, cam = scene_cam
    pr = ProgressiveRenderer(scene, cam, CFG, seed=0)
    pr.step(3)
    ck = tmp_path / "ckpt"
    pr.save(ck)

    pr2 = ProgressiveRenderer(scene, cam, CFG, seed=99)  # wrong seed on purpose
    pr2.load(ck)
    assert pr2.frame_index == 3 and pr2.state.seed == 0
    pr2.step(3)

    full = ProgressiveRenderer(scene, cam, CFG, seed=0)
    full.step(6)
    np.testing.assert_allclose(np.asarray(pr2.state.accum),
                               np.asarray(full.state.accum),
                               atol=1e-5, rtol=1e-5)


def test_stats_formulas():
    st = RenderStats(width=400, height=225, spp=24, max_depth=10,
                     elapsed_s=2.0, frames=4, backend="gpu",
                     device_kind="NVIDIA H100 80GB HBM3")
    # W*H*spp/elapsed (RayTracerFboItem.cpp:400-404)
    assert st.msamples_per_s == pytest.approx(400 * 225 * 24 / 2.0 / 1e6)
    assert st.fps == pytest.approx(2.0)
    assert st.mrays_per_s == pytest.approx(st.msamples_per_s * 10)
    assert "Msamples/s" in st.text() and "gpu" in st.text()
    assert "NVIDIA H100 80GB HBM3" in st.text()


def test_cli_render(tmp_path, capsys):
    from qt_raytracer.app.cli import main
    out = tmp_path / "img.png"
    rc = main(["render", "--scene", "three_sphere", "--width", "16",
               "--height", "12", "--spp", "2", "--depth", "3",
               "--backend", "cpu", "--out", str(out)])
    assert rc == 0 and out.exists()
    from PIL import Image
    assert Image.open(out).size == (16, 12)


def test_cli_render_progressive_resume(tmp_path):
    from qt_raytracer.app.cli import main
    ck = tmp_path / "ck"
    out1 = tmp_path / "a.png"
    args = ["render", "--scene", "three_sphere", "--width", "16",
            "--height", "12", "--spp", "4", "--depth", "3",
            "--backend", "cpu", "--progressive", "--batch", "2",
            "--checkpoint", str(ck)]
    assert main(args + ["--out", str(out1)]) == 0
    # resume from the finished checkpoint: adds nothing (already at spp)
    out2 = tmp_path / "b.png"
    assert main(args + ["--resume", "--out", str(out2)]) == 0
    from PIL import Image
    np.testing.assert_array_equal(np.asarray(Image.open(out1)),
                                  np.asarray(Image.open(out2)))


def test_cli_bench_json(capsys):
    from qt_raytracer.app.cli import main
    rc = main(["bench", "--scene", "three_sphere", "--width", "16",
               "--height", "12", "--spp", "2", "--depth", "3",
               "--backend", "cpu", "--iters", "1"])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    data = json.loads(line)
    assert data["msamples_per_s"] > 0


def test_letterbox_aspect_preserved():
    from qt_raytracer.app.preview import letterbox
    img = np.full((100, 200, 3), 255, np.uint8)  # 2:1 source
    out = letterbox(img, 100, 100)               # square target
    assert out.shape == (100, 100, 3)
    # vertical black bars above/below a 100x50 fitted image
    assert out[:24].max() == 0 and out[-24:].max() == 0
    assert out[50].max() == 255


def test_ansi_frame_shape():
    from qt_raytracer.app.preview import ansi_frame
    img = np.random.default_rng(0).integers(0, 255, (30, 40, 3), np.uint8)
    s = ansi_frame(img, cols=20)
    lines = s.split("\n")
    assert all("▀" in ln for ln in lines)
    assert len(lines) >= 4


def test_run_preview_smoke(tmp_path, scene_cam):
    from qt_raytracer.app.preview import run_preview
    import io
    scene, cam = scene_cam
    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=2)
    buf = io.StringIO()
    out = tmp_path / "prev.png"
    pr = run_preview(scene, cam, cfg, batch=1, out_path=str(out),
                     ansi=False, stream=buf)
    assert pr.frame_index == 2 and out.exists()
    assert "progress 100.0%" in buf.getvalue()


def test_cli_aa_preset(tmp_path):
    from qt_raytracer.app.cli import build_parser
    args = build_parser().parse_args(
        ["render", "--aa", "high", "--out", str(tmp_path / "x.png")])
    from qt_raytracer.app.cli import _build_cfg
    assert _build_cfg(args).spp == 64
