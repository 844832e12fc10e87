"""Interactive viewer controller tests (no TTY: the key stream is scripted).

Covers the L6 control-loop semantics: rig<->Camera round trip, reset-on-move
(resetAccumulation analog, GpuPathTracer.cpp:85-95), idle refinement
accumulating like the progressive path, and the quit/save protocol.
"""

import numpy as np
import pytest

from qt_raytracer.app.interactive import InteractiveViewer, rig_from_camera
from qt_raytracer.core.config import RenderConfig
from qt_raytracer.models import scenes


@pytest.fixture(scope="module")
def setup():
    cfg = RenderConfig(width=64, height=36, spp=4, max_depth=3)
    scene, camera = scenes.get_scene("three_sphere", cfg.aspect_ratio)
    return cfg, scene, camera


def test_rig_roundtrip(setup):
    # Every stored Camera field must survive rig extraction + rebuild.
    cfg, scene, camera = setup
    rig = rig_from_camera(camera, float(cfg.aspect_ratio))
    rebuilt = rig.camera()
    for field in ("origin", "lower_left_corner", "horizontal", "vertical",
                  "u", "v", "w", "lens_radius"):
        np.testing.assert_allclose(np.asarray(getattr(rebuilt, field)),
                                   np.asarray(getattr(camera, field)),
                                   rtol=1e-5, atol=1e-6, err_msg=field)


def test_move_resets_and_idle_accumulates(setup):
    cfg, scene, camera = setup
    v = InteractiveViewer(scene, camera, cfg, seed=0)
    assert v.step() and v.renderer.frame_index == 1
    assert v.step() and v.renderer.frame_index == 2

    before = v.rig.lookfrom.copy()
    assert v.handle_key("w") == "moved"
    assert not np.allclose(v.rig.lookfrom, before)
    assert v.step()                       # reset-on-move, then 1 fresh spp
    assert v.renderer.frame_index == 1

    # Idle refinement runs to max_spp, then step() reports converged.
    while v.step():
        pass
    assert v.renderer.frame_index == cfg.spp
    assert not v.step()


def test_turn_zoom_home_quit(setup):
    cfg, scene, camera = setup
    v = InteractiveViewer(scene, camera, cfg)
    yaw0, vfov0 = v.rig.yaw, v.rig.vfov
    assert v.handle_key("j") == "moved" and v.rig.yaw < yaw0
    assert v.handle_key("+") == "moved" and v.rig.vfov < vfov0
    assert v.handle_key("]") == "moved" and v.rig.aperture > 0
    assert v.handle_key("0") == "moved"
    assert v.rig.yaw == pytest.approx(yaw0)
    assert v.rig.vfov == pytest.approx(vfov0)
    assert v.handle_key("?") == "noop"
    assert v.handle_key("q") == "quit"
    assert v.handle_key("\x1b") == "quit"


def test_frame_renders_ansi_hud(setup):
    cfg, scene, camera = setup
    v = InteractiveViewer(scene, camera, cfg)
    v.step()
    out = v.frame(cols=40)
    assert "\x1b[38;2;" in out            # truecolor viewport
    assert "spp" in out and "Msamples/s" in out


def test_mesh_world_controller_smoke():
    # The viewer must drive MESH WORLDS, not just
    # SphereScenes — catches World-vs-SphereScene regressions in the
    # viewer path (rig extraction, reset-on-move, ANSI frame) on the true
    # Cornell box (models/scenes.py cornell_mesh).
    cfg = RenderConfig(width=32, height=18, spp=2, max_depth=2)
    scene, camera = scenes.get_scene("cornell_mesh", cfg.aspect_ratio)
    v = InteractiveViewer(scene, camera, cfg, seed=1)
    assert v.step() and v.renderer.frame_index == 1
    assert v.handle_key("w") == "moved"
    assert v.step() and v.renderer.frame_index == 1   # reset-on-move
    out = v.frame(cols=24)
    assert "\x1b[38;2;" in out and "spp" in out
    img = np.asarray(v.renderer.image())
    assert np.isfinite(img).all() and img.max() > 0.0


def test_move_matches_fresh_render(setup):
    # After flying somewhere, the accumulation must equal a from-scratch
    # progressive render with the same camera/seed (no stale state).
    cfg, scene, camera = setup
    v = InteractiveViewer(scene, camera, cfg, seed=3)
    v.step()
    for ch in "wwjli":
        v.handle_key(ch)
    v.step()
    v.step()

    from qt_raytracer.app.progressive import ProgressiveRenderer

    fresh = ProgressiveRenderer(scene, v.rig.camera(), cfg, seed=3)
    fresh.step(1)
    fresh.step(1)
    np.testing.assert_array_equal(v.renderer.image(), fresh.image())


@pytest.mark.slow
def test_run_interactive_termios_loop_under_pty():
    # The REAL raw-mode loop (termios/select plumbing, previously the one
    # untested surface): drive
    # the CLI interactive command inside a pty, let it draw at least one
    # ANSI frame, send a movement key and 'q', and require a clean exit
    # with restored terminal state. Marked slow: subprocess compile can
    # take minutes on a cold cache; deselect with -m "not slow".
    import os
    pty = pytest.importorskip("pty")
    if not hasattr(pty, "openpty"):
        pytest.skip("pty.openpty unavailable on this platform")
    import select as sel
    import subprocess
    import sys
    import time

    env = {k: v for k, v in os.environ.items()}
    env["PYTHONPATH"] = ""
    env["JAX_PLATFORMS"] = "cpu"
    mfd, sfd = pty.openpty()
    p = subprocess.Popen(
        [sys.executable, "-m", "qt_raytracer.app.cli", "interactive",
         "--scene", "three_sphere", "--width", "16", "--height", "12",
         "--spp", "2", "--ansi-cols", "24"],
        stdin=sfd, stdout=sfd, stderr=sfd, env=env, close_fds=True)
    os.close(sfd)
    out = b""
    deadline = time.time() + 240
    sent_quit = False
    try:
        while time.time() < deadline and p.poll() is None:
            r, _, _ = sel.select([mfd], [], [], 0.5)
            if r:
                try:
                    out += os.read(mfd, 65536)
                except OSError:
                    break
            if not sent_quit and b"\x1b[" in out and b"Msamples" in out:
                os.write(mfd, b"w")          # dolly: must reset accumulation
                time.sleep(1.0)
                os.write(mfd, b"q")
                sent_quit = True
        if p.poll() is None and not sent_quit:
            os.write(mfd, b"q")
        # quitting happens between render steps; allow stragglers and
        # re-send q in case the first landed mid-compile
        for _ in range(36):
            if p.poll() is not None:
                break
            try:
                os.write(mfd, b"q")
            except OSError:
                pass
            r, _, _ = sel.select([mfd], [], [], 0.2)
            if r:
                try:
                    out += os.read(mfd, 65536)
                except OSError:
                    pass
            time.sleep(4.8)
        rc = p.wait(timeout=30)
    finally:
        os.close(mfd)
        if p.poll() is None:
            p.kill()
    assert sent_quit, out[-500:]
    assert rc == 0, (rc, out[-500:])
    assert b"\x1b[?25h" in out      # cursor restored on exit
