"""Platform selection: which search runs where, the CLI's --backend, the
compile-cache placement, and checkpoint files. No GPU is needed: the
platform is simulated with monkeypatch."""

import jax
import numpy as np
import pytest

from qt_raytracer import RenderConfig
from qt_raytracer.core import render as render_mod
from qt_raytracer.runtime import compile_cache


@pytest.mark.parametrize("platform,requested,expected", [
    ("gpu", "auto", "pallas"),
    ("cpu", "auto", "xla"),
    ("gpu", "xla", "xla"),
    ("gpu", "pallas", "pallas"),
    ("cpu", "pallas_interpret", "pallas_interpret"),
])
def test_resolve_intersector(monkeypatch, platform, requested, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    cfg = RenderConfig(intersector=requested)
    assert render_mod.resolve_intersector(cfg) == expected


def test_pallas_off_gpu_raises(monkeypatch):
    # Never a quiet drop into the interpreter.
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    with pytest.raises(ValueError, match="needs a GPU"):
        render_mod.resolve_intersector(RenderConfig(intersector="pallas"))


def test_removed_intersectors_rejected():
    with pytest.raises(ValueError, match="unknown intersector"):
        RenderConfig(intersector="fused")


def test_cli_backend_gpu_without_gpu_fails(monkeypatch):
    from qt_raytracer.app.cli import main
    # Keep the test process's JAX config: no persistent cache switched on.
    monkeypatch.setattr(compile_cache, "enable_compilation_cache",
                        lambda: None)
    with pytest.raises(SystemExit, match="no GPU"):
        main(["bench", "--scene", "three_sphere", "--width", "8",
              "--height", "8", "--spp", "1", "--depth", "1",
              "--backend", "gpu"])


@pytest.mark.parametrize("requested", ["auto", "gpu", "cpu"])
def test_cli_select_backend_reports_platform(monkeypatch, requested):
    from qt_raytracer.app import cli
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append((k, v)))
    monkeypatch.setattr(jax, "devices", lambda *a: ["dev"])
    monkeypatch.setattr(jax, "default_backend",
                        lambda: "cpu" if requested == "cpu" else "gpu")
    assert cli._select_backend(requested) == (
        "cpu" if requested == "cpu" else "gpu")
    # Only an explicit --backend cpu pins the host platform.
    assert (("jax_platforms", "cpu") in updates) == (requested == "cpu")


def test_compile_cache_in_checkout_by_default(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(compile_cache, "_ENABLED_DIR", None)
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    used = compile_cache.enable_compilation_cache()
    repo = compile_cache.CACHE_DIR.parent
    assert used == str(repo / ".jax_cache")
    assert updates["jax_compilation_cache_dir"] == used
    assert (repo / "qt_raytracer").is_dir()


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(compile_cache, "_ENABLED_DIR", None)
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    assert compile_cache.enable_compilation_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in updates


def test_checkpoint_checks_structure(tmp_path):
    from qt_raytracer.runtime.checkpoint import load_pytree, save_pytree
    tree = {"a": np.arange(3.0), "b": (np.int64(7), np.ones((2, 2)))}
    path = tmp_path / "ck"
    save_pytree(path, tree)
    assert [p.name for p in tmp_path.iterdir()] == ["ck"]   # no temp left
    back = load_pytree(path, tree)
    np.testing.assert_array_equal(back["b"][1], tree["b"][1])
    assert int(back["b"][0]) == 7
    with pytest.raises(ValueError, match="different pytree structure"):
        load_pytree(path, {"a": np.arange(3.0)})
