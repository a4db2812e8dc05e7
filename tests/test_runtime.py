"""Process set-up of the entry points: compile-cache placement and the
refusal to measure on anything but a GPU."""

import os
import sys

import jax
import pytest

from score_tpu import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_defaults_into_the_checkout(monkeypatch,
                                                  restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.setup_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_env_var_is_left_to_jax(monkeypatch, tmp_path,
                                              restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_require_gpu_refuses_the_cpu(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "")
    with pytest.raises(SystemExit, match="needs a GPU"):
        runtime.require_gpu()
    with pytest.raises(SystemExit, match="needs a GPU"):
        runtime.require_gpu(allow_cpu_dry_run=True)


def test_explicit_cpu_dry_run_is_allowed(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert runtime.require_gpu(allow_cpu_dry_run=True).platform == "cpu"
    with pytest.raises(SystemExit):
        runtime.require_gpu()           # never for chip_smoke


def test_chip_smoke_refuses_without_a_gpu(monkeypatch, capsys):
    sys.path.insert(0, REPO)
    import chip_smoke
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_without_a_gpu(monkeypatch, capsys):
    sys.path.insert(0, REPO)
    import bench
    monkeypatch.setenv("JAX_PLATFORMS", "")
    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.main()
    assert "metric" not in capsys.readouterr().out
