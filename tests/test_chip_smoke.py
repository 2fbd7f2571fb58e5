"""The GPU entry points refuse to run elsewhere, and every entry point
keeps its compile cache by one rule (compile_cache.py)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from smartedgesensor3dhumanpose_tpu import compile_cache

_REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_REPO))
import bench  # noqa: E402
import chip_smoke  # noqa: E402


def test_chip_smoke_device_guard_raises_on_cpu():
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        chip_smoke.require_gpu()


def test_chip_smoke_alone_exits_nonzero_without_result(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    on a machine without a GPU, it fails and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((_REPO / "chip_smoke.py").read_text())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(lone)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_bench_fails_without_gpu(capsys):
    """bench.py prints its JSON line with the device stamp, then fails."""
    assert bench.main([]) == 1
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"platform": "cpu"' in out and '"errors"' in out
    assert '"value": null' in out


@pytest.fixture
def cache_config():
    """Restore the cache settings enable() touches."""
    names = (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs",
        "jax_persistent_cache_min_entry_size_bytes",
    )
    saved = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


def test_compile_cache_defaults_to_fixed_checkout_dir(
    monkeypatch, cache_config
):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.enable()
    assert path == compile_cache.DEFAULT_DIR == str(_REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in (_REPO / ".gitignore").read_text().split()


def test_compile_cache_honours_env(monkeypatch, tmp_path, cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, enable() names it and sets no
    directory of its own."""
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "/untouched")
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "/untouched"
