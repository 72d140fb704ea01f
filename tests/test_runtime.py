"""Process set-up: compile cache, device check, native build."""

import os

import jax
import pytest

from homulator_tpu import native, runtime


def test_cache_follows_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper uses it and sets no
    config of its own."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = runtime.enable_compile_cache()
        assert path == os.path.join(runtime.ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_require_gpu_raises_on_cpu():
    """Measurement paths refuse the CPU instead of falling back to it."""
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


def test_native_build_is_keyed_and_atomic(monkeypatch, tmp_path):
    """The native library builds under a source-hash name via a temporary
    file that is renamed into place (no half-written library is ever
    visible under the final name); a second call reuses it."""
    monkeypatch.setattr(native, "build_dir", lambda: str(tmp_path))
    calls = []
    real_run = native.subprocess.run

    def run(cmd, **kw):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        assert out.endswith(".tmp") and not os.path.exists(out[:-4])
        return real_run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", run)
    if native.shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler")
    path = native.build()
    assert os.path.exists(path) and "libckks_core-" in path
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert native.build() == path and len(calls) == 1


def test_native_build_without_openmp(monkeypatch, tmp_path):
    """A compiler that cannot link OpenMP still builds the library, single-
    threaded (the pragmas are ignored), and it loads."""
    if native.shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler")
    monkeypatch.setattr(native, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(native, "_OPENMP", ["-fno-such-flag-here"])
    path = native.build()
    assert os.path.exists(path)
    import ctypes

    assert ctypes.CDLL(path).ckks_core_version() > 0
