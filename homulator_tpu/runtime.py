"""Process set-up shared by every entry point: the checkout's build
directory, JAX's persistent compile cache, and the device check that
measurement paths use instead of falling back to the CPU."""

from __future__ import annotations

import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_dir() -> str:
    """<checkout>/build: compiled native and CUDA libraries (gitignored)."""
    path = os.path.join(ROOT, "build")
    os.makedirs(path, exist_ok=True)
    return path


def enable_compile_cache() -> str:
    """Use $JAX_COMPILATION_CACHE_DIR when set (JAX reads it itself; nothing
    else is set here), else <checkout>/.jax_cache. Returns the directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The first JAX device, which must be a GPU. JAX starts quietly on the
    CPU when its CUDA plugin fails to load, so measurements check this
    instead of trusting the environment."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this path measures the card only")
    return dev
