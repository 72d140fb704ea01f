"""Test configuration: the CPU backend with 8 virtual devices.

Tests run on the CPU — including the multi-device sharding tests, which
use 8 virtual host devices (SURVEY.md §4 test strategy). jax.config.update
happens before any backend is initialized. Tests marked `gpu` need the
card: the `gpu` fixture skips them here, and chip_smoke.py runs them in
its own process, whose GPU backend is already up (a platform update after
backend initialization changes nothing).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from homulator_tpu.api import CkksEngine  # noqa: E402
from homulator_tpu.params import CkksParams, get_params  # noqa: E402


@pytest.fixture
def gpu():
    """The first JAX device, or a skip when it is not a GPU (decided here,
    at run time, never while a module is imported)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: the CUDA leaf has no CPU or interpret mode")
    return dev


@pytest.fixture(scope="session")
def small_params() -> CkksParams:
    """Small but structurally complete: 3 digits incl. a partial one."""
    return get_params(n=64, max_level=6, alpha=2)


@pytest.fixture(scope="session")
def small_engine(small_params) -> CkksEngine:
    eng = CkksEngine(small_params, seed=7)
    eng.keygen()
    return eng


@pytest.fixture(scope="session")
def medium_params() -> CkksParams:
    """Odd log2(N) so n1 != n2, alpha not dividing level."""
    return get_params(n=128, max_level=5, alpha=3)


@pytest.fixture(scope="session")
def medium_engine(medium_params) -> CkksEngine:
    eng = CkksEngine(medium_params, seed=11)
    eng.keygen()
    return eng


def random_limbs(params, idx, rng) -> np.ndarray:
    return np.stack(
        [rng.integers(0, int(q), size=params.n, dtype=np.uint64) for q in params.q_arr[idx]]
    )
