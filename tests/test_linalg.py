"""Encrypted linear-algebra primitives (homulator_tpu.linalg) vs the
clear computation."""

import numpy as np
import pytest

from homulator_tpu import linalg
from homulator_tpu.api import CkksEngine
from homulator_tpu.params import get_params


@pytest.fixture(scope="module")
def eng():
    params = get_params(n=256, max_level=8, alpha=4)
    e = CkksEngine(params, seed=17, ntt_mode="montgomery")
    e.keygen()
    return e


def test_bsgs_matvec(eng):
    d, level, scale = 16, 6, 2.0**26
    rng = np.random.default_rng(5)
    M = rng.normal(size=(d, d)) / d
    x = rng.normal(size=d)
    ct = linalg.encrypt_vector(eng, x, level, scale)
    out = linalg.bsgs_matvec(eng, ct, M)
    assert out.level == level - 1
    y = eng.decrypt_complex(out).real[:d]
    assert np.max(np.abs(y - M @ x)) < 1e-2


def test_bsgs_matvec_g1(eng):
    """g=1 (no baby steps, all giant rotations) stays correct."""
    d, level, scale = 8, 6, 2.0**26
    rng = np.random.default_rng(6)
    M = rng.normal(size=(d, d)) / d
    x = rng.normal(size=d)
    ct = linalg.encrypt_vector(eng, x, level, scale)
    y = eng.decrypt_complex(
        linalg.bsgs_matvec(eng, ct, M, g=1)).real[:d]
    assert np.max(np.abs(y - M @ x)) < 1e-2


def test_sum_slots(eng):
    level, scale = 6, 2.0**26
    slots = eng.params.n // 2
    rng = np.random.default_rng(7)
    v = rng.normal(size=slots) / np.sqrt(slots)
    ct = eng.encrypt_complex(v, level, scale)
    out = linalg.sum_slots(eng, ct)
    got = eng.decrypt_complex(out).real
    assert np.max(np.abs(got - v.sum())) < 1e-2


def test_dot_with_bias(eng):
    level, scale = 6, 2.0**26
    slots = eng.params.n // 2
    rng = np.random.default_rng(8)
    x = rng.normal(size=slots) / np.sqrt(slots)
    w = rng.normal(size=slots) / np.sqrt(slots)
    ct = eng.encrypt_complex(x, level, scale)
    out = linalg.dot(eng, ct, w, bias=0.25)
    assert out.level == level - 1
    got = eng.decrypt_complex(out)[0].real
    assert abs(got - (np.dot(x, w) + 0.25)) < 1e-2
