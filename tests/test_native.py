"""Native C++ host core vs numpy reference: bit-exact."""

import numpy as np
import pytest

from homulator_tpu import native
from homulator_tpu.refimpl import RefCkks

from .conftest import random_limbs


@pytest.fixture(autouse=True)
def _native_lib():
    """Build (or find) the library at run time; skip without a compiler."""
    if not native.available():
        pytest.skip("native library unavailable (no C++ compiler)")


def test_native_ntt_matches_numpy(small_params):
    ref = RefCkks(small_params, seed=0, use_native=False)
    nn = native.NativeNtt(small_params)
    rng = np.random.default_rng(0)
    idx = np.arange(small_params.num_primes)
    x = random_limbs(small_params, idx, rng)
    assert np.array_equal(nn.ntt(x, idx), ref.ntt(x, idx))
    y = nn.ntt(x, idx)
    assert np.array_equal(nn.intt(y, idx), x)


def test_native_ewe_ops(small_params):
    lib = native.load()
    rng = np.random.default_rng(1)
    idx = np.arange(4)
    a = random_limbs(small_params, idx, rng)
    b = random_limbs(small_params, idx, rng)
    qs = np.ascontiguousarray(small_params.q_arr[idx])
    M, N = a.shape
    out = np.zeros_like(a)
    lib.ckks_ewe_mul(a, b, out, M, N, qs)
    assert np.array_equal(out, (a * b) % qs[:, None])
    lib.ckks_ewe_add(a, b, out, M, N, qs)
    assert np.array_equal(out, (a + b) % qs[:, None])
    lib.ckks_ewe_sub(a, b, out, M, N, qs)
    assert np.array_equal(out, (a + qs[:, None] - b) % qs[:, None])


def test_native_bconv(small_params):
    lib = native.load()
    rng = np.random.default_rng(2)
    nd, Mout = 3, 5
    in_idx = np.arange(nd)
    xhat = random_limbs(small_params, in_idx, rng)
    out_qs = np.ascontiguousarray(small_params.q_arr[nd: nd + Mout])
    mat = rng.integers(0, 1 << 30, size=(Mout, nd)).astype(np.uint64)
    out = np.zeros((Mout, small_params.n), dtype=np.uint64)
    lib.ckks_bconv(np.ascontiguousarray(xhat), np.ascontiguousarray(mat), out,
                   nd, Mout, small_params.n, out_qs)
    for j in range(Mout):
        q = out_qs[j]
        acc = np.zeros(small_params.n, dtype=np.uint64)
        for i in range(nd):
            acc = (acc + xhat[i] * (mat[j, i] % q)) % q
        assert np.array_equal(out[j], acc)


def test_refimpl_native_mode_matches_numpy(small_params):
    """Full hmult through both host engines is bit-identical."""
    ref_np = RefCkks(small_params, seed=3, use_native=False)
    ref_nat = RefCkks(small_params, seed=3, use_native=True)
    ref_np.keygen()
    ref_nat.keygen()
    scale = 2.0**29
    m = np.zeros(small_params.n, dtype=np.int64)
    m[0] = int(5 * scale)
    l = small_params.max_level
    pt_np = ref_np.encode_ints(m, l, scale)
    pt_nat = ref_nat.encode_ints(m, l, scale)
    assert np.array_equal(pt_np.data, pt_nat.data)
    ct_np = ref_np.encrypt(pt_np)
    ct_nat = ref_nat.encrypt(pt_nat)
    assert np.array_equal(ct_np.data, ct_nat.data)
    out_np = ref_np.hmult(ct_np, ct_np)
    out_nat = ref_nat.hmult(ct_nat, ct_nat)
    assert np.array_equal(out_np.data, out_nat.data)
