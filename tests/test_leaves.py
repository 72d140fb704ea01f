"""The piecewise pipeline's leaves vs the plain Montgomery graph:
the Shoup-table XLA NTT and the bf16 base conversion, bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest

from homulator_tpu.api import CkksEngine
from homulator_tpu.params import get_params

from .conftest import random_limbs

SCALE = 2.0**29


@pytest.fixture(scope="module")
def engines():
    params = get_params(n=256, max_level=6, alpha=2)
    ej = CkksEngine(params, seed=13, ntt_mode="montgomery")
    ep = CkksEngine(params, seed=13, ntt_mode="xla")
    ej.keygen()
    ep.keygen()
    return ej, ep


def test_ntt_kernel_matches(engines):
    ej, ep = engines
    p = ej.params
    rng = np.random.default_rng(0)
    x = random_limbs(p, np.arange(p.max_level), rng)
    xd = jnp.asarray(x.astype(np.uint32))
    yj = np.asarray(ej.ntt(xd, p.max_level))
    yp = np.asarray(ep.ntt(xd, p.max_level))
    assert np.array_equal(yj, yp)
    assert np.array_equal(
        np.asarray(ej.intt(jnp.asarray(yj), p.max_level)),
        np.asarray(ep.intt(jnp.asarray(yp), p.max_level)),
    )


@pytest.mark.parametrize("rep", [2, 3])
def test_ntt_rep_matches_per_copy(engines, rep):
    """ntt_rep / intt_rep (one batched transform over rep stacked copies
    of a basis, tables shared) == rep separate transforms."""
    from homulator_tpu.ops.ntt import intt, intt_rep, ntt, ntt_rep

    _, ep = engines
    p = ep.params
    t = p.ntt
    nb = ep.dc.ntt_basis(ep.dc.main_rows(4))
    rng = np.random.default_rng(rep)
    x = jnp.asarray(np.concatenate([
        random_limbs(p, np.arange(4), rng) for _ in range(rep)
    ]).astype(np.uint32).reshape(rep * 4, t.n1, t.n2))
    want = jnp.concatenate([ntt(x[4 * k: 4 * k + 4], nb)
                            for k in range(rep)])
    got = ntt_rep(x, nb, rep)
    assert np.array_equal(np.asarray(got), np.asarray(want))
    back = intt_rep(got, nb, rep)
    assert np.array_equal(np.asarray(back), np.asarray(x))
    assert np.array_equal(np.asarray(intt(want[:4], nb)), np.asarray(x[:4]))


def test_bconv_kernels_match(engines):
    """bf16-plane conversion == Montgomery graph, bit-exact (it includes
    step1, so it's fed an identity scaling to isolate the conversion)."""
    from homulator_tpu.ops.bconv import bconv_step2
    from homulator_tpu.ops.bconv_fused import bconv_fused, build_bf16_tables

    ej, _ = engines
    p = ej.params
    rng = np.random.default_rng(1)
    nd, m_out = 2, 5
    xhat = jnp.asarray(random_limbs(p, np.arange(nd), rng).astype(np.uint32))
    # realistic matrix entries: residues mod the OUTPUT primes
    qs = p.q_arr[:m_out]
    mat_pl = rng.integers(0, 1 << 29, size=(m_out, nd)).astype(np.uint64) % qs[:, None]
    mat_mont = jnp.asarray(((mat_pl << np.uint64(32)) % qs[:, None]).astype(np.uint32))
    q = jnp.asarray(qs.astype(np.uint32))
    qinv = jnp.asarray(p.qinv_neg[:m_out].astype(np.uint32))
    ref = np.asarray(bconv_step2(xhat, mat_mont, q, qinv))
    bf16, hsh = build_bf16_tables(mat_pl, qs)
    in_q = p.q_arr[:nd].astype(np.uint64)
    one_pl = jnp.asarray(np.ones(nd, dtype=np.uint32))
    one_sh = jnp.asarray(((np.ones(nd, dtype=np.uint64) << np.uint64(32))
                          // in_q).astype(np.uint32))
    t = p.ntt
    out = np.asarray(
        bconv_fused(xhat.reshape(nd, t.n1, t.n2), one_pl, one_sh,
                    jnp.asarray(in_q.astype(np.uint32)), bf16, hsh, q)
    ).reshape(m_out, p.n)
    assert np.array_equal(ref, out)


def test_full_hmult_matches(engines):
    """Whole hmult through the piecewise pipeline == Montgomery graph."""
    ej, ep = engines
    p = ej.params
    m = np.zeros(p.n, dtype=np.int64)
    m[0] = int(7 * SCALE)
    l = p.max_level
    c1j = ej.encrypt_ints(m, l, SCALE)
    c2j = ej.encrypt_ints(m, l, SCALE)
    c1p = ep.encrypt_ints(m, l, SCALE)
    c2p = ep.encrypt_ints(m, l, SCALE)
    assert np.array_equal(np.asarray(c1j.data), np.asarray(c1p.data))
    oj = ej.hmult(c1j, c2j)
    op_ = ep.hmult(c1p, c2p)
    assert np.array_equal(np.asarray(oj.data), np.asarray(op_.data))


def test_full_hrotate_matches(engines):
    ej, ep = engines
    p = ej.params
    m = np.zeros(p.n, dtype=np.int64)
    m[0] = int(3 * SCALE)
    l = p.max_level
    c1j = ej.encrypt_ints(m, l, SCALE)
    c1p = ep.encrypt_ints(m, l, SCALE)
    oj = ej.hrotate(c1j, 1)
    op_ = ep.hrotate(c1p, 1)
    assert np.array_equal(np.asarray(oj.data), np.asarray(op_.data))


@pytest.mark.parametrize("nd,center", [(1, False), (15, True), (29, False),
                                       (30, True), (31, False)])
def test_bconv_fused_max_digit_stress(nd, center):
    """Range stress up to the LARGEST conversion width this framework
    builds (31 = set A's alpha+3 tail) with primes at both ends of the
    allowed band — guards the pairing epilogue's wrap-freedom bounds (a
    too-weak bound corrupts results by 2^32 mod q). center=True adds the
    centering row (matrix width nd+1), checked against exact integers."""
    from homulator_tpu import numtheory as nt
    from homulator_tpu.ops.bconv_fused import bconv_fused, build_bf16_tables

    rng = np.random.default_rng(123 + nd)
    n1 = n2 = 16
    m_out = 8
    in_q = np.array(nt.gen_ntt_primes(64, nd), dtype=np.uint64)
    # output primes from the small end of the band (worst lo/q ratio)
    out_q = np.array(
        nt.gen_ntt_primes(64, m_out, start_bits=29), dtype=np.uint64)
    width = nd + (1 if center else 0)
    mat = rng.integers(0, out_q.min(), size=(m_out, width)).astype(np.uint64)
    s = rng.integers(1, in_q, size=nd).astype(np.uint64)
    x = np.stack(
        [rng.integers(0, q, size=(n1, n2), dtype=np.uint64) for q in in_q])
    bf16, hsh = build_bf16_tables(mat, out_q)
    s_pl = jnp.asarray(s.astype(np.uint32))
    s_sh = jnp.asarray(((s << np.uint64(32)) // in_q).astype(np.uint32))
    out = np.asarray(
        bconv_fused(
            jnp.asarray(x.astype(np.uint32)), s_pl, s_sh,
            jnp.asarray(in_q.astype(np.uint32)), bf16, hsh,
            jnp.asarray(out_q.astype(np.uint32)), center=center,
        )
    ).astype(np.uint64)
    xh = (x * s[:, None, None]) % in_q[:, None, None]
    if center:
        v = (xh >= (in_q[:, None, None] >> np.uint64(1)) + np.uint64(1)
             ).sum(axis=0, dtype=np.uint64)
        xh = np.concatenate([xh, v[None]], axis=0)
    for j in range(m_out):
        acc = np.zeros((n1, n2), dtype=object)
        for i in range(width):
            acc += int(mat[j, i]) * xh[i].astype(object)
        assert np.array_equal(out[j], (acc % int(out_q[j])).astype(np.uint64)), j
