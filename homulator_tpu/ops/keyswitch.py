"""Hybrid key switching — the performance-critical path of hmult/hrotate.

Real implementation of the reference's KeySwitch phase DAG
(src/Operation.cpp:9-590), phase for phase:

  ModUpINTT            -> intt of all `level` main limbs
  Decomp + BConvStep1/2 -> per digit: plain-residue decomposition, scale by
                           [(Q_d/q_i)^{-1}]_{q_i}, convert to all other ext
                           basis primes; own rows pass through (the
                           reference's "routed from Decomp" inputs,
                           src/Operation.cpp:190-292)
  ModUpNTT             -> ntt of the extended digit (level+alpha limbs)
  InnerProduct         -> acc_k += ext_digit * evk[d][k]  (the dead HPIP
                           unit's job, done for real; evk in Montgomery form)
  ModDown{INTT,BConv,NTT,Sub} -> divide by P and return to the main basis
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..context import KeySwitchLevelTables
from .bconv import bconv_step1, bconv_step2
from .modmath import (
    lazy_sum_reduce, lazy_tree_sum, modadd, modsub, mont_mul, mont_mul_lazy,
    shoup_mul, shoup_mul_lazy,
)
from .ntt import intt, intt_rep, ntt, ntt_rep


def modup_digit(
    c_coeff: jnp.ndarray, kt: KeySwitchLevelTables, d: int
) -> jnp.ndarray:
    """Lift digit d of c (coeff domain, [level, N]) to the ext basis
    [alpha+level, N] (specials-first row order). jnp graph path."""
    dt = kt.digits[d]
    lo, hi = dt.lo, dt.hi
    alpha = kt.special_nt.q.shape[0]
    own = c_coeff[lo:hi]  # [nd, N] plain residues
    in_q = kt.main_nt.q[lo:hi]
    in_qinv = kt.main_nt.qinv[lo:hi]
    ext_q = kt.ext_nt.q
    ext_qinv = kt.ext_nt.qinv
    xhat = bconv_step1(own, dt.step1_mont, in_q, in_qinv)
    # Centered conversion: virtual row v against the final [-Q_d] column
    # of the step2 matrix (params.KeySwitchTables.modup_step2).
    th = ((in_q >> 1) + 1).reshape((-1,) + (1,) * (xhat.ndim - 1))
    v = jnp.sum((xhat >= th).astype(jnp.uint32), axis=0, keepdims=True)
    xhat_ext = jnp.concatenate([xhat, v], axis=0)
    other_rows = jnp.concatenate(
        [jnp.arange(0, alpha + lo), jnp.arange(alpha + hi, ext_q.shape[0])]
    )
    conv = bconv_step2(
        xhat_ext, dt.mat_other_mont, ext_q[other_rows], ext_qinv[other_rows]
    )
    # Reassemble: [0 : alpha+lo) converted | own | [alpha+hi :) converted.
    return jnp.concatenate(
        [conv[: alpha + lo], own, conv[alpha + lo:]], axis=0
    )


def modup_digit_eval(
    d_eval: jnp.ndarray,  # [level, N] eval-domain input poly
    c_coeff: jnp.ndarray,  # [level, N] its coeff-domain form
    kt: KeySwitchLevelTables,
    d: int,
) -> jnp.ndarray:
    """Digit d lifted to the ext basis, EVAL domain [alpha+level, N].

    Piecewise pipeline: the conversion reproduces own-digit residues
    exactly (only the t = j term of sum_t x_hat[t]*[Q_d/q_t] survives mod
    q_j), so own rows are copied straight from the eval-domain input —
    they skip the conversion AND the per-digit NTT. Only the other rows
    run the bf16 conversion + NTT (ops/bconv_fused.py).
    """
    dt = kt.digits[d]
    lo, hi = dt.lo, dt.hi
    alpha = kt.special_nt.q.shape[0]
    if not kt.ext_nt.piecewise:
        return ntt(modup_digit(c_coeff, kt, d), kt.ext_nt)
    from .bconv_fused import bconv_fused

    own = c_coeff[lo:hi]
    conv = bconv_fused(
        own, dt.step1_pl, dt.step1_sh, kt.main_nt.q[lo:hi],
        dt.mat_bf16, dt.horner_sh, dt.other_nt.q, center=True,
    )
    conv_eval = ntt(conv, dt.other_nt)
    return jnp.concatenate(
        [conv_eval[: alpha + lo], d_eval[lo:hi], conv_eval[alpha + lo:]],
        axis=0,
    )


def moddown(c_ext: jnp.ndarray, kt: KeySwitchLevelTables) -> jnp.ndarray:
    """[alpha+level, N] eval over the (specials-first) ext basis ->
    [level, N] eval mod Q (divide by P)."""
    level = kt.level
    alpha = kt.special_nt.q.shape[0]
    b = intt(c_ext[:alpha], kt.special_nt)  # special limbs to coeff
    sp_q = kt.special_nt.q
    sp_qinv = kt.special_nt.qinv
    if kt.main_nt.piecewise:
        from .bconv_fused import bconv_fused

        conv = bconv_fused(
            b, kt.moddown_s1_pl, kt.moddown_s1_sh, sp_q,
            kt.moddown_bf16, kt.moddown_horner_sh, kt.main_nt.q, center=True,
        )
    else:
        bhat = bconv_step1(b, kt.moddown_s1_mont, sp_q, sp_qinv)
        th = ((sp_q >> 1) + 1).reshape((-1,) + (1,) * (bhat.ndim - 1))
        v = jnp.sum((bhat >= th).astype(jnp.uint32), axis=0, keepdims=True)
        conv = bconv_step2(
            jnp.concatenate([bhat, v], axis=0), kt.moddown_s2_mont,
            kt.main_nt.q, kt.main_nt.qinv,
        )
    conv_eval = ntt(conv, kt.main_nt)
    mq = kt.main_nt.q[:, None, None]
    mqi = kt.main_nt.qinv[:, None, None]
    diff = modsub(c_ext[alpha:], conv_eval, mq)
    if kt.main_nt.piecewise:
        return shoup_mul(diff, kt.pinv_pl[:, None, None], kt.pinv_sh[:, None, None], mq)
    return mont_mul(diff, kt.pinv_mont[:, None, None], mq, mqi)


def moddown_pair(acc, kt: KeySwitchLevelTables) -> jnp.ndarray:
    """ModDown over the split (acc_sp [alpha, N], acc_main [level, N])
    accumulator pair (inner_product_pieces output) — moddown() without ever
    concatenating the ext-basis array. Bit-identical to
    moddown(concat([acc_sp, acc_main]))."""
    acc_sp, acc_main = acc
    sp_q = kt.special_nt.q[:, None, None]
    b = intt(acc_sp, kt.special_nt)  # special limbs to coeff
    from .bconv_fused import bconv_fused

    conv = bconv_fused(
        b, kt.moddown_s1_pl, kt.moddown_s1_sh, kt.special_nt.q,
        kt.moddown_bf16, kt.moddown_horner_sh, kt.main_nt.q, center=True,
    )
    conv_eval = ntt(conv, kt.main_nt)
    mq = kt.main_nt.q[:, None, None]
    diff = modsub(acc_main, conv_eval, mq)
    return shoup_mul(diff, kt.pinv_pl[:, None, None], kt.pinv_sh[:, None, None], mq)


def moddown_pair2(acc0, acc1, kt: KeySwitchLevelTables) -> jnp.ndarray:
    """Both key components' concat-free ModDown in ONE batched pass
    (single-chip: the rep=2 transforms share the basis tables).
    Bit-identical to (moddown_pair(acc0), moddown_pair(acc1)); returns
    the stacked [2, level, n2, n1] result."""
    alpha = kt.special_nt.q.shape[0]
    level = kt.level
    b = intt_rep(
        jnp.concatenate([acc0[0], acc1[0]], axis=0), kt.special_nt, 2
    )  # [2a, n1, n2], k-major
    from .bconv_fused import bconv_fused

    convs = [
        bconv_fused(
            b[k * alpha: (k + 1) * alpha], kt.moddown_s1_pl,
            kt.moddown_s1_sh, kt.special_nt.q,
            kt.moddown_bf16, kt.moddown_horner_sh, kt.main_nt.q, center=True,
        )
        for k in (0, 1)
    ]
    ce = ntt_rep(jnp.concatenate(convs, axis=0), kt.main_nt, 2)
    conv_eval = ce.reshape(2, level, ce.shape[1], ce.shape[2])
    mq = kt.main_nt.q[None, :, None, None]
    diff = modsub(jnp.stack([acc0[1], acc1[1]]), conv_eval, mq)
    return shoup_mul(
        diff, kt.pinv_pl[None, :, None, None],
        kt.pinv_sh[None, :, None, None], mq,
    )


def keyswitch_pieces(
    d_eval: jnp.ndarray, evk_mont, kt: KeySwitchLevelTables
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Piecewise key switch (no rescale): piecewise ModUp (own rows pass
    through, no digit concat) + streaming inner product + concat-free
    ModDown (both keys batched on a single chip). Bit-identical to
    keyswitch(); requires the piecewise tables (kt.main_nt.piecewise)."""
    convs = modup_conv_all(d_eval, kt)
    acc0, acc1 = inner_product_pieces(convs, d_eval, evk_mont, kt)
    if kt.main_nt.shard_axis is None:
        out = moddown_pair2(acc0, acc1, kt)
        return out[0], out[1]
    return moddown_pair(acc0, kt), moddown_pair(acc1, kt)


def modup_conv_all(d_eval: jnp.ndarray, kt: KeySwitchLevelTables):
    """Piecewise-pipeline ModUp WITHOUT digit assembly: per digit, only the
    converted OTHER rows ([m_other, N] eval, ext order minus own rows).
    Own rows are d_eval itself (exact passthrough); the inner product
    consumes the pieces directly (inner_product_pieces), so no [K_ext, N]
    concat is ever materialized."""
    c_coeff = intt(d_eval, kt.main_nt)
    from .bconv_fused import bconv_fused

    return tuple(
        ntt(bconv_fused(
            c_coeff[dt.lo:dt.hi], dt.step1_pl, dt.step1_sh,
            kt.main_nt.q[dt.lo:dt.hi], dt.mat_bf16, dt.horner_sh,
            dt.other_nt.q, center=True,
        ), dt.other_nt)
        for dt in kt.digits
    )


def inner_product_pieces(
    convs,  # tuple of [m_other, N] eval converted rows, one per digit
    d_eval: jnp.ndarray,  # [level, N] eval input poly (own rows of each digit)
    evk_mont,  # Montgomery-form key [dnum, 2, K, N], specials-first
    kt: KeySwitchLevelTables,
):
    """Digit inner product over piecewise ModUp output. Returns per key k
    a pair (acc_sp [alpha, N], acc_main [level, N]) — the ext-basis
    accumulator split at the specials boundary, never concatenated.

    This streams the entire evk once per call and is HBM-bandwidth-bound,
    so the key is a single Montgomery array (half the bytes of a Shoup
    pair) and the per-digit products accumulate lazily (mont_mul_lazy +
    one reduction per output row set)."""
    alpha = kt.special_nt.q.shape[0]
    sp_q = kt.special_nt.q[:, None, None]
    sp_qi = kt.special_nt.qinv[:, None, None]
    segs = [(dt.lo, dt.hi) for dt in kt.digits]
    out = []
    for k in (0, 1):
        sp = lazy_sum_reduce(
            [
                mont_mul_lazy(
                    conv[:alpha], evk_mont[d, k, :alpha], sp_q, sp_qi
                )
                for d, conv in enumerate(convs)
            ],
            sp_q,
        )
        mains = []
        for j, (lo, hi) in enumerate(segs):
            qseg = kt.main_nt.q[lo:hi, None, None]
            qiseg = kt.main_nt.qinv[lo:hi, None, None]
            kk = slice(alpha + lo, alpha + hi)
            terms = [
                mont_mul_lazy(d_eval[lo:hi], evk_mont[j, k, kk], qseg, qiseg)
            ]
            for d, conv in enumerate(convs):
                if d == j:
                    continue
                nd_d = segs[d][1] - segs[d][0]
                off = alpha + lo - (nd_d if d < j else 0)
                terms.append(
                    mont_mul_lazy(
                        conv[off: off + hi - lo],
                        evk_mont[d, k, kk], qseg, qiseg,
                    )
                )
            mains.append(lazy_sum_reduce(terms, qseg))
        out.append((sp, jnp.concatenate(mains, axis=0)))
    return out


def moddown_rescale(
    acc,  # (acc_sp [alpha, N], acc_main [level, N]) eval-domain pair
    d: jnp.ndarray,  # [level, N] eval: the relinearization addend (d0 or d1)
    kt: KeySwitchLevelTables,
) -> jnp.ndarray:
    """Fused ModDown + relin add + Rescale: (acc/P + d) rescaled by q_last,
    i.e. divide acc + P*d by P*q_last in ONE base conversion.

    Bit-identical to moddown -> modadd -> rescale_poly (the intermediate
    Z = floor-div(acc, P) + d and its w = Z mod q_last are the same
    integers either way), but pays one [level-1]-row NTT broadcast instead
    of two ([level] for ModDowNTT + [level-1] for Rescale's re-NTT) and
    one fused conversion instead of two. Mirrors the reference's
    ModDown{...} (src/Operation.cpp:417-590) + Rescale (741-911) phases.
    """
    acc_sp, acc_main = acc
    tt = kt.tail
    level = kt.level
    alpha = kt.special_nt.q.shape[0]
    sp_q = kt.special_nt.q[:, None, None]
    b = intt(acc_sp, kt.special_nt)  # specials to coeff
    bhat = shoup_mul(
        b, kt.moddown_s1_pl[:, None, None], kt.moddown_s1_sh[:, None, None], sp_q
    )
    # Centered conversion: explicit virtual row v_b (bhat is computed out
    # here, so the conversion runs with center=False and the [-P]_{q_i} column
    # of the tail matrix consumes v_b). The w row is ALSO centered, via
    # its own indicator row against the [-P*q_last]_{q_i} column: the
    # naive "0.5/scale is sub-ulp" analysis misses that the uncentered
    # c1-component remainder multiplies the secret key at decrypt, whose
    # signed coefficient sum (~sqrt(N)) turns the half-ulp floor bias
    # into a key-dependent slot-0 tone (measured 1.3e-2 at set B; see
    # ops/rescale.rescale_poly).
    th = ((kt.special_nt.q >> 1) + 1)[:, None, None]
    v_b = jnp.sum((bhat >= th).astype(jnp.uint32), axis=0, keepdims=True)
    bhat_ext = jnp.concatenate([bhat, v_b], axis=0)  # [alpha+1, R, C]
    # conv row for q_last (coeff domain): sum_j bhat_ext_j * [P/p_j]_{q_last}
    # (the j = alpha term is the centering correction -v_b*P). One batched
    # lazy Shoup multiply + a log-depth tree sum — not a sequential chain
    # of alpha tiny adds (each a separate dispatch).
    q_last = kt.main_nt.q[level - 1]
    terms = shoup_mul_lazy(
        bhat_ext, tt.md2_last_pl[:, None, None], tt.md2_last_sh[:, None, None],
        q_last,
    )
    conv_last = lazy_tree_sum(terms, q_last)
    # w = Z mod q_last where Z = floor-div(acc, P) + d:
    # (acc_last + P*d_last - conv_last) * P^{-1} mod q_last, in coeff domain.
    zl_eval = modadd(
        acc_main[level - 1],
        shoup_mul(d[level - 1], tt.p_pl[level - 1], tt.p_sh[level - 1], q_last),
        q_last,
    )
    zl_coeff = intt(zl_eval[None], tt.last_nt)[0]
    w = shoup_mul(
        modsub(zl_coeff, conv_last, q_last),
        kt.pinv_pl[level - 1], kt.pinv_sh[level - 1], q_last,
    )
    # w centering indicator (consumed by the [-P*q_last]_{q_i} column)
    ind_w = (w >= ((q_last >> 1) + 1)).astype(jnp.uint32)
    # Combined correction E_i = conv_P,i + P*w~ mod q_i via ONE conversion.
    from .bconv_fused import bconv_fused

    conv = bconv_fused(
        jnp.concatenate([bhat_ext, w[None], ind_w[None]], axis=0),
        tt.one_pl, tt.one_sh, tt.in_q,
        tt.bf16, tt.horner_sh, tt.out_nt.q,
    )
    e = ntt(conv, tt.out_nt)
    oq = tt.out_nt.q[:, None, None]
    lo = level - 1
    z = modadd(
        acc_main[:lo],
        shoup_mul(d[:lo], tt.p_pl[:lo, None, None], tt.p_sh[:lo, None, None], oq),
        oq,
    )
    return shoup_mul(
        modsub(z, e, oq), tt.pq_inv_pl[:, None, None], tt.pq_inv_sh[:, None, None], oq
    )


def moddown_rescale2(acc0, acc1, d0, d1, kt: KeySwitchLevelTables):
    """Both key components' fused ModDown + relin add + Rescale tails in
    ONE batched pass: the specials iNTT, the dropped-limb iNTT and the
    output NTT broadcast each run as a single rep=2 transform (tables
    shared), and every elementwise stage is one batched
    op over [2, ...] instead of two dispatch chains. Bit-identical to
    (moddown_rescale(acc0, d0), moddown_rescale(acc1, d1)); returns the
    stacked [2, level-1, n2, n1] result directly."""
    tt = kt.tail
    level = kt.level
    alpha = kt.special_nt.q.shape[0]
    sp_q2 = kt.special_nt.q[None, :, None, None]
    acc_sp = jnp.concatenate([acc0[0], acc1[0]], axis=0)  # [2a, n2, n1]
    b = intt_rep(acc_sp, kt.special_nt, 2)  # [2a, n1, n2], k-major
    sh = b.shape
    b = b.reshape(2, alpha, sh[1], sh[2])
    bhat = shoup_mul(
        b, kt.moddown_s1_pl[None, :, None, None],
        kt.moddown_s1_sh[None, :, None, None], sp_q2,
    )
    th = ((kt.special_nt.q >> 1) + 1)[None, :, None, None]
    v_b = jnp.sum((bhat >= th).astype(jnp.uint32), axis=1, keepdims=True)
    bhat_ext = jnp.concatenate([bhat, v_b], axis=1)  # [2, a+1, R, C]
    q_last = kt.main_nt.q[level - 1]
    terms = shoup_mul_lazy(
        bhat_ext, tt.md2_last_pl[None, :, None, None],
        tt.md2_last_sh[None, :, None, None], q_last,
    )
    conv_last = lazy_tree_sum(terms.swapaxes(0, 1), q_last)  # [2, R, C]
    acc_main = jnp.stack([acc0[1], acc1[1]])  # [2, level, n2, n1]
    dd = jnp.stack([d0, d1])
    zl_eval = modadd(
        acc_main[:, level - 1],
        shoup_mul(dd[:, level - 1], tt.p_pl[level - 1], tt.p_sh[level - 1],
                  q_last),
        q_last,
    )
    zl_coeff = intt_rep(zl_eval, tt.last_nt, 2)  # [2, n1, n2]
    w = shoup_mul(
        modsub(zl_coeff, conv_last, q_last),
        kt.pinv_pl[level - 1], kt.pinv_sh[level - 1], q_last,
    )
    # w centering indicator rows (see moddown_rescale)
    ind_w = (w >= ((q_last >> 1) + 1)).astype(jnp.uint32)
    from .bconv_fused import bconv_fused

    lm1 = level - 1
    convs = [
        bconv_fused(
            jnp.concatenate([bhat_ext[k], w[k][None], ind_w[k][None]],
                            axis=0),
            tt.one_pl, tt.one_sh, tt.in_q,
            tt.bf16, tt.horner_sh, tt.out_nt.q,
        )
        for k in (0, 1)
    ]
    e = ntt_rep(jnp.concatenate(convs, axis=0), tt.out_nt, 2)
    e = e.reshape(2, lm1, e.shape[1], e.shape[2])
    oq = tt.out_nt.q[None, :, None, None]
    z = modadd(
        acc_main[:, :lm1],
        shoup_mul(dd[:, :lm1], tt.p_pl[None, :lm1, None, None],
                  tt.p_sh[None, :lm1, None, None], oq),
        oq,
    )
    return shoup_mul(
        modsub(z, e, oq), tt.pq_inv_pl[None, :, None, None],
        tt.pq_inv_sh[None, :, None, None], oq,
    )


def modup_all(d_eval: jnp.ndarray, kt: KeySwitchLevelTables):
    """Decompose + ModUp + NTT all digits once: tuple of [level+alpha, N].

    This is the hoistable prefix of a key switch (Halevi-Shoup hoisting):
    the Galois automorphism commutes with RNS decomposition, so many
    rotations of one ciphertext can share a single ModUp and only pay the
    per-rotation inner product + ModDown.
    """
    c_coeff = intt(d_eval, kt.main_nt)
    return tuple(
        modup_digit_eval(d_eval, c_coeff, kt, d)
        for d in range(len(kt.digits))
    )


def inner_product(
    ext_digits,  # tuple of [level+alpha, N] eval-domain lifted digits
    evk_mont,  # Montgomery-form key [dnum, 2, K, N]
    kt: KeySwitchLevelTables,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Digit inner product against evk (the reference's dead HPIP unit,
    done for real): acc_k = sum_d digit_d * evk[d][k] over the ext basis.
    Bandwidth-bound on the evk stream — single Montgomery array + lazy
    accumulation (see inner_product_pieces)."""
    level = kt.level
    alpha = kt.special_nt.q.shape[0]
    ext_q = kt.ext_nt.q[:, None, None]
    ext_qi = kt.ext_nt.qinv[:, None, None]
    k_ext = alpha + level  # keys are specials-first: contiguous prefix

    t0s, t1s = [], []
    for d, ext_eval in enumerate(ext_digits):
        t0s.append(mont_mul_lazy(ext_eval, evk_mont[d, 0, :k_ext], ext_q, ext_qi))
        t1s.append(mont_mul_lazy(ext_eval, evk_mont[d, 1, :k_ext], ext_q, ext_qi))
    return lazy_sum_reduce(t0s, ext_q), lazy_sum_reduce(t1s, ext_q)


def inner_product_moddown(
    ext_digits, evk, kt: KeySwitchLevelTables
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Inner product + ModDown: the per-key tail of a key switch."""
    acc0, acc1 = inner_product(ext_digits, evk, kt)
    return moddown(acc0, kt), moddown(acc1, kt)


def keyswitch(
    d_eval: jnp.ndarray,  # [level, N] eval-domain poly to switch
    evk,  # Montgomery-form key [dnum, 2, K, N]
    kt: KeySwitchLevelTables,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (e0, e1), each [level, N] eval, to add to (c0, c1)."""
    return inner_product_moddown(modup_all(d_eval, kt), evk, kt)
