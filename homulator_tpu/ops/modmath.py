"""uint32 Montgomery and Shoup modular arithmetic for XLA graphs.

This is the real implementation of what the reference's EWE unit models
(include/Components.h:155-193: `num_mul` multipliers + `num_add` adders
computing `a*b + c*d mod q` lanes). Device data stays uint32 (JAX's 64-bit
mode is a global switch), and a 32x32 -> 64 product is synthesized from
four 16x16 partial products with explicit carry propagation — a form
inherited from hardware without a widening multiply; the GPU has one, and
replacing the emulation is an open measurement (ROADMAP Speed 5).
Reduction is Montgomery REDC at radix R = 2**32:

    REDC(hi, lo) = (T + m*q) / R,   m = lo * (-q^{-1}) mod R

With primes q < 2**30 and operands < 2**30 the REDC output is < 2**28 + q,
so a single conditional subtract lands in [0, q).

Convention used throughout the framework: *data arrays hold standard-domain
residues*; every multiplicative constant (twiddles, base-conversion
matrices, evaluation keys, plaintexts-for-multiply) is pre-scaled by R
("Montgomery form"), so one `mont_mul(data, const_mont)` yields a
standard-domain product. Data*data products (tensor step, if keys were not
pre-scaled) first lift one operand via `to_mont`.

All functions broadcast: q / qinv_neg are typically [L, 1] against data
[L, N] (or scalars).
"""

from __future__ import annotations

import jax.numpy as jnp

# Plain Python ints (weak-typed) so these never become array constants.
_U16 = 0xFFFF
_SIXTEEN = 16


def mul32(a: jnp.ndarray, b: jnp.ndarray):
    """Full 32x32 -> 64-bit product as (hi, lo) uint32 pair."""
    a0 = a & _U16
    a1 = a >> _SIXTEEN
    b0 = b & _U16
    b1 = b >> _SIXTEEN
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = lh + hl  # may wrap
    carry_mid = (mid < lh).astype(jnp.uint32)
    lo = ll + (mid << _SIXTEEN)
    carry_lo = (lo < ll).astype(jnp.uint32)
    hi = hh + (mid >> _SIXTEEN) + (carry_mid << _SIXTEEN) + carry_lo
    return hi, lo


def mullo32(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Low 32 bits of a*b — uint32 multiplication wraps, which IS the low
    word (one native multiply, no 16-bit decomposition)."""
    return a * b


def mont_redc(hi: jnp.ndarray, lo: jnp.ndarray, q, qinv_neg) -> jnp.ndarray:
    """Montgomery reduction of (hi, lo) = T < 2**60 to T * R^{-1} mod q, in [0, q).

    Low-half carry trick: lo + low32(m*q) ≡ 0 (mod 2**32) by construction,
    so the carry into the high half is exactly (lo != 0).
    """
    m = mullo32(lo, qinv_neg)
    mq_hi, _ = mul32(m, q)
    t = hi + mq_hi + (lo != 0).astype(jnp.uint32)
    return jnp.where(t >= q, t - q, t)


def mont_mul(a: jnp.ndarray, b_mont: jnp.ndarray, q, qinv_neg) -> jnp.ndarray:
    """a * b mod q where b_mont = b * R mod q. Result standard domain, [0, q)."""
    hi, lo = mul32(a, b_mont)
    return mont_redc(hi, lo, q, qinv_neg)


def to_mont(a: jnp.ndarray, r2, q, qinv_neg) -> jnp.ndarray:
    """Lift standard-domain a to Montgomery form a*R mod q (r2 = R^2 mod q)."""
    return mont_mul(a, r2, q, qinv_neg)


def mont_mul_lazy(a: jnp.ndarray, b_mont: jnp.ndarray, q, qinv_neg) -> jnp.ndarray:
    """Montgomery product WITHOUT the final conditional subtract: result in
    [0, 2q) for ANY uint32 a (tighter, [0, q + 2**28), when a < 2**30 —
    callers must not rely on the tight bound). For accumulation chains
    (key-switch inner product) where per-term reduction is wasted work —
    sum lazily with lazy_sum_reduce, which only assumes terms < 2q."""
    hi, lo = mul32(a, b_mont)
    m = mullo32(lo, qinv_neg)
    mq_hi, _ = mul32(m, q)
    return hi + mq_hi + (lo != 0).astype(jnp.uint32)


def lazy_sum_reduce(terms, q) -> jnp.ndarray:
    """Sum of terms each in [0, 2q), reduced to [0, q) at the end only.

    The running value is kept < 4q (one conditional subtract of 2q before
    every add past the second), so with numtheory.PRIME_CAP (6q < 2**32)
    no intermediate ever wraps, for any number of terms."""
    acc = terms[0]
    bound = 2  # upper bound on acc, in units of q
    for t in terms[1:]:
        if bound >= 4:
            acc = cond_sub(acc, q + q)  # < 4q -> < 2q
            bound = 2
        acc = acc + t
        bound += 2
    while bound > 1:  # halve the bound per conditional subtract
        k = (bound + 1) // 2
        acc = jnp.where(acc >= k * q, acc - k * q, acc)
        bound = k
    return acc


def lazy_tree_sum(terms: jnp.ndarray, q) -> jnp.ndarray:
    """Reduce axis 0 of terms (each row in [0, 2q)) to a single [0, q) row.

    Log-depth pairwise tree: combine(a, b) = cond_sub(a + b, 2q) keeps every
    partial in [0, 2q) (sums < 4q < 2**32 under numtheory.PRIME_CAP), so
    each level is ONE batched add + ONE conditional subtract over the whole
    remaining array — XLA-friendly, unlike a sequential chain of M tiny
    adds (the per-op dispatch of which dominated the fused-tail phase)."""
    q2 = q + q
    while terms.shape[0] > 1:
        m = terms.shape[0]
        half = m // 2
        folded = cond_sub(terms[:half] + terms[half: 2 * half], q2)
        if m % 2:
            folded = jnp.concatenate([folded, terms[2 * half:]], axis=0)
        terms = folded
    return cond_sub(terms[0], q)


def mulhi32(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """High 32 bits of a*b."""
    return mul32(a, b)[0]


def mulhi32_approx(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """High word of a*b, possibly short by 1 (never over).

    Drops the ll = a0*b0 partial product and its carry into the high half:
    that carry is floor((ll + (mid << 16) mod 2^32 ... ) / 2^32) ∈ {0, 1},
    so hi_exact - 1 <= result <= hi_exact. One multiply and four carry ops
    cheaper than the exact mulhi32 — the Shoup product built on it lands in
    [0, 3q) instead of [0, 2q) (shoup_mul_lazy3)."""
    a0 = a & _U16
    a1 = a >> _SIXTEEN
    b0 = b & _U16
    b1 = b >> _SIXTEEN
    lh = a0 * b1
    hl = a1 * b0
    mid = lh + hl  # may wrap
    carry_mid = (mid < lh).astype(jnp.uint32)
    return a1 * b1 + (mid >> _SIXTEEN) + (carry_mid << _SIXTEEN)


def shoup_mul(a: jnp.ndarray, w: jnp.ndarray, w_shoup: jnp.ndarray, q) -> jnp.ndarray:
    """a * w mod q via Shoup precomputation: w_shoup = floor(w * 2^32 / q).

    r = a*w - floor(a*w_shoup / 2^32) * q lies in [0, 2q) for ANY a < 2^32
    (the floor-quotient error is at most 1), so one conditional subtract
    lands in [0, q). Cheaper than Montgomery for constant multiplicands
    (~10 vs ~11 hardware multiplies, fewer carries) at the cost of a second
    precomputed table. Used for twiddles and conversion constants.
    """
    hi = mulhi32(a, w_shoup)
    r = mullo32(a, w) - mullo32(hi, q)
    return jnp.where(r >= q, r - q, r)


def shoup_mul_lazy(a: jnp.ndarray, w: jnp.ndarray, w_shoup: jnp.ndarray, q) -> jnp.ndarray:
    """Shoup product WITHOUT the final conditional subtract: result in
    [0, 2q) for any a < 2^32, for sums that reduce once at the end
    (lazy_tree_sum, the conversion epilogue)."""
    hi = mulhi32(a, w_shoup)
    return mullo32(a, w) - mullo32(hi, q)


def shoup_mul_lazy3(a: jnp.ndarray, w: jnp.ndarray, w_shoup: jnp.ndarray, q) -> jnp.ndarray:
    """Cheapest Shoup product: approximate high word (err <= 1), no final
    subtract. Result in [0, 3q) for ANY a < 2^32. Callers must keep lazy
    accumulations under 2^32, which numtheory.PRIME_CAP guarantees for
    values up to 6q."""
    hi = mulhi32_approx(a, w_shoup)
    return a * w - hi * q


def modadd(a: jnp.ndarray, b: jnp.ndarray, q) -> jnp.ndarray:
    s = a + b  # both < 2**30: no wrap
    return jnp.where(s >= q, s - q, s)


def modsub(a: jnp.ndarray, b: jnp.ndarray, q) -> jnp.ndarray:
    return jnp.where(a >= b, a - b, a + q - b)


def modneg(a: jnp.ndarray, q) -> jnp.ndarray:
    return jnp.where(a == 0, a, q - a)


def cond_sub(a: jnp.ndarray, q) -> jnp.ndarray:
    """Single conditional subtract: reduces values < 2q into [0, q)."""
    return jnp.where(a >= q, a - q, a)


def ewe_muladd(a, b_mont, c, d_mont, q, qinv_neg) -> jnp.ndarray:
    """Fused a*b + c*d mod q — the reference EWE's adder-tree lane
    (include/InsGen.cpp:90-95). b/d must be in Montgomery form."""
    return modadd(
        mont_mul(a, b_mont, q, qinv_neg), mont_mul(c, d_mont, q, qinv_neg), q
    )
