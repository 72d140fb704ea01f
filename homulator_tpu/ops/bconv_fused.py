"""RNS base conversion as one bf16 matrix product (BCONVU, done for real).

One conversion runs as a single jitted chain that XLA fuses around one
tensor-core product (the reference models this unit as its per-cluster
h x w MAC grid, include/Components.h:245-295):

  step1   x_hat[i] = x[i] * s[i] mod q_i            (Shoup, per-row const)
  planes  x_hat = sum_k X_k 2^(8k), X_k in [0,256)  (4 bf16 planes)
  matmul  D_i = sum_k M_{k,i} @ X_k                 (ONE bf16 product,
                                                     f32 accumulation —
                                                     exact: |D| < 2^24)
  pairing out[r] = (D_0 + 2^8 D_1) + 2^16 (D_2 + 2^8 D_3) mod q_r
          — the 2^8 folds are exact uint32 shifts+adds (each half
          < 257 * 4*nd*255^2 < 8*q_min, wrap-free for nd <= 32); only the 2^16 fold
          pays a Shoup multiply. ONE modmul instead of the 3 a
          straight base-256 Horner would need.

The conversion matrix is pre-folded host-side (build_bf16_tables): input
radix 2^(8k) is multiplied into M mod q_r, so the output recombination is
single-radix. Exactness: plane entries < 256 are exact in bf16; every
partial sum < 4*nd*255^2 < 2^24 is an integer exact in f32 whatever order
the sums run in (nd <= 64; the pairing epilogue tightens this to nd <= 32,
above the largest digit here, 31). The operands are bf16, so no float32
product can drop to TF32.

Used for both ModUp digit lifts and ModDown; bit-exact vs the Montgomery
graph path (tests/test_bconv_fused.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .modmath import shoup_mul, shoup_mul_lazy

RADIX_BITS = 8
RADIX = 1 << RADIX_BITS  # 256
NPLANES = 4  # ceil(30 / 8): primes < 2^30


def build_bf16_tables(mat_plain: np.ndarray, q_rows: np.ndarray):
    """Host precompute. mat_plain: uint64[m_out, nd] standard-domain
    conversion matrix; q_rows: uint64[m_out] output primes. Returns
    (mbig bf16[NPLANES*m_out, NPLANES*nd], horner_sh uint32[m_out]) —
    the Horner plain multiplicand is always RADIX."""
    m_out, nd = mat_plain.shape
    mbig = np.zeros((NPLANES, m_out, NPLANES * nd), dtype=np.float32)
    q = q_rows.astype(np.uint64)[:, None]
    for k in range(NPLANES):
        mk = (mat_plain.astype(np.uint64) << np.uint64(RADIX_BITS * k)) % q
        for i in range(NPLANES):
            plane = (mk >> np.uint64(RADIX_BITS * i)) & np.uint64(RADIX - 1)
            mbig[i, :, k * nd: (k + 1) * nd] = plane.astype(np.float32)
    # pairing epilogue wrap-freedom: lo = 257*4*nd*255^2 < 8*q_min = 2^31
    # -> nd <= 32 (largest digit here is alpha+3 = 31, set A's tail with
    # the v_b and w-centering indicator rows)
    assert nd <= 32, "pairing epilogue bound (see module docstring)"
    # Shoup quotient of the single 2^16 recombination multiplier.
    horner_sh = (
        (np.uint64(RADIX * RADIX) << np.uint64(32))
        // q_rows.astype(np.uint64)
    ).astype(np.uint32)
    return (
        jnp.asarray(mbig.reshape(NPLANES * m_out, NPLANES * nd)).astype(
            jnp.bfloat16
        ),
        jnp.asarray(horner_sh),
    )


@functools.partial(jax.jit, static_argnames=("center",))
def bconv_fused(x, s_pl, s_sh, in_q, mat_bf16, horner_sh, out_q, *,
                center=False):
    """x: uint32[nd, R, C] coeff-domain tiles; s_*: [nd] step1 Shoup pair;
    in_q: [nd]; mat_bf16/horner_sh: build_bf16_tables output; out_q: [m_out].
    Returns uint32[m_out, R, C] = bconv(x * s) with per-row reduction.
    center=True appends the centering row (the matrix must have been
    built over nd+1 columns, last = [-Q_in]_{p_j})."""
    nd, R, C = x.shape
    m_out = out_q.shape[0]
    assert mat_bf16.shape[1] == NPLANES * (nd + (1 if center else 0)), (
        mat_bf16.shape, nd, center)
    inq = in_q[:, None, None]
    xhat = shoup_mul(x, s_pl[:, None, None], s_sh[:, None, None], inq)
    if center:
        # Virtual centering row v = #{t : xhat_t >= ceil(q_t/2)}, consumed
        # by the matrix's final [-Q_in]_{p_j} column: the conversion then
        # lifts the CENTERED representative (q_t * [Q_in/q_t] = Q_in makes
        # the per-row correction one shared column). v <= nd < 256 fits
        # plane 0 exactly.
        th = (inq >> 1) + 1  # q odd: ceil(q/2)
        v = jnp.sum((xhat >= th).astype(jnp.uint32), axis=0, keepdims=True)
        xhat = jnp.concatenate([xhat, v], axis=0)
    planes = [
        ((xhat >> (RADIX_BITS * k)) & (RADIX - 1)).astype(jnp.bfloat16)
        for k in range(NPLANES)
    ]
    xbig = jnp.concatenate(planes, axis=0).reshape(-1, R * C)
    # ONE product: [P*m, P*nd'] x [P*nd', R*C], f32 accumulation (exact).
    d = jax.lax.dot_general(
        mat_bf16, xbig,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    d = d.astype(jnp.uint32).reshape(NPLANES, m_out, R, C)
    q = out_q[:, None, None]
    hsh = horner_sh[:, None, None]
    # pairing epilogue: one Shoup multiply (by 2^16) instead of three.
    lo = d[0] + (d[1] << RADIX_BITS)  # < 8*q_min for nd <= 32
    hi = d[2] + (d[3] << RADIX_BITS)
    # Every conditional-subtract multiple must stay <= 4q: 8q exceeds
    # 2^32 for q > 2^29 and the wrapped compare corrupts results by
    # 2^32 mod q. So reduce lo (< 8q for nd <= 32, q >= 2^28) to [0, 2q)
    # first, then the sum needs only 4q total.
    q2 = q + q
    lo = jnp.where(lo >= 4 * q, lo - 4 * q, lo)
    lo = jnp.where(lo >= q2, lo - q2, lo)
    r = shoup_mul_lazy(hi, RADIX * RADIX, hsh, q) + lo  # < 4q < 2^32
    r = jnp.where(r >= q2, r - q2, r)
    return jnp.where(r >= q, r - q, r)
