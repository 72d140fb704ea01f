"""RNS base conversion (the reference BCONVU's real datapath).

The reference models this as a num_high x num_width systolic MAC grid with
accumulation along the input-limb axis (include/Components.h:245-295,
Driver.h:209-246). Here it is the approximate (HPS) conversion

    out[j] = sum_i ( x_i * [(Q_in/q_i)^{-1}]_{q_i} mod q_i ) * [Q_in/q_i]_{p_j}
             (mod p_j)

computed as a small static contraction over input limbs: per output prime
a chain of Montgomery constant-multiplies and modular adds. The input-limb
loop is unrolled (nd <= alpha <= 28) — this is the BCONV "systolic width".
"""

from __future__ import annotations

import jax.numpy as jnp

from .modmath import modadd, mont_mul


def _bcol(v: jnp.ndarray, ndim: int) -> jnp.ndarray:
    """Reshape a [K] constant vector for broadcast against [K, ...] data."""
    return v.reshape(v.shape + (1,) * (ndim - 1))


def bconv_step1(x: jnp.ndarray, s1_mont: jnp.ndarray, in_q, in_qinv) -> jnp.ndarray:
    """Scale input limbs by the inverse punctured products: x_i * (Q/q_i)^{-1}.
    x: [nd, ...] (trailing dims are coefficient tiles)."""
    nd = x.ndim
    return mont_mul(x, _bcol(s1_mont, nd), _bcol(in_q, nd), _bcol(in_qinv, nd))


def bconv_step2(
    xhat: jnp.ndarray,  # [nd, ...] scaled residues (treated as lifted integers)
    mat_mont: jnp.ndarray,  # [Mout, nd] Montgomery-form punctured products
    out_q: jnp.ndarray,  # [Mout]
    out_qinv: jnp.ndarray,
) -> jnp.ndarray:
    """out[j] = sum_i xhat[i] * mat[j, i] mod out_q[j]  -> [Mout, ...].
    (Montgomery graph path; the bf16 conversion lives in bconv_fused.py.)"""
    nd = xhat.shape[0]
    rank = xhat.ndim
    oq = _bcol(out_q, rank)
    oqi = _bcol(out_qinv, rank)
    acc = mont_mul(xhat[0][None], _bcol(mat_mont[:, 0], rank), oq, oqi)
    for t in range(1, nd):
        term = mont_mul(xhat[t][None], _bcol(mat_mont[:, t], rank), oq, oqi)
        acc = modadd(acc, term, oq)
    return acc
