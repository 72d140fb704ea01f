"""CKKS rescale: exact RNS division by the dropped prime.

Real implementation of the reference's Rescale pipeline
(src/Operation.cpp:741-911): iNTT the last limb (NTTOps), re-NTT its
coefficients into each remaining basis, subtract (SubOps), multiply by
[q_last^{-1}]_{q_i} (MulOps). Drops one limb; caller decrements level and
divides the scale by q_last.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..context import NttBasis
from .modmath import modsub, mont_mul, shoup_mul
from .ntt import intt, ntt


def _reduce_small(v: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Reduce v < 2**30 modulo q > 2**28 via at most 3 conditional subtracts."""
    for _ in range(3):
        v = jnp.where(v >= q, v - q, v)
    return v


def rescale_poly(
    c: jnp.ndarray,  # [level, R, C] eval-domain tiles
    last_nt: NttBasis,  # basis of the dropped limb only (1 row)
    out_nt: NttBasis,  # remaining main basis (level-1 rows)
    qinv_tabs,  # (mont, plain, shoup) triple of [level-1] [q_last^{-1}]_{q_i}
) -> jnp.ndarray:
    """Subtracts the CENTERED remainder r~ = r - q_last*[r >= ceil(q/2)]
    before the exact division — without centering the decrypt error gains
    a key-dependent DC bias from the r1*s cross term (~sqrt(N) coefficient
    units) that decodes into a deterministic slot-0 tone (see
    refimpl.rescale; bit-identical to it and to the fused
    keyswitch.moddown_rescale tail's w-row centering)."""
    level = c.shape[0]
    last_coeff = intt(c[level - 1: level], last_nt)  # [1, n1, n2], [0, q_last)
    q_last = last_nt.q[0]
    ind = last_coeff >= ((q_last >> 1) + 1)
    oq = out_nt.q[:, None, None]
    oqi = out_nt.qinv[:, None, None]
    # centered rep mod q_i: r + 2*q_i - q_last < 2*q_i when ind
    red = jnp.where(ind, last_coeff + (oq + oq - q_last), last_coeff)
    red = _reduce_small(red, oq)
    red_eval = ntt(red, out_nt)
    diff = modsub(c[: level - 1], red_eval, oq)
    mont, pl, sh = qinv_tabs
    if out_nt.piecewise:
        return shoup_mul(diff, pl[:, None, None], sh[:, None, None], oq)
    return mont_mul(diff, mont[:, None, None], oq, oqi)
