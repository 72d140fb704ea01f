"""4-step negacyclic NTT / iNTT over RNS limb arrays.

The real datapath behind the reference's NTTU model (include/Components.h:
297-345; README.md:60-62 "modeled after SHARP"): its
phase1 -> intra-transpose -> inter-transpose -> phase2 pipeline is exactly
the 4-step factorization N = n1*n2 used here:

  step 1: n2 parallel size-n1 merged-twist negacyclic sub-NTTs along the
          leading axis (every butterfly is a full-row vector op)
  step 2: mid twiddle multiply (one fused constant pass; also pre-twists
          the cyclic step-4 DFT into negacyclic form — see params.py)
  step 3: [n1, n2] transpose (the "interTrans" stage; on a sharded
          coefficient axis this becomes an all_to_all)
  step 4: n1 parallel size-n2 sub-NTTs

Three leaves implement it (NttBasis.leaf), all bit-identical:
  montgomery — Montgomery-form per-stage twiddles (the plain pipeline);
  xla        — flat Shoup stage tables, one XLA op chain per stage;
  cuda       — the same Shoup tables in a two-pass CUDA kernel
               (ops/ntt_cuda.cu). Sharded bodies run the xla phases.

Output ordering is the network's natural permuted evaluation order
(params.NttTables.eval_index); all pointwise consumers are order-agnostic
and automorphism gathers are precomputed in this order.

Arrays are [..., M, rows, cols] with one [rows, cols] tile per RNS limb;
leading dims (vmap batches, stacked copies of one basis) share the tables.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..context import CUDA, MONTGOMERY, NttBasis
from .modmath import modadd, modsub, mont_mul, shoup_mul


def _butterfly_view(x: jnp.ndarray, s: int):
    """[..., M, n, m] -> (u, v) halves of stage s: [..., M, 2^s, H, m]."""
    *lead, M, n, m = x.shape
    B = 1 << s
    xr = x.reshape(*lead, M, B, 2, n // (2 * B), m)
    return xr[..., 0, :, :], xr[..., 1, :, :]


def _ct_stages(x: jnp.ndarray, tws: Tuple[jnp.ndarray, ...], q, qinv) -> jnp.ndarray:
    """CT DIT butterfly network along axis -2 (Montgomery twiddles)."""
    M = x.shape[-3]
    q4 = q.reshape(M, 1, 1, 1)
    qi4 = qinv.reshape(M, 1, 1, 1)
    for s, tw in enumerate(tws):
        u, xv = _butterfly_view(x, s)
        v = mont_mul(xv, tw[:, :, None, None], q4, qi4)
        x = jnp.stack([modadd(u, v, q4), modsub(u, v, q4)], axis=-3).reshape(x.shape)
    return x


def _gs_stages(x: jnp.ndarray, tws: Tuple[jnp.ndarray, ...], q, qinv) -> jnp.ndarray:
    """GS inverse butterfly network along axis -2 (no 1/n factor; it is
    folded into tw_mid_inv)."""
    M = x.shape[-3]
    q4 = q.reshape(M, 1, 1, 1)
    qi4 = qinv.reshape(M, 1, 1, 1)
    for s in range(len(tws) - 1, -1, -1):
        u, v = _butterfly_view(x, s)
        s0 = modadd(u, v, q4)
        s1 = mont_mul(modsub(u, v, q4), tws[s][:, :, None, None], q4, qi4)
        x = jnp.stack([s0, s1], axis=-3).reshape(x.shape)
    return x


def _stage_pair(tw, tw_sh, s: int):
    """Stage-s Shoup pair from a flat table, shaped [M, 2^s, 1, 1]."""
    lo, hi = 1 << s, 2 << s
    return tw[:, lo:hi, None, None], tw_sh[:, lo:hi, None, None]


def _ct_stages_shoup(x: jnp.ndarray, tw, tw_sh, q) -> jnp.ndarray:
    """CT DIT network along axis -2 with flat Shoup tables [M, n]."""
    M, n = tw.shape
    q4 = q.reshape(M, 1, 1, 1)
    for s in range(n.bit_length() - 1):
        u, xv = _butterfly_view(x, s)
        w, wsh = _stage_pair(tw, tw_sh, s)
        v = shoup_mul(xv, w, wsh, q4)
        x = jnp.stack([modadd(u, v, q4), modsub(u, v, q4)], axis=-3).reshape(x.shape)
    return x


def _gs_stages_shoup(x: jnp.ndarray, tw, tw_sh, q) -> jnp.ndarray:
    """GS inverse network along axis -2 with flat Shoup tables [M, n]."""
    M, n = tw.shape
    q4 = q.reshape(M, 1, 1, 1)
    for s in range(n.bit_length() - 2, -1, -1):
        u, v = _butterfly_view(x, s)
        w, wsh = _stage_pair(tw, tw_sh, s)
        s0 = modadd(u, v, q4)
        s1 = shoup_mul(modsub(u, v, q4), w, wsh, q4)
        x = jnp.stack([s0, s1], axis=-3).reshape(x.shape)
    return x


def _mid(y: jnp.ndarray, tw_mid: jnp.ndarray, nb: NttBasis) -> jnp.ndarray:
    M = nb.q.shape[0]
    return mont_mul(y, tw_mid, nb.q.reshape(M, 1, 1), nb.qinv.reshape(M, 1, 1))


# The four device-local phases of the 4-step transform; the transpose
# between them is local (ntt/intt) or an all_to_all (sharded bodies).
def _fwd_phase1(x: jnp.ndarray, nb: NttBasis) -> jnp.ndarray:
    """Size-n1 stages over [..., M, n1, c] + mid twiddle."""
    if nb.leaf == MONTGOMERY:
        y = _ct_stages(x, nb.stage1, nb.q, nb.qinv)
    else:
        y = _ct_stages_shoup(x, nb.psi[0], nb.psi[1], nb.q)
    return _mid(y, nb.tw_mid, nb)


def _fwd_phase2(y: jnp.ndarray, nb: NttBasis) -> jnp.ndarray:
    """Size-n2 stages over [..., M, n2, c]."""
    if nb.leaf == MONTGOMERY:
        return _ct_stages(y, nb.stage2, nb.q, nb.qinv)
    return _ct_stages_shoup(y, nb.psi[2], nb.psi[3], nb.q)


def _inv_phase2(x: jnp.ndarray, nb: NttBasis) -> jnp.ndarray:
    """Inverse size-n2 stages over [..., M, n2, c]."""
    if nb.leaf == MONTGOMERY:
        return _gs_stages(x, nb.istage2, nb.q, nb.qinv)
    return _gs_stages_shoup(x, nb.ipsi[2], nb.ipsi[3], nb.q)


def _inv_phase1(y: jnp.ndarray, nb: NttBasis) -> jnp.ndarray:
    """Inverse mid twiddle + size-n1 stages over [..., M, n1, c]."""
    y = _mid(y, nb.tw_mid_inv, nb)
    if nb.leaf == MONTGOMERY:
        return _gs_stages(y, nb.istage1, nb.q, nb.qinv)
    return _gs_stages_shoup(y, nb.ipsi[0], nb.ipsi[1], nb.q)


def _transpose_a2a(y: jnp.ndarray, axis: str) -> jnp.ndarray:
    """Distributed tile transpose inside shard_map: y is the LOCAL column
    slice [M, a, b/ns] of a global [M, a, b] array sharded on its trailing
    axis over mesh axis `axis`; returns the local slice [M, b, a/ns] of the
    global transpose [M, b, a], again trailing-sharded. ONE all_to_all
    (the reference NTTU's interTrans stage, src/Components.cpp:411-419) +
    a device-local transpose."""
    # split my `a` rows into ns chunks, send chunk i to device i, receive
    # every device's rows for MY chunk concatenated along the column axis
    # (blocks arrive in device order = global column order).
    z = jax.lax.all_to_all(y, axis, split_axis=1, concat_axis=2, tiled=True)
    return z.transpose(0, 2, 1)  # [M, b, a/ns]


def ntt(x: jnp.ndarray, nb: NttBasis) -> jnp.ndarray:
    """x: [..., M, n1, n2] coeff tiles -> [..., M, n2, n1] eval tiles.
    Device arrays are 3-D per limb set everywhere (coeff = [n1, n2], eval
    = [n2, n1]); the flat order is only materialized at host boundaries.
    Under nb.shard_axis this is an SPMD body over local column slices."""
    if nb.shard_axis is not None:
        y = _fwd_phase1(x, nb)
        return _fwd_phase2(_transpose_a2a(y, nb.shard_axis), nb)
    if nb.leaf == CUDA:
        from .ntt_cuda import ntt_cuda

        return ntt_cuda(x, nb)
    y = _fwd_phase1(x, nb)
    return _fwd_phase2(jnp.swapaxes(y, -1, -2), nb)


def intt(x: jnp.ndarray, nb: NttBasis) -> jnp.ndarray:
    """x: [..., M, n2, n1] eval tiles -> [..., M, n1, n2] coeff tiles."""
    if nb.shard_axis is not None:
        y = _inv_phase2(x, nb)
        return _inv_phase1(_transpose_a2a(y, nb.shard_axis), nb)
    if nb.leaf == CUDA:
        from .ntt_cuda import intt_cuda

        return intt_cuda(x, nb)
    y = _inv_phase2(x, nb)
    return _inv_phase1(jnp.swapaxes(y, -1, -2), nb)


def _rep(fn, x: jnp.ndarray, nb: NttBasis, rep: int) -> jnp.ndarray:
    """fn over rep stacked copies [rep*M, R, C] of one basis. Single-chip
    leaves transform them as one [rep, M, R, C] batch sharing the tables;
    sharded bodies (whose all_to_all is per 3-D tile) run per copy."""
    if rep == 1:
        return fn(x, nb)
    M = x.shape[0] // rep
    if nb.shard_axis is not None:
        return jnp.concatenate(
            [fn(x[k * M: (k + 1) * M], nb) for k in range(rep)], axis=0)
    y = fn(x.reshape((rep, M) + x.shape[1:]), nb)
    return y.reshape((rep * M,) + y.shape[2:])


def ntt_rep(x: jnp.ndarray, nb: NttBasis, rep: int) -> jnp.ndarray:
    """Transform rep stacked arrays over the SAME basis in one call:
    x [rep*M, n1, n2] -> [rep*M, n2, n1] (e.g. both key components of a
    ModDown)."""
    return _rep(ntt, x, nb, rep)


def intt_rep(x: jnp.ndarray, nb: NttBasis, rep: int) -> jnp.ndarray:
    """Inverse of ntt_rep: [rep*M, n2, n1] -> [rep*M, n1, n2]."""
    return _rep(intt, x, nb, rep)
