"""Galois automorphism (rotation/conjugation) in the evaluation domain.

The reference models this as the AUTOU log-stage coefficient-swap network
(include/Components.h:201-238). On the device, with ciphertexts resident in the
evaluation domain, sigma_g is a fixed slot permutation precomputed in our
NTT's native evaluation order (params.CkksParams.automorph_eval_perm); the
kernel is a single gather along the coefficient axis, identical for every
limb.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


class BlockAlignmentError(ValueError):
    """A Galois element's induced column map is not block-aligned for this
    shard count — the whole-shard ppermute route does not exist and the
    caller must fall back to the all_gather form (automorph_eval_sharded).
    Never observed for power-of-two N (verified exhaustively at
    N = 2^8..2^16); typed so the dispatch layer can route instead of
    crashing."""


def automorph_eval(x: jnp.ndarray, perm: jnp.ndarray) -> jnp.ndarray:
    """x: [..., n2, n1] eval-domain tiles; perm: int32[N] gather indices
    over the flat eval order (the gather works on the flattened slot
    axis; device data is 3-D elsewhere, see ops/ntt.py)."""
    r, c = x.shape[-2:]
    flat = x.reshape(x.shape[:-2] + (r * c,))
    return jnp.take(flat, perm, axis=-1).reshape(x.shape)


def automorph_eval_staged(x: jnp.ndarray, s1: jnp.ndarray, s2: jnp.ndarray,
                          s3: jnp.ndarray) -> jnp.ndarray:
    """3-stage form of the same permutation: sublane gather, lane gather,
    sublane gather (ops/perm_decomp.py — the routing-network realization
    of the reference's AUTOU stage fabric, include/Components.h:201-238).
    x: [..., n2, n1]; s*: int32[n2, n1] stage maps. Bit-identical to
    automorph_eval(x, perm) for maps built from the same perm."""
    nd = x.ndim - 2
    s1b = s1.reshape((1,) * nd + s1.shape)
    s2b = s2.reshape((1,) * nd + s2.shape)
    s3b = s3.reshape((1,) * nd + s3.shape)
    t1 = jnp.take_along_axis(x, s1b, axis=-2)
    t2 = jnp.take_along_axis(t1, s2b, axis=-1)
    return jnp.take_along_axis(t2, s3b, axis=-2)


def automorph_eval_sharded(x: jnp.ndarray, perm: jnp.ndarray,
                           axis: str) -> jnp.ndarray:
    """SPMD body (inside shard_map): x is the local column slice
    [..., n2, n1/ns] of an eval-domain tile sharded on its trailing axis
    over mesh axis `axis`. sigma_g moves slots arbitrarily across devices
    (the reference's AUTOU swap network crossing cluster lanes,
    include/Components.h:201-238): all_gather + local permute + re-slice.

    Receive volume is (ns-1) x the local shard; the a2a route below moves
    ns/2 x less — this gather form is kept as the fallback/reference
    implementation (tests pin the two equal)."""
    full = jax.lax.all_gather(x, axis, axis=x.ndim - 1, tiled=True)
    rot = automorph_eval(full, perm)
    c = x.shape[-1]
    i = jax.lax.axis_index(axis)
    return jax.lax.dynamic_slice_in_dim(rot, i * c, c, axis=x.ndim - 1)


def build_shard_route(perm: np.ndarray, n2: int, n1: int, ns: int):
    """Host precompute: sigma_g across an ns-way column-sharded [n2, n1]
    eval tile is ONE whole-shard ppermute + one local gather.

    Why a pure shard permutation: flat position p = s*n1 + r holds eval
    index perm1[r] + n1*perm2[s]; sigma_g is affine on eval indices
    (k -> g*k + (g-1)/2 mod N) and g*n1*perm2[s] vanishes mod n1, so the
    output COLUMN depends only on the input column — and because perm1 is
    the sub-NTT's bit-reversed output order while an affine map's low bits
    depend only on the input's low bits, the induced column permutation
    maps each block of n1/ns columns WHOLESALE onto one destination block
    (asserted below; verified for every Galois element at N = 2^8..2^16).
    Receive volume is one local shard — ns/(ns-1) x less than all_gather
    per device pair count, (ns-1) x less in total.

    Returns (src_dev [ns] int: source device per dest device — the
    ppermute pairs are (src_dev[i], i) — local_src int32[ns, n2*(n1/ns)]:
    out_local[p] = received_shard_flat[local_src[i][p]], and is_identity).
    """
    n = n2 * n1
    assert n1 % ns == 0
    c = n1 // ns
    perm = np.asarray(perm, dtype=np.int64)
    k = np.arange(n, dtype=np.int64)
    col_out = k % n1
    col_src = perm % n1
    dj = col_src // c  # source device of each output element
    di = col_out // c  # destination device
    src_dev = np.full(ns, -1, dtype=np.int64)
    for i in range(ns):
        js = np.unique(dj[di == i])
        if len(js) != 1:
            raise BlockAlignmentError(
                f"column map not block-aligned (dest block {i} pulls from "
                f"source blocks {js.tolist()}) — fall back to "
                "automorph_eval_sharded")
        src_dev[i] = js[0]
    assert sorted(src_dev.tolist()) == list(range(ns))
    local_src = np.zeros((ns, n2 * c), dtype=np.int32)
    local_dst = (k // n1) * c + (col_out - di * c)
    srcpos = (perm // n1) * c + (col_src - dj * c)
    local_src[di, local_dst] = srcpos.astype(np.int32)
    return src_dev, local_src, bool((src_dev == np.arange(ns)).all())


def automorph_eval_shardperm(x: jnp.ndarray, local_src: jnp.ndarray,
                             perm_pairs, axis: str) -> jnp.ndarray:
    """SPMD body: sigma_g on the local column slice x [..., n2, n1/ns] via
    the shard-permutation route (build_shard_route). local_src is this
    device's gather table [n2*(n1/ns)]; perm_pairs the static ppermute
    pairs ([] when the block map is the identity — then zero ICI, like the
    limb path). Bit-identical to automorph_eval_sharded."""
    if perm_pairs:
        x = jax.lax.ppermute(x, axis, perm_pairs)
    lead = x.shape[:-2]
    flat = x.reshape(lead + (-1,))
    return jnp.take(flat, local_src, axis=-1).reshape(x.shape)
