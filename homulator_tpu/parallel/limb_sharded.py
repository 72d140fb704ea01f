"""Limb-axis (RNS-row) sharded operation graphs — the reference's PRIMARY
dispatch, done with explicit collectives.

The reference Driver assigns every per-limb unit of work to cluster
`limb % cluster` (include/Driver.h:155-191: NTT/INTT and AUTO instructions
dispatch by `ins->limb % this->cluster`), so each NTT runs WHOLE on one
cluster and the machine scales by distributing transform COUNT, not
transform size. This module is that dispatch on a device mesh axis 'limb':

  * every multi-row transform batch (ModUp iNTT, per-digit NTTs, ModDown /
    tail NTTs) splits its ROWS across devices — each transform stays
    device-local, whole, and runs the unmodified single-chip NTT leaf (no
    phase splitting, no per-transform all_to_all);
  * each device computes COMPLETE rows of the key-switch accumulator for
    its block of the extended basis: the per-digit base conversion
    (ops/bconv_fused.py) produces any output-row slice from the full digit
    input, and own-digit rows come out of the same contraction EXACTLY
    (only the t = j term of sum_t xhat_t*[Q_d/q_t] survives mod q_j, and
    the centering term v*Q_d vanishes mod q_j), so the digit inner product
    against the row-sharded evk needs NO cross-device reduction at all;
  * the only cross-device traffic is three all_gathers of row blocks: the
    coeff-domain input rows feeding every digit contraction, the alpha
    ModDown specials (bhat), and (hmult tail) the rescale w row.

Contrast with parallel/sharded.py (coefficient-axis dispatch, the
sequence-parallel analog): that path splits every transform's columns and
pays one all_to_all per transform (~360 per hmult) plus a full all_gather
per automorphism. Here the automorphism is a row-local gather (no
collective — the reason the reference dispatches AUTO by limb,
Driver.h:178) and an hmult receives ~3x fewer bytes per device
(ici_bytes_per_op_limb vs sharded.ici_bytes_per_op).

Row padding: the limb axis is padded so every device gets equal blocks
(sm = ceil(level/ns) main rows, sa = ceil(alpha/ns) special rows; the
reference's round-robin handles the same remainder by imbalance instead,
Driver.h:158). Pad rows carry duplicated prime tables and garbage data;
they are masked to zero at the op output and never feed a real row (digit
contractions slice real rows only; v_b sums real specials only).

Bit-exactness vs the single-chip graphs at mesh 2/4/8:
tests/test_sharding.py::TestLimbSharded.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..context import MONTGOMERY, DeviceContext, NttBasis
from ..ops.automorph import automorph_eval
from ..ops.bconv_fused import bconv_fused, build_bf16_tables
from ..ops.modmath import (
    lazy_sum_reduce, lazy_tree_sum, modadd, modsub, mont_mul, mont_mul_lazy,
    shoup_mul, shoup_mul_lazy, to_mont,
)
from ..ops.ntt import intt, intt_rep, ntt_rep
from .mesh import bind_tables, place


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# --------------------------------------------------------------------------
# Table pytrees (device-blocked row layouts, sharded over the 'limb' axis)
# --------------------------------------------------------------------------
@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["step1_pl", "step1_sh", "in_q", "mat_bf16", "horner_sh"],
    meta_fields=["lo", "hi"],
)
@dataclasses.dataclass
class LimbDigitTables:
    """Digit-d ModUp tables; mat/horner rows are in limb-ext block order
    (device i's shard = the conversion matrix rows of ITS ext block, built
    per device by build_limb_tables — includes own rows, which the
    contraction reproduces exactly)."""

    step1_pl: jnp.ndarray  # [nd] replicated
    step1_sh: jnp.ndarray
    in_q: jnp.ndarray  # [nd] replicated (digit's main primes)
    mat_bf16: jnp.ndarray  # [ns*NPLANES*B, NPLANES*(nd+1)] row-sharded
    horner_sh: jnp.ndarray  # [ns*B] row-sharded
    lo: int
    hi: int


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "q_main", "qinv_main", "r2_main", "p_pl", "p_sh",
        "pqinv_pl", "pqinv_sh", "pinv_pl", "pinv_sh",
        "q_sp", "md1_pl", "md1_sh",
        "q_ext", "qinv_ext",
        "main_nt", "sp_nt", "ext_nt", "tailzl_nt",
        "digits",
        "md_bf16", "md_hsh", "one_sp_pl", "one_sp_sh", "q_sp_full",
        "tail_bf16", "tail_hsh", "one_tail_pl", "one_tail_sh", "in_q_tail",
        "md2l_pl", "md2l_sh", "pinv_last_pl", "pinv_last_sh", "q_last",
    ],
    meta_fields=["level", "ns", "alpha", "sa", "sm", "owner_zl", "j_zl",
                 "gchunks"],
)
@dataclasses.dataclass
class LimbTables:
    """All device tables for one (level, ns) limb-sharded key switch.

    Row-axis layouts (global shapes; shard_map shards axis 0 over 'limb'):
      main rows:  [level_pad = ns*sm], natural order 0..level-1, pad dups at
                  the end — device i owns rows [i*sm, (i+1)*sm)
      special rows: [alpha_pad = ns*sa], same construction
      ext rows:   [ns*B], B = sa + sm, device-blocked interleave — device
                  i's block is [its specials, its mains] so the ModDown
                  split (specials prefix / mains suffix) is block-local
    """

    q_main: jnp.ndarray
    qinv_main: jnp.ndarray
    r2_main: jnp.ndarray
    p_pl: jnp.ndarray  # [P]_{q_i} Shoup pair per main row
    p_sh: jnp.ndarray
    pqinv_pl: jnp.ndarray  # [(P*q_last)^{-1}]_{q_i} pair (hmult tail)
    pqinv_sh: jnp.ndarray
    pinv_pl: jnp.ndarray  # [P^{-1}]_{q_i} pair (hrotate moddown)
    pinv_sh: jnp.ndarray
    q_sp: jnp.ndarray  # special primes per special row
    md1_pl: jnp.ndarray  # [(P/p_j)^{-1}]_{p_j} pair per special row
    md1_sh: jnp.ndarray
    q_ext: jnp.ndarray  # [ns*B] ext-order primes
    qinv_ext: jnp.ndarray
    main_nt: NttBasis  # padded main rows
    sp_nt: NttBasis  # padded special rows
    ext_nt: NttBasis  # limb-ext order rows
    tailzl_nt: NttBasis  # per device: [its specials, its zl slot]
    digits: Tuple[LimbDigitTables, ...]
    md_bf16: jnp.ndarray  # ModDown conversion, rows = main blocks
    md_hsh: jnp.ndarray
    one_sp_pl: jnp.ndarray  # identity step1 over the real alpha specials
    one_sp_sh: jnp.ndarray
    q_sp_full: jnp.ndarray  # [alpha] real special primes (replicated)
    tail_bf16: jnp.ndarray  # fused ModDown+Rescale matrix, rows = main blocks
    tail_hsh: jnp.ndarray
    one_tail_pl: jnp.ndarray  # [alpha+2] identity step1 (tail input rows)
    one_tail_sh: jnp.ndarray
    in_q_tail: jnp.ndarray  # [alpha+2] tail input primes
    md2l_pl: jnp.ndarray  # [alpha+1] [P/p_j]_{q_last} pair (w row)
    md2l_sh: jnp.ndarray
    pinv_last_pl: jnp.ndarray  # [P^{-1}]_{q_last} pair (scalar)
    pinv_last_sh: jnp.ndarray
    q_last: jnp.ndarray  # scalar
    level: int
    ns: int
    alpha: int
    sa: int
    sm: int
    owner_zl: int  # device owning main row level-1
    j_zl: int  # its local index of that row
    gchunks: int  # gather pipeline depth G (see _pick_gchunks)


def _pick_gchunks(n1: int, n2: int) -> int:
    """Gather pipeline depth: split every row-block all_gather into G
    column chunks so chunk g+1's transfer can proceed while chunk g's
    per-coefficient conversion compute runs (the overlap the reference's
    NoC gets by construction — pull-on-miss copies concurrent with unit
    pipelines, src/mem.cpp:78-147). G divides n1 and leaves every chunk
    at least 8 rows."""
    del n2
    for g in (4, 2):
        if n1 % g == 0 and n1 // g >= 8:
            return g
    return 1


def build_limb_tables(dc: DeviceContext, level: int, ns: int,
                      gchunks: Optional[int] = None,
                      col_axis: Optional[str] = None) -> LimbTables:
    """Host-side table build for the limb-sharded key switch (cached on
    dc). col_axis: when set (hybrid 2-D limb x coeff mesh, the analog of
    the reference composing its limb dispatch with 2-D BCONV/IP tiling,
    Driver.h:209-285), every NTT basis is built with that shard_axis so
    the transforms inside the limb body run phase-split around an
    all_to_all within the coeff subgroup."""
    t = dc.params.ntt
    if gchunks is None:
        gchunks = _pick_gchunks(t.n1, t.n2)
    ck = ("limb", level, ns, gchunks, col_axis)
    if ck in dc._ks_cache:
        return dc._ks_cache[ck]
    if dc.ntt_mode == MONTGOMERY:
        raise ValueError("the limb path runs the piecewise pipeline's "
                         "tables; use an xla or cuda DeviceContext")
    p = dc.params
    alpha, L = p.alpha, p.max_level
    qn = p.q_arr  # uint64 [K], main rows then specials
    sm = _ceil_div(level, ns)
    sa = _ceil_div(alpha, ns)
    B = sa + sm

    # Padded absolute param-row lists (pad = duplicate of the last real row;
    # pad DATA rows are masked at the output and never feed a real row).
    main_rows = [min(m, level - 1) for m in range(ns * sm)]
    sp_rows = [L + min(j, alpha - 1) for j in range(ns * sa)]
    ext_rows = []  # absolute rows, device-blocked [specials_i, mains_i]
    for i in range(ns):
        ext_rows += sp_rows[i * sa:(i + 1) * sa]
        ext_rows += main_rows[i * sm:(i + 1) * sm]

    owner_zl = (level - 1) // sm
    j_zl = (level - 1) - owner_zl * sm

    def _pair(w_plain: np.ndarray, qrows: np.ndarray):
        w = np.atleast_1d(np.asarray(w_plain, dtype=np.uint64))
        qq = np.atleast_1d(np.asarray(qrows, dtype=np.uint64))
        return (
            jnp.asarray(w.astype(np.uint32)),
            jnp.asarray(((w << np.uint64(32)) // qq).astype(np.uint32)),
        )

    mr = np.array(main_rows)
    sr = np.array(sp_rows)
    er = np.array(ext_rows)

    # ModUp digit tables: per device, the full conversion matrix rows of its
    # ext block (own rows included — contraction-exact, see module doc).
    digits = []
    for d in range(p.beta(level)):
        lo, hi = p.digit_range(level, d)
        s1_pl, s1_sh = _pair(p.ks.modup_step1[(level, d)], qn[lo:hi])
        full_mat = p.ks.modup_step2[(level, d)]  # [K, nd+1], param row order
        mats, hshs = [], []
        for i in range(ns):
            blk = er[i * B:(i + 1) * B]
            mb, hs = build_bf16_tables(full_mat[blk], qn[blk])
            mats.append(mb)
            hshs.append(hs)
        digits.append(LimbDigitTables(
            step1_pl=s1_pl, step1_sh=s1_sh,
            in_q=jnp.asarray(qn[lo:hi].astype(np.uint32)),
            mat_bf16=jnp.concatenate(mats, axis=0),
            horner_sh=jnp.concatenate(hshs, axis=0),
            lo=lo, hi=hi,
        ))

    # ModDown conversion (hrotate): rows = main blocks, input = alpha
    # specials + centering row.
    md_mats, md_hshs = [], []
    for i in range(ns):
        blk = mr[i * sm:(i + 1) * sm]
        mb, hs = build_bf16_tables(p.ks.moddown_step2[blk], qn[blk])
        md_mats.append(mb)
        md_hshs.append(hs)

    # Fused ModDown+Rescale tail (hmult): same construction as
    # context.DeviceContext.keyswitch_tables' TailTables, but rows sliced
    # per device block; rows >= level-1 are zero (dropped limb + padding).
    lm1 = level - 1
    q_last = int(qn[lm1])
    Pprod = p.p_prod
    p_modq = np.array([Pprod % int(q) for q in qn], dtype=np.uint64)
    pq_inv = np.ones(ns * sm, dtype=np.uint64)
    for i in range(lm1):
        pq_inv[i] = pow((Pprod * q_last) % int(qn[i]), -1, int(qn[i]))
    # columns: [P/p_j]_{q_i} (alpha), [-P]_{q_i} (v_b centering),
    # [P]_{q_i} (w row), [-P*q_last]_{q_i} (w centering indicator — see
    # ops/rescale.rescale_poly on why the w row must be centered)
    tail_mat = np.zeros((ns * sm, alpha + 3), dtype=np.uint64)
    tail_mat[:lm1, : alpha + 1] = p.ks.moddown_step2[:lm1]
    tail_mat[:lm1, alpha + 1] = p_modq[:lm1]
    Pq = Pprod * q_last
    tail_mat[:lm1, alpha + 2] = np.array(
        [(int(q) - Pq % int(q)) % int(q) for q in qn[:lm1]],
        dtype=np.uint64)
    t_mats, t_hshs = [], []
    for i in range(ns):
        mb, hs = build_bf16_tables(
            tail_mat[i * sm:(i + 1) * sm], qn[mr[i * sm:(i + 1) * sm]]
        )
        t_mats.append(mb)
        t_hshs.append(hs)
    sp_qn = qn[L: L + alpha]
    in_q_tail = np.concatenate(
        [sp_qn, sp_qn[:1], np.array([q_last, q_last], dtype=np.uint64)]
    )
    one_tail_pl, one_tail_sh = _pair(
        np.ones(alpha + 3, dtype=np.uint64), in_q_tail
    )
    md2l_pl, md2l_sh = _pair(
        p.ks.moddown_step2[lm1], np.full(alpha + 1, q_last, dtype=np.uint64)
    )
    pinv_l_pl, pinv_l_sh = _pair(
        p.ks.pinv_modq[lm1:lm1 + 1], np.array([q_last], dtype=np.uint64)
    )

    # tailzl basis: per device, its specials rows + its zl slot row (the
    # main prime at local index j_zl — only the owner's slot is real).
    tailzl_rows = []
    for i in range(ns):
        tailzl_rows += sp_rows[i * sa:(i + 1) * sa]
        tailzl_rows.append(main_rows[i * sm + j_zl])

    p_pl, p_sh = _pair(p_modq[mr], qn[mr])
    T = LimbTables(
        q_main=jnp.asarray(qn[mr].astype(np.uint32)),
        qinv_main=jnp.asarray(p.qinv_neg[mr].astype(np.uint32)),
        r2_main=jnp.asarray(p.r2[mr].astype(np.uint32)),
        p_pl=p_pl, p_sh=p_sh,
        pqinv_pl=_pair(pq_inv, qn[mr])[0],
        pqinv_sh=_pair(pq_inv, qn[mr])[1],
        pinv_pl=_pair(p.ks.pinv_modq[mr], qn[mr])[0],
        pinv_sh=_pair(p.ks.pinv_modq[mr], qn[mr])[1],
        q_sp=jnp.asarray(qn[sr].astype(np.uint32)),
        md1_pl=_pair(p.ks.moddown_step1[sr - L], qn[sr])[0],
        md1_sh=_pair(p.ks.moddown_step1[sr - L], qn[sr])[1],
        q_ext=jnp.asarray(qn[er].astype(np.uint32)),
        qinv_ext=jnp.asarray(p.qinv_neg[er].astype(np.uint32)),
        main_nt=dc.ntt_basis(tuple(main_rows), col_axis),
        sp_nt=dc.ntt_basis(tuple(sp_rows), col_axis),
        ext_nt=dc.ntt_basis(tuple(ext_rows), col_axis),
        tailzl_nt=dc.ntt_basis(tuple(tailzl_rows), col_axis),
        digits=tuple(digits),
        md_bf16=jnp.concatenate(md_mats, axis=0),
        md_hsh=jnp.concatenate(md_hshs, axis=0),
        one_sp_pl=_pair(np.ones(alpha, dtype=np.uint64), sp_qn)[0],
        one_sp_sh=_pair(np.ones(alpha, dtype=np.uint64), sp_qn)[1],
        q_sp_full=jnp.asarray(sp_qn.astype(np.uint32)),
        tail_bf16=jnp.concatenate(t_mats, axis=0),
        tail_hsh=jnp.concatenate(t_hshs, axis=0),
        one_tail_pl=one_tail_pl, one_tail_sh=one_tail_sh,
        in_q_tail=jnp.asarray(in_q_tail.astype(np.uint32)),
        md2l_pl=md2l_pl, md2l_sh=md2l_sh,
        pinv_last_pl=pinv_l_pl[0], pinv_last_sh=pinv_l_sh[0],
        q_last=jnp.uint32(q_last),
        level=level, ns=ns, alpha=alpha, sa=sa, sm=sm,
        owner_zl=owner_zl, j_zl=j_zl,
        gchunks=gchunks,
    )
    dc._ks_cache[ck] = T
    return T


# --------------------------------------------------------------------------
# PartitionSpec tree (axis 0 of every row-laid-out array over 'limb')
# --------------------------------------------------------------------------
def _ntt_specs_rows(nb: NttBasis, axis: str,
                    col_axis: Optional[str] = None) -> NttBasis:
    """Specs sharding the row (limb) axis of every table; with col_axis
    (hybrid mesh) the [M, n1, n2] mid-twiddle tables additionally shard
    their trailing column axis so each device gets its column slice (the
    same slice the 1-D coeff path's P(None, None, axis) spec delivers)."""
    def lead(a):
        if getattr(a, "size", 1) == 0:
            return P()
        return P(*((axis,) + (None,) * (a.ndim - 1)))

    def lead_mid(a):
        if getattr(a, "size", 1) == 0:
            return P()
        if col_axis is not None and a.ndim == 3:
            return P(axis, None, col_axis)
        return lead(a)

    return NttBasis(
        q=lead(nb.q), qinv=lead(nb.qinv), r2=lead(nb.r2),
        stage1=tuple(lead(s) for s in nb.stage1),
        tw_mid=lead_mid(nb.tw_mid),
        stage2=tuple(lead(s) for s in nb.stage2),
        istage1=tuple(lead(s) for s in nb.istage1),
        tw_mid_inv=lead_mid(nb.tw_mid_inv),
        istage2=tuple(lead(s) for s in nb.istage2),
        psi=tuple(lead(a) for a in nb.psi),
        ipsi=tuple(lead(a) for a in nb.ipsi),
        n1=nb.n1, n2=nb.n2, leaf=nb.leaf, shard_axis=nb.shard_axis,
    )


def _limb_specs(T: LimbTables, axis: str,
                col_axis: Optional[str] = None) -> LimbTables:
    sh = P(axis)  # row-sharded vector

    def digit_specs(dt: LimbDigitTables) -> LimbDigitTables:
        return LimbDigitTables(
            step1_pl=P(), step1_sh=P(), in_q=P(),
            mat_bf16=P(axis, None), horner_sh=sh,
            lo=dt.lo, hi=dt.hi,
        )

    return LimbTables(
        q_main=sh, qinv_main=sh, r2_main=sh, p_pl=sh, p_sh=sh,
        pqinv_pl=sh, pqinv_sh=sh, pinv_pl=sh, pinv_sh=sh,
        q_sp=sh, md1_pl=sh, md1_sh=sh,
        q_ext=sh, qinv_ext=sh,
        main_nt=_ntt_specs_rows(T.main_nt, axis, col_axis),
        sp_nt=_ntt_specs_rows(T.sp_nt, axis, col_axis),
        ext_nt=_ntt_specs_rows(T.ext_nt, axis, col_axis),
        tailzl_nt=_ntt_specs_rows(T.tailzl_nt, axis, col_axis),
        digits=tuple(digit_specs(dt) for dt in T.digits),
        md_bf16=P(axis, None), md_hsh=sh,
        one_sp_pl=P(), one_sp_sh=P(), q_sp_full=P(),
        tail_bf16=P(axis, None), tail_hsh=sh,
        one_tail_pl=P(), one_tail_sh=P(), in_q_tail=P(),
        md2l_pl=P(), md2l_sh=P(), pinv_last_pl=P(), pinv_last_sh=P(),
        q_last=P(),
        level=T.level, ns=T.ns, alpha=T.alpha, sa=T.sa, sm=T.sm,
        owner_zl=T.owner_zl, j_zl=T.j_zl, gchunks=T.gchunks,
    )


# --------------------------------------------------------------------------
# SPMD bodies (inside shard_map; all arrays are LOCAL row blocks)
# --------------------------------------------------------------------------
def _modup_ev_limb(d_eval, T: LimbTables, axis: str):
    """ModUp, rows sharded: iNTT of the local rows, G column-chunked
    all_gathers of the coeff-domain rows, per-chunk fused digit
    conversions, ONE rep-grid NTT over every digit's ext rows.

    The chunked gather is the compute/communication overlap mechanism
    the conversion is per-coefficient math, so
    chunk g's conversions depend ONLY on gather g — in-flight gathers
    g+1..G proceed while resident chunks convert, the software-pipeline
    structure XLA's async collectives + latency-hiding scheduler need
    (the reference's NoC overlaps the same copies with unit pipelines by
    construction, src/mem.cpp:78-147). Returns ev [beta*B, n2, n1]: all
    digits' eval-domain ext rows for this device's block.

    The reference's ModUpINTT -> BConv -> ModUpNTT phases run here as
    local whole transforms per row (Driver.h:155-163 limb dispatch) + the
    bf16 base conversion.
    """
    c_my = intt(d_eval, T.main_nt)  # [sm, n1, n2] local coeff rows
    G = T.gchunks
    chunks = jnp.split(c_my, G, axis=1) if G > 1 else [c_my]
    gparts = [
        jax.lax.all_gather(ch, axis, axis=0, tiled=True) for ch in chunks
    ]
    convs = []
    for dt in T.digits:
        cc = [
            bconv_fused(
                gp[dt.lo:dt.hi], dt.step1_pl, dt.step1_sh, dt.in_q,
                dt.mat_bf16, dt.horner_sh, T.q_ext,
                center=True,
            )  # [B, n1/G, n2]: my ext rows (own rows exact)
            for gp in gparts
        ]
        convs.append(jnp.concatenate(cc, axis=1) if G > 1 else cc[0])
    # Every digit's conv rows live on the SAME per-device ext basis, so
    # all beta digit NTTs run as ONE rep-batched transform (tables
    # shared via i % B — the per-launch overhead matters here: per-shard
    # row counts are small).
    beta = len(T.digits)
    return ntt_rep(jnp.concatenate(convs, axis=0), T.ext_nt, beta)


def _ip_slice(ev, evk, T: LimbTables, sl: slice):
    """Digit inner product restricted to ext-row slice `sl` of this
    device's block. ev: [beta*B, n2, n1] from _modup_ev_limb; evk:
    [dnum, 2, B, n2, n1]. Returns (acc0, acc1) rows for the slice —
    COMPLETE accumulator rows, no cross-device reduction (every device
    holds all digits' conversion-matrix rows for its block; own-digit
    rows come out of the same contraction exactly, see module doc).

    Split so the tail's gather-feeding rows (specials + the zl row) can
    be produced FIRST and the bulk main-row accumulation deferred to
    overlap the in-flight tail gather."""
    B = T.sa + T.sm
    q = T.q_ext[sl][:, None, None]
    qi = T.qinv_ext[sl][:, None, None]
    t0s, t1s = [], []
    for d in range(len(T.digits)):
        ce = ev[d * B:(d + 1) * B][sl]
        t0s.append(mont_mul_lazy(ce, evk[d, 0, sl], q, qi))
        t1s.append(mont_mul_lazy(ce, evk[d, 1, sl], q, qi))
    return lazy_sum_reduce(t0s, q), lazy_sum_reduce(t1s, q)


def _row_ids(T: LimbTables, axis: str):
    i = jax.lax.axis_index(axis).astype(jnp.int32)
    return (i * T.sm + jnp.arange(T.sm, dtype=jnp.int32))[:, None, None]


def _hmult_limb_body(a, b, evk, T: LimbTables, *, axis: str):
    """Row-sharded hmult: tensor product (row-local) -> ModUp
    (_modup_ev_limb, chunk-pipelined gather) -> digit inner product ->
    fused ModDown+relin+Rescale tails around a chunk-pipelined row-block
    gather. Bit-identical (on real rows) to api.hmult_graph; mirrors
    HMULT's program (src/Operation.cpp:913-1112) under the reference's
    limb dispatch (Driver.h:155-191).

    Overlap structure: the modup gather chunks
    overlap the per-chunk digit conversions AND the d0/d1 tensor-product
    math (independent of the gather chain); the tail gather is fed by
    ONLY the specials + zl accumulator rows, so the bulk main-row inner
    product (_ip_slice over the sm main rows) is issued after the gather
    and free to execute while it is in flight."""
    q = T.q_main[:, None, None]
    qi = T.qinv_main[:, None, None]
    r2 = T.r2_main[:, None, None]
    a0m = to_mont(a[0], r2, q, qi)
    a1m = to_mont(a[1], r2, q, qi)
    d2 = mont_mul(b[1], a1m, q, qi)
    ev = _modup_ev_limb(d2, T, axis)
    # d0/d1 are consumed only by the tail: independent of the gather chain
    d0 = mont_mul(b[0], a0m, q, qi)
    d1 = modadd(mont_mul(b[1], a0m, q, qi), mont_mul(b[0], a1m, q, qi), q)

    # --- fused ModDown + relin add + Rescale, rows sharded ---------------
    # Per key: specials + zl-row inner product only (the rows the gather
    # needs), local iNTT, chunked all_gather of [2, sa+1] row blocks, then
    # w / conv_last replicated (single-row math) and the tail conversion +
    # NTT on this device's main rows. Bit-identical to
    # ops/keyswitch.moddown_rescale (same flooring path).
    sa, sm, alpha = T.sa, T.sm, T.alpha
    q_last = T.q_last
    acc_sp = _ip_slice(ev, evk, T, slice(0, sa))
    jz = sa + T.j_zl
    acc_zl = _ip_slice(ev, evk, T, slice(jz, jz + 1))
    q_zl = T.q_main[T.j_zl]
    xs = []
    for k, dd in enumerate((d0, d1)):
        # zl slot: Z mod q_last row (only the owner's slot is real)
        zl_eval = modadd(
            acc_zl[k][0],
            shoup_mul(dd[T.j_zl], T.p_pl[T.j_zl], T.p_sh[T.j_zl], q_zl),
            q_zl,
        )
        xs.append(jnp.concatenate([acc_sp[k], zl_eval[None]], axis=0))
    # both key components' specials+zl iNTTs in one rep-2 grid
    xc2 = intt_rep(jnp.concatenate(xs, axis=0), T.tailzl_nt, 2)
    gs = []
    for k in (0, 1):
        xc = xc2[k * (sa + 1):(k + 1) * (sa + 1)]  # [sa+1, n1, n2]
        bhat_my = shoup_mul(
            xc[:sa], T.md1_pl[:, None, None], T.md1_sh[:, None, None],
            T.q_sp[:, None, None],
        )
        gs.append(jnp.concatenate([bhat_my, xc[sa:]], axis=0))
    g = jnp.stack(gs)  # [2, sa+1, n1, n2]
    G = T.gchunks
    gcs = jnp.split(g, G, axis=2) if G > 1 else [g]
    gfs = [jax.lax.all_gather(gc, axis, axis=1, tiled=True) for gc in gcs]
    # bulk main-row inner product: independent of the tail gathers above —
    # the big deferred block that hides their transfer time
    acc_mn = _ip_slice(ev, evk, T, slice(sa, sa + sm))
    ns = T.ns
    idx_sp = np.concatenate(
        [np.arange(i * (sa + 1), i * (sa + 1) + sa) for i in range(ns)]
    )
    th = ((T.q_sp_full >> 1) + 1)[None, :, None, None]
    tcs = ([], [])
    for gf in gfs:
        bhat = gf[:, idx_sp][:, :alpha]  # [2, alpha, n1/G, n2] real specials
        zl_coeff = gf[:, T.owner_zl * (sa + 1) + sa]  # [2, n1/G, n2]
        v = jnp.sum((bhat >= th).astype(jnp.uint32), axis=1, keepdims=True)
        bhat_ext = jnp.concatenate([bhat, v], axis=1)
        terms = shoup_mul_lazy(
            bhat_ext, T.md2l_pl[None, :, None, None],
            T.md2l_sh[None, :, None, None], q_last,
        )
        conv_last = lazy_tree_sum(terms.swapaxes(0, 1), q_last)
        w = shoup_mul(
            modsub(zl_coeff, conv_last, q_last),
            T.pinv_last_pl, T.pinv_last_sh, q_last,
        )
        # w centering indicator rows (see ops/keyswitch.moddown_rescale)
        ind_w = (w >= ((q_last >> 1) + 1)).astype(jnp.uint32)
        for k in (0, 1):
            tcs[k].append(bconv_fused(
                jnp.concatenate([bhat_ext[k], w[k][None], ind_w[k][None]],
                                axis=0),
                T.one_tail_pl, T.one_tail_sh, T.in_q_tail,
                T.tail_bf16, T.tail_hsh, T.q_main,
                center=False,
            ))  # [sm, n1/G, n2]: my output rows (>= level-1 rows zero)
    convs_t = [
        jnp.concatenate(tc, axis=1) if G > 1 else tc[0] for tc in tcs
    ]
    e2 = ntt_rep(jnp.concatenate(convs_t, axis=0), T.main_nt, 2)
    rows = _row_ids(T, axis)
    outs = []
    for k, dd in enumerate((d0, d1)):
        e = e2[k * sm:(k + 1) * sm]
        z = modadd(
            acc_mn[k],
            shoup_mul(dd, T.p_pl[:, None, None], T.p_sh[:, None, None], q),
            q,
        )
        o = shoup_mul(
            modsub(z, e, q), T.pqinv_pl[:, None, None],
            T.pqinv_sh[:, None, None], q,
        )
        outs.append(jnp.where(rows < T.level - 1, o, jnp.uint32(0)))
    return jnp.stack(outs)


def _hrotate_limb_body(a, perm, rotk, T: LimbTables, *, axis: str,
                       col_route=None):
    """Row-sharded hrotate: the automorphism is a ROW-LOCAL gather (zero
    collective — the reference dispatches AUTO by limb for the same reason,
    Driver.h:178 / include/Components.h:201-238), then ModUp (chunked
    gather, _modup_ev_limb) + split inner product and a row-sharded
    ModDown around a chunk-pipelined bhat all_gather (the main-row IP is
    deferred past the gather issue so it overlaps the transfer —
    same structure as _hmult_limb_body).

    col_route=(col_axis, perm_pairs): hybrid mesh — columns are sharded
    over col_axis, so `perm` is the device-local shard-route gather table
    and the automorphism is one whole-shard ppermute within the coeff
    subgroup (ops/automorph.automorph_eval_shardperm) instead of the flat
    gather. perm_pairs=None is the gather-route sentinel (non-block-
    aligned Galois element, ops/automorph.BlockAlignmentError): `perm`
    is then the FULL flat permutation and the automorphism falls back to
    all_gather over the coeff subgroup + local permute + re-slice (same
    fallback as sharded._hrotate_body)."""
    if col_route is not None:
        from ..ops.automorph import (
            automorph_eval_sharded, automorph_eval_shardperm,
        )

        col_axis, pairs = col_route
        if pairs is None:
            r0 = automorph_eval_sharded(a[0], perm, col_axis)
            r1 = automorph_eval_sharded(a[1], perm, col_axis)
        else:
            r0 = automorph_eval_shardperm(a[0], perm, pairs, col_axis)
            r1 = automorph_eval_shardperm(a[1], perm, pairs, col_axis)
    else:
        r0 = automorph_eval(a[0], perm)
        r1 = automorph_eval(a[1], perm)
    ev = _modup_ev_limb(r1, T, axis)
    sa, sm, alpha = T.sa, T.sm, T.alpha
    q = T.q_main[:, None, None]
    # specials IP only (the rows the gather needs), both key components'
    # iNTTs in one rep-2 grid
    acc_sp = _ip_slice(ev, rotk, T, slice(0, sa))
    xc2 = intt_rep(
        jnp.concatenate([acc_sp[0], acc_sp[1]], axis=0), T.sp_nt, 2)
    bh = [
        shoup_mul(
            xc2[k * sa:(k + 1) * sa], T.md1_pl[:, None, None],
            T.md1_sh[:, None, None], T.q_sp[:, None, None],
        )
        for k in (0, 1)
    ]
    bstack = jnp.stack(bh)  # [2, sa, n1, n2]
    G = T.gchunks
    bcs = jnp.split(bstack, G, axis=2) if G > 1 else [bstack]
    gfs = [jax.lax.all_gather(bc, axis, axis=1, tiled=True) for bc in bcs]
    # bulk main-row inner product overlaps the in-flight gathers
    acc_mn = _ip_slice(ev, rotk, T, slice(sa, sa + sm))
    ccs = ([], [])
    for gf in gfs:
        bhat = gf[:, :alpha]  # [2, alpha, n1/G, n2]
        for k in (0, 1):
            ccs[k].append(bconv_fused(
                bhat[k], T.one_sp_pl, T.one_sp_sh, T.q_sp_full,
                T.md_bf16, T.md_hsh, T.q_main,
                center=True,
            ))  # [sm, n1/G, n2]
    convs_m = [
        jnp.concatenate(cc, axis=1) if G > 1 else cc[0] for cc in ccs
    ]
    ce2 = ntt_rep(jnp.concatenate(convs_m, axis=0), T.main_nt, 2)
    es = []
    for k in (0, 1):
        es.append(shoup_mul(
            modsub(acc_mn[k], ce2[k * sm:(k + 1) * sm], q),
            T.pinv_pl[:, None, None], T.pinv_sh[:, None, None], q,
        ))
    rows = _row_ids(T, axis)
    out0 = jnp.where(rows < T.level, modadd(r0, es[0], q), jnp.uint32(0))
    out1 = jnp.where(rows < T.level, es[1], jnp.uint32(0))
    return jnp.stack([out0, out1])


# --------------------------------------------------------------------------
# Builders + host-layout helpers
# --------------------------------------------------------------------------
def make_limb_hmult(dc: DeviceContext, level: int, mesh: Mesh, *,
                    axis: str = "limb",
                    data_axis: Optional[str] = None,
                    gchunks: Optional[int] = None):
    """jitted f(a_pad, b_pad, evk_limb) -> out_pad over `mesh`: the limb
    (RNS row) axis of ciphertexts and the ext-row axis of the evk sharded
    over mesh axis `axis`. Use pad_main_rows / evk_limb_row_order for the
    layouts; out rows [0, level-1) are the hmult result, the rest zero.

    With data_axis: f(a_batch, b_batch, evk) over [B, 2, level_pad, R, C]
    — ciphertext batch data-parallel over `data_axis`, vmapped inside the
    shard_map (the reference Driver's batch round-robin, Driver.h:193-207,
    composed with its limb dispatch). gchunks overrides the gather
    pipeline depth (_pick_gchunks default)."""
    ns = mesh.shape[axis]
    T = build_limb_tables(dc, level, ns, gchunks)
    T_sp = _limb_specs(T, axis)
    evk_sp = P(None, None, axis, None, None)
    if data_axis is None:
        ct_sp = P(None, axis, None, None)
        body = functools.partial(_hmult_limb_body, axis=axis)
    else:
        ct_sp = P(data_axis, None, axis, None, None)

        def body(a, b, evk, T):
            return jax.vmap(
                lambda x, y: _hmult_limb_body(x, y, evk, T, axis=axis)
            )(a, b)

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(ct_sp, ct_sp, evk_sp, T_sp),
        out_specs=ct_sp,
        check_vma=False,
    )
    return bind_tables(f, place(T, T_sp, mesh))


def make_limb_hrotate(dc: DeviceContext, level: int, mesh: Mesh, *,
                      axis: str = "limb",
                      gchunks: Optional[int] = None):
    """jitted f(a_pad, perm, rotk_limb) -> out_pad (see make_limb_hmult);
    out rows [0, level) are the hrotate result, the rest zero."""
    ns = mesh.shape[axis]
    T = build_limb_tables(dc, level, ns, gchunks)
    T_sp = _limb_specs(T, axis)
    ct_sp = P(None, axis, None, None)
    evk_sp = P(None, None, axis, None, None)
    f = jax.shard_map(
        functools.partial(_hrotate_limb_body, axis=axis), mesh=mesh,
        in_specs=(ct_sp, P(), evk_sp, T_sp),
        out_specs=ct_sp,
        check_vma=False,
    )
    return bind_tables(f, place(T, T_sp, mesh))


def make_hybrid_hmult(dc: DeviceContext, level: int, mesh: Mesh, *,
                      row_axis: str = "limb", col_axis: str = "coeff",
                      data_axis: Optional[str] = None,
                      gchunks: Optional[int] = None):
    """jitted f(a_pad, b_pad, evk_limb) -> out_pad over a 2-D
    (row_axis x col_axis) mesh: RNS rows sharded over `row_axis` (the
    reference's limb dispatch) AND every tile's trailing coefficient axis
    sharded over `col_axis` (each transform runs phase-split around an
    all_to_all within the coeff subgroup) — the composition the
    reference builds as limb dispatch x 2-D BCONV/IP MAC-grid tiling
    (Driver.h:155-191 + 209-285). Layouts as make_limb_hmult with the
    trailing axis additionally sharded.

    At ns=8 (4 limb x 2 coeff) each device keeps sm = 9 rows at level 35
    (not 5) while the columns halve every gather's bytes."""
    ns_l = mesh.shape[row_axis]
    ns_c = mesh.shape[col_axis]
    t = dc.params.ntt
    assert t.n1 % ns_c == 0 and t.n2 % ns_c == 0, (t.n1, t.n2, ns_c)
    T = build_limb_tables(dc, level, ns_l, gchunks, col_axis=col_axis)
    T_sp = _limb_specs(T, row_axis, col_axis)
    evk_sp = P(None, None, row_axis, None, col_axis)
    if data_axis is None:
        ct_sp = P(None, row_axis, None, col_axis)
        body = functools.partial(_hmult_limb_body, axis=row_axis)
    else:
        # 3-D data x limb x coeff mesh: ciphertext batch data-parallel,
        # vmapped inside the shard_map (zero DCN traffic per op when the
        # data axis is the host boundary — the serving layout)
        ct_sp = P(data_axis, None, row_axis, None, col_axis)

        def body(a, b, evk, T_):
            return jax.vmap(
                lambda x, y: _hmult_limb_body(x, y, evk, T_, axis=row_axis)
            )(a, b)

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(ct_sp, ct_sp, evk_sp, T_sp),
        out_specs=ct_sp,
        check_vma=False,
    )
    return bind_tables(f, place(T, T_sp, mesh))


def make_hybrid_hrotate(dc: DeviceContext, level: int, mesh: Mesh, *,
                        row_axis: str = "limb", col_axis: str = "coeff",
                        gchunks: Optional[int] = None):
    """Hybrid-mesh hrotate (see make_hybrid_hmult). Returns f(a_pad,
    route, rotk_limb); `route` is dc.automorph_shard_route(g, ns_c) — the
    automorphism is limb-row-local AND one whole-shard ppermute within
    the coeff subgroup (block-aligned column map,
    ops/automorph.build_shard_route)."""
    ns_l = mesh.shape[row_axis]
    ns_c = mesh.shape[col_axis]
    t = dc.params.ntt
    assert t.n1 % ns_c == 0 and t.n2 % ns_c == 0, (t.n1, t.n2, ns_c)
    T = build_limb_tables(dc, level, ns_l, gchunks, col_axis=col_axis)
    T_sp = _limb_specs(T, row_axis, col_axis)
    T = place(T, T_sp, mesh)
    ct_sp = P(None, row_axis, None, col_axis)
    evk_sp = P(None, None, row_axis, None, col_axis)

    @functools.lru_cache(maxsize=None)
    def compiled(perm_pairs):
        # pairs=None: gather-route fallback — lsrc is the full flat
        # permutation (replicated), not a per-device route table
        lsrc_sp = P() if perm_pairs is None else P(col_axis, None)
        f = jax.shard_map(
            functools.partial(_hrotate_limb_body, axis=row_axis,
                              col_route=(col_axis, perm_pairs)),
            mesh=mesh,
            in_specs=(ct_sp, lsrc_sp, evk_sp, T_sp),
            out_specs=ct_sp,
            check_vma=False,
        )
        return jax.jit(f)

    def run(a, route, rotk):
        local_src, pairs, _ = route
        return compiled(pairs)(a, local_src, rotk, T)

    def lower(a, route, rotk):
        local_src, pairs, _ = route
        return compiled(pairs).lower(a, local_src, rotk, T)

    run.lower = lower
    return run


def ici_bytes_per_op_hybrid(params, level: int, ns_l: int, ns_c: int,
                            op: str = "hmult", *,
                            route_identity: bool = False) -> int:
    """EXACT per-device receive bytes of one hybrid-mesh op,
    HLO-reconciled by tests/test_sharding.py: the limb-axis row gathers
    now carry column slices (1/ns_c of each row) and every transform
    call inside the body pays one all_to_all within the coeff subgroup
    ((ns_c-1)/ns_c of its local [rows, n1/ns_l-block, n2/ns_c] data).
    hrotate adds 2 whole-shard automorph ppermutes (local shard each)."""
    n = params.n
    sm = _ceil_div(level, ns_l)
    sa = _ceil_div(params.alpha, ns_l)
    B = sa + sm
    beta = params.beta(level)
    # limb gathers (column-sliced rows)
    if op == "hmult":
        g_rows = sm + 2 * (sa + 1)
    elif op == "hrotate":
        g_rows = sm + 2 * sa
    else:
        raise ValueError(op)
    gather = (ns_l - 1) * g_rows * (n // ns_c) * 4
    # coeff a2a per transform CALL over this device's LOCAL rows:
    # modup iNTT (sm) + beta digit NTTs (B each; ntt_rep under a
    # shard_axis falls back to per-copy calls) + tails
    if op == "hmult":
        tf_rows = sm + beta * B + 2 * (sa + 1) + 2 * sm
    else:
        tf_rows = sm + beta * B + 2 * sa + 2 * sm
    # tf_rows are already per-device row counts; each row's local slice
    # is n/ns_c coefficients
    a2a = tf_rows * (n // ns_c) * 4 * (ns_c - 1) // ns_c
    autos = 0
    if op == "hrotate" and not route_identity:
        # 2 whole-shard ppermutes of the local [level_pad/ns_l] rows
        # (zero when the element's column block map is the identity)
        autos = 2 * (_ceil_div(level, ns_l)) * (n // ns_c) * 4
    return gather + a2a + autos


def pad_main_rows(data: jnp.ndarray, level: int, ns: int) -> jnp.ndarray:
    """[..., level, R, C] -> [..., ns*ceil(level/ns), R, C], zero pad rows."""
    sm = _ceil_div(level, ns)
    pad = ns * sm - level
    if pad == 0:
        return data
    widths = [(0, 0)] * (data.ndim - 3) + [(0, pad), (0, 0), (0, 0)]
    return jnp.pad(data, widths)


def evk_limb_row_order(params, level: int, ns: int) -> np.ndarray:
    """Row gather indices mapping the uploaded specials-first evk
    ([dnum, 2, K, R, C], rows = [alpha specials, max_level mains]) to the
    limb-ext device-blocked order (pad rows duplicate the last real row;
    their IP products land on masked output rows)."""
    alpha = params.alpha
    sm = _ceil_div(level, ns)
    sa = _ceil_div(alpha, ns)
    order = []
    for i in range(ns):
        for j in range(i * sa, (i + 1) * sa):
            order.append(min(j, alpha - 1))
        for m in range(i * sm, (i + 1) * sm):
            order.append(alpha + min(m, level - 1))
    return np.array(order, dtype=np.int64)


def ici_bytes_per_op_limb(params, level: int, ns: int,
                          op: str = "hmult") -> int:
    """EXACT per-device receive volume (bytes) of one limb-sharded op —
    the counterpart of sharded.ici_bytes_per_op for the limb dispatch,
    reconciled against the lowered HLO by tests/test_sharding.py.

    Two gather SITES per op, each receiving (ns-1) x the local row block
    of N*4-byte rows (each site is split into G = gchunks column-chunked
    all_gathers for compute/communication overlap — same total bytes,
    G x the launch count, see limb_collective_count):
      modup input rows:    sm = ceil(level/ns)      (coeff-domain gather)
      tail/bhat rows:      2*(sa+1) hmult | 2*sa hrotate,
                           sa = ceil(alpha/ns)      (both key components)
    The automorphism and every NTT are device-local: zero per-transform
    traffic (the coeff path pays one all_to_all per transform instead).
    """
    n = params.n
    sm = _ceil_div(level, ns)
    sa = _ceil_div(params.alpha, ns)
    if op == "hmult":
        rows = sm + 2 * (sa + 1)
    elif op == "hrotate":
        rows = sm + 2 * sa
    else:
        raise ValueError(op)
    return (ns - 1) * rows * n * 4


def limb_collective_count(params, level: int, ns: int, op: str = "hmult",
                          gchunks: Optional[int] = None) -> int:
    """Number of collective LAUNCHES per limb-sharded op: both gather
    sites (modup input rows; tail/bhat rows) run as G column-chunked
    all_gathers each."""
    del level, ns, op
    t = params.ntt
    G = gchunks if gchunks is not None else _pick_gchunks(t.n1, t.n2)
    return 2 * G
