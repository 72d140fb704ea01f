"""Device-side context: uint32 table pytrees + ciphertext containers.

Replaces the reference's address-space data model (include/Context.h:10-166
`Polynominal`/`Ciphertext`/`Plaintext` address containers and Addr.h's named
bump allocator): here a ciphertext is a real HBM-resident limb-major
uint32[2, level, N] array plus (level, scale, domain) metadata, and XLA owns
allocation (SURVEY.md §2 "AddrManage ... not needed as allocator").

All multiplicative constants are stored in Montgomery form (see
ops/modmath.py). Data arrays always hold standard-domain residues.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .params import CkksParams

EVAL = "eval"
COEFF = "coeff"


def _to_mont_np(x: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(x << 32) % q in exact uint64 (x < 2**30)."""
    return ((x.astype(np.uint64) << np.uint64(32)) % q.astype(np.uint64)).astype(
        np.uint32
    )


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["data"],
    meta_fields=["level", "scale", "domain"],
)
@dataclasses.dataclass
class Ciphertext:
    """data: uint32[2, level, n2, n1] eval-domain tiles (standard-domain
    residues). Device polynomials are 3-D [limb, rows, cols] everywhere —
    eval = [n2, n1], coeff = [n1, n2] (the 4-step NTT's natural layouts) —
    so kernel boundaries never pay an XLA tiled-layout relayout; the flat
    [N] order exists only host-side."""

    data: jnp.ndarray
    level: int
    scale: float
    domain: str = EVAL

    def __post_init__(self):
        assert self.data.ndim == 4 and self.data.shape[0] == 2
        assert self.data.shape[1] == self.level, (self.data.shape, self.level)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["data"],
    meta_fields=["level", "scale", "domain"],
)
@dataclasses.dataclass
class Plaintext:
    """data: uint32[level, n2, n1] eval-domain tiles (see Ciphertext)."""

    data: jnp.ndarray
    level: int
    scale: float
    domain: str = EVAL


MONTGOMERY = "montgomery"
XLA = "xla"
CUDA = "cuda"
NTT_MODES = (MONTGOMERY, XLA, CUDA)


def default_ntt_mode() -> str:
    """The NTT leaf `auto` resolves to: the CUDA kernel on a GPU (the
    fastest of the three leaves end to end on an H100, PERF.md), the XLA
    leaf elsewhere. Both run the piecewise key-switch pipeline."""
    return CUDA if jax.default_backend() == "gpu" else XLA


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["q", "qinv", "r2", "stage1", "tw_mid", "stage2",
                 "istage1", "tw_mid_inv", "istage2", "psi", "ipsi"],
    meta_fields=["n1", "n2", "leaf", "shard_axis"],
)
@dataclasses.dataclass
class NttBasis:
    """Row-aligned NTT tables for one ordered prime basis (M rows).

    tw_mid/tw_mid_inv: uint32[M, n1, n2] Montgomery-form mid twiddles
    (every leaf). stage*/istage*: tuples of uint32[M, 2**s] Montgomery
    stage twiddles (montgomery leaf only). psi/ipsi: flat Shoup stage
    tables (xla and cuda leaves), each (tw1, tw1_sh, tw2, tw2_sh) with
    tw1 uint32[M, n1], tw2 uint32[M, n2]: stage s, block b at index
    2**s + b, *_sh = floor(w * 2^32 / q).

    leaf: which implementation transforms (MONTGOMERY, XLA or CUDA). Every
    leaf but MONTGOMERY carries the Shoup tables the piecewise key-switch
    pipeline reads (`piecewise`).

    shard_axis: when set (a mesh axis name), ntt/intt run as SPMD bodies
    inside shard_map with the trailing (coefficient) axis of every tile
    sharded over that axis: butterfly phases stay device-local and the
    4-step inter-transpose becomes an all_to_all (the reference's
    interTrans stage, config_4.cfg:48, src/Components.cpp:411-419). The
    mid-twiddle tables must then be passed through shard_map with a
    matching P(None, None, shard_axis) spec (parallel/sharded.py).
    """

    q: jnp.ndarray
    qinv: jnp.ndarray
    r2: jnp.ndarray
    stage1: Tuple[jnp.ndarray, ...]
    tw_mid: jnp.ndarray
    stage2: Tuple[jnp.ndarray, ...]
    istage1: Tuple[jnp.ndarray, ...]
    tw_mid_inv: jnp.ndarray
    istage2: Tuple[jnp.ndarray, ...]
    psi: Tuple[jnp.ndarray, ...]
    ipsi: Tuple[jnp.ndarray, ...]
    n1: int
    n2: int
    leaf: str
    shard_axis: Optional[str] = None

    @property
    def piecewise(self) -> bool:
        """True when the piecewise key-switch pipeline runs on this basis
        (own-digit passthrough, concat-free ModDown, fused tail)."""
        return self.leaf != MONTGOMERY


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["step1_mont", "step1_pl", "step1_sh",
                 "mat_other_mont", "mat_bf16", "horner_sh", "other_nt"],
    meta_fields=["lo", "hi"],
)
@dataclasses.dataclass
class ModUpDigitTables:
    """Per-digit ModUp tables at a fixed level, rows aligned to ext basis.

    step1_mont: uint32[nd] — [(Q_d/q_i)^{-1}]_{q_i} for i in the digit.
    mat_other: uint32[K_ext - nd, nd] — [Q_d/q_i]_{p_j} for every ext basis
    row j *outside* the digit (own rows pass residues through unscaled —
    the reference's Decomp routing, src/Operation.cpp:190-292). The jnp
    path multiplies with the Montgomery form; the piecewise pipeline uses
    the bf16-plane conversion (ops/bconv_fused.py) over the other rows
    only and copies own rows from the eval-domain input (the conversion
    reproduces own residues exactly, so own rows never need the
    iNTT->NTT round trip).
    other_nt: NttBasis over the other rows (piecewise pipeline).
    lo/hi: digit's row span within the ext basis ordering.
    """

    step1_mont: jnp.ndarray
    step1_pl: jnp.ndarray
    step1_sh: jnp.ndarray
    mat_other_mont: jnp.ndarray
    mat_bf16: jnp.ndarray
    horner_sh: jnp.ndarray
    other_nt: Optional["NttBasis"]
    lo: int
    hi: int


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["bf16", "horner_sh", "in_q", "one_pl", "one_sh",
                 "p_pl", "p_sh", "pq_inv_pl", "pq_inv_sh",
                 "md2_last_pl", "md2_last_sh", "last_nt", "out_nt"],
    meta_fields=[],
)
@dataclasses.dataclass
class TailTables:
    """Fused ModDown+Rescale tables (divide by P*q_last in ONE conversion).

    The hmult tail `moddown -> relin add -> rescale` computes
    (acc + P*d - E) * (P*q_last)^{-1} per limb, where E converts
    [bhat (alpha specials); w_last (Z mod q_last)] through the combined
    [level-1, alpha+1] matrix (cols: [P/p_j]_{q_i}, last col [P]_{q_i}).
    Bit-identical to the sequential pipeline (same flooring path), but
    saves a full per-component NTT broadcast (~level transforms).

    bf16/horner_sh: fused-kernel tables of that matrix. in_q: [alpha+1]
    input primes (specials + q_last). one_pl/one_sh: identity step1 pair.
    p_pl/p_sh: [level] Shoup pair of [P]_{q_i}. pq_inv_*: [level-1] pair
    of [(P*q_last)^{-1}]_{q_i}. md2_last_*: [alpha] pair of
    [P/p_j]_{q_last} (the conv row that feeds w_last). last_nt: basis of
    the dropped limb; out_nt: main basis at level-1.
    """

    bf16: jnp.ndarray
    horner_sh: jnp.ndarray
    in_q: jnp.ndarray
    one_pl: jnp.ndarray
    one_sh: jnp.ndarray
    p_pl: jnp.ndarray
    p_sh: jnp.ndarray
    pq_inv_pl: jnp.ndarray
    pq_inv_sh: jnp.ndarray
    md2_last_pl: jnp.ndarray
    md2_last_sh: jnp.ndarray
    last_nt: "NttBasis"
    out_nt: "NttBasis"


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["digits", "main_nt", "ext_nt", "special_nt",
                 "moddown_s1_mont", "moddown_s1_pl", "moddown_s1_sh",
                 "moddown_s2_mont", "moddown_bf16", "moddown_horner_sh",
                 "pinv_mont", "pinv_pl", "pinv_sh", "tail"],
    meta_fields=["level"],
)
@dataclasses.dataclass
class KeySwitchLevelTables:
    digits: Tuple[ModUpDigitTables, ...]
    main_nt: NttBasis
    ext_nt: NttBasis
    special_nt: NttBasis
    moddown_s1_mont: jnp.ndarray  # [alpha]
    moddown_s1_pl: jnp.ndarray
    moddown_s1_sh: jnp.ndarray
    moddown_s2_mont: jnp.ndarray  # [level, alpha+1] (jnp path; last col =
    # the [-P]_{q_i} centering column consumed by the virtual row)
    moddown_bf16: jnp.ndarray  # bf16 plane table (piecewise pipeline)
    moddown_horner_sh: jnp.ndarray  # [level] Horner Shoup quotients
    pinv_mont: jnp.ndarray  # [level]
    pinv_pl: jnp.ndarray
    pinv_sh: jnp.ndarray
    tail: Optional[TailTables]  # fused moddown+rescale (piecewise pipeline)
    level: int


class DeviceContext:
    """Holds all device-resident tables for one CkksParams.

    Not a pytree: jitted ops receive the small per-call table pytrees
    (NttBasis / KeySwitchLevelTables) built and cached here.
    """

    def __init__(self, params: CkksParams, ntt_mode: str = "auto"):
        """ntt_mode: which leaf transforms — 'auto' (default_ntt_mode),
        'xla', 'cuda' (both run the piecewise key-switch pipeline), or
        'montgomery' (the plain Montgomery pipeline: every digit fully
        converted and transformed, separate ModDown and rescale)."""
        self.params = params
        if ntt_mode == "auto":
            ntt_mode = default_ntt_mode()
        if ntt_mode not in NTT_MODES:
            raise ValueError(f"ntt_mode {ntt_mode!r} not in {NTT_MODES}")
        if ntt_mode == CUDA:
            from .ops.ntt_cuda import load

            load()
        self.ntt_mode = ntt_mode
        p = params
        K = p.num_primes
        qn = p.q_arr
        # All tables are kept host-side (numpy) and sliced in numpy; only
        # the per-basis / per-level slices actually used become device
        # arrays.
        self.q_np = qn.astype(np.uint32)
        self.qinv_np = p.qinv_neg.astype(np.uint32)
        self.r2_np = p.r2.astype(np.uint32)
        self.q = jnp.asarray(self.q_np)
        self.qinv = jnp.asarray(self.qinv_np)
        self.r2 = jnp.asarray(self.r2_np)

        t = p.ntt
        self._stage1 = tuple(_to_mont_np(s, qn[:, None]) for s in t.sub1.stage_tw)
        self._stage2 = tuple(_to_mont_np(s, qn[:, None]) for s in t.sub2.stage_tw)
        self._istage1 = tuple(_to_mont_np(s, qn[:, None]) for s in t.sub1.inv_stage_tw)
        self._istage2 = tuple(_to_mont_np(s, qn[:, None]) for s in t.sub2.inv_stage_tw)
        self._tw_mid = _to_mont_np(t.tw_mid, qn[:, None, None])
        self._tw_mid_inv = _to_mont_np(t.tw_mid_inv, qn[:, None, None])

        def _flat_shoup(stages, n):
            """Flat [K, n] stage table (stage s, block b at 2^s + b) and
            its Shoup quotients floor(w * 2^32 / q)."""
            w = np.zeros((K, n), dtype=np.uint64)
            for s, arr in enumerate(stages):
                w[:, (1 << s): (2 << s)] = arr
            sh = (w << np.uint64(32)) // qn[:, None].astype(np.uint64)
            return w.astype(np.uint32), sh.astype(np.uint32)

        self._psi = (_flat_shoup(t.sub1.stage_tw, t.n1)
                     + _flat_shoup(t.sub2.stage_tw, t.n2))
        self._ipsi = (_flat_shoup(t.sub1.inv_stage_tw, t.n1)
                      + _flat_shoup(t.sub2.inv_stage_tw, t.n2))

        sp_q = qn[p.max_level:]
        self._moddown_s1 = _to_mont_np(p.ks.moddown_step1, sp_q)
        self._moddown_s2 = _to_mont_np(p.ks.moddown_step2, qn[: p.max_level, None])
        self._pinv = _to_mont_np(p.ks.pinv_modq, qn[: p.max_level])
        self._rescale_qinv = _to_mont_np(p.rescale_qinv, qn[None, : p.max_level])

        self._nt_cache: Dict[Tuple[int, ...], NttBasis] = {}
        self._ks_cache: Dict[int, KeySwitchLevelTables] = {}
        self._perm_cache: Dict[int, jnp.ndarray] = {}
        self._rs_cache: Dict[int, jnp.ndarray] = {}

    # ---- basis row index helpers ----------------------------------------
    def main_rows(self, level: int) -> Tuple[int, ...]:
        return tuple(range(level))

    def special_rows(self) -> Tuple[int, ...]:
        p = self.params
        return tuple(range(p.max_level, p.num_primes))

    def ext_rows(self, level: int) -> Tuple[int, ...]:
        """Extended basis rows, SPECIALS FIRST: with this ordering the
        per-level evk row set is the contiguous prefix [0, alpha+level) of
        the specials-first key layout (upload_kskey_mont), so the inner
        product slices keys without gather/concat copies."""
        return self.special_rows() + self.main_rows(level)

    # ---- table slicing ---------------------------------------------------
    def ntt_basis(self, rows: Tuple[int, ...],
                  shard_axis: Optional[str] = None) -> NttBasis:
        key = (rows, shard_axis)
        if key in self._nt_cache:
            return self._nt_cache[key]
        r = np.array(rows, dtype=np.int64)
        # Only the tables the selected leaf reads become device arrays (a
        # pytree leaf that is never used would still be transferred on
        # every jitted call).
        if self.ntt_mode == MONTGOMERY:
            stage1 = tuple(jnp.asarray(s[r]) for s in self._stage1)
            stage2 = tuple(jnp.asarray(s[r]) for s in self._stage2)
            istage1 = tuple(jnp.asarray(s[r]) for s in self._istage1)
            istage2 = tuple(jnp.asarray(s[r]) for s in self._istage2)
            psi = ipsi = ()
        else:
            stage1 = stage2 = istage1 = istage2 = ()
            psi = tuple(jnp.asarray(a[r]) for a in self._psi)
            ipsi = tuple(jnp.asarray(a[r]) for a in self._ipsi)
        nb = NttBasis(
            q=jnp.asarray(self.q_np[r]),
            qinv=jnp.asarray(self.qinv_np[r]),
            r2=jnp.asarray(self.r2_np[r]),
            stage1=stage1,
            tw_mid=jnp.asarray(self._tw_mid[r]),
            stage2=stage2,
            istage1=istage1,
            tw_mid_inv=jnp.asarray(self._tw_mid_inv[r]),
            istage2=istage2,
            psi=psi,
            ipsi=ipsi,
            n1=self.params.ntt.n1, n2=self.params.ntt.n2,
            leaf=self.ntt_mode,
            shard_axis=shard_axis,
        )
        self._nt_cache[key] = nb
        return nb

    def keyswitch_tables(self, level: int,
                         shard_axis: Optional[str] = None
                         ) -> KeySwitchLevelTables:
        ck = (level, shard_axis)
        if ck in self._ks_cache:
            return self._ks_cache[ck]
        p = self.params
        qn = p.q_arr
        ext = self.ext_rows(level)
        piecewise = self.ntt_mode != MONTGOMERY
        empty = jnp.zeros((0,), dtype=jnp.uint32)
        empty8 = jnp.zeros((0,), dtype=jnp.bfloat16)
        from .ops.bconv_fused import build_bf16_tables

        def _pair(w_plain: np.ndarray, qrows: np.ndarray):
            w = w_plain.astype(np.uint64)
            qq = qrows.astype(np.uint64)
            return (
                jnp.asarray(w.astype(np.uint32)),
                jnp.asarray(((w << np.uint64(32)) // qq).astype(np.uint32)),
            )

        digits = []
        for d in range(p.beta(level)):
            lo, hi = p.digit_range(level, d)
            s1 = _to_mont_np(p.ks.modup_step1[(level, d)], qn[lo:hi])
            s1_pl, s1_sh = _pair(p.ks.modup_step1[(level, d)], qn[lo:hi])
            full_mat = p.ks.modup_step2[(level, d)]  # [K, nd+1] (last col =
            # [-Q_d]_{p_j}, the centering column)
            other_rows = tuple(j for j in ext if not (lo <= j < hi))
            if piecewise:
                # Other rows only: own rows pass through in eval domain
                # (the conversion reproduces their residues exactly — only
                # the t = j term survives mod q_j), so they skip both the
                # matmul and the iNTT->NTT round trip.
                orn = np.array(other_rows)
                mat_mont = empty
                bf16, hsh = build_bf16_tables(full_mat[orn], qn[orn])
                other_nt = self.ntt_basis(other_rows, shard_axis)
            else:
                orn = np.array(other_rows)
                mat_pl = full_mat[orn]
                q_col = qn[orn, None]
                mat_mont = jnp.asarray(_to_mont_np(mat_pl, q_col))
                bf16, hsh = empty8, empty
                other_nt = None
            digits.append(
                ModUpDigitTables(
                    step1_mont=jnp.asarray(s1),
                    step1_pl=s1_pl, step1_sh=s1_sh,
                    mat_other_mont=mat_mont,
                    mat_bf16=bf16,
                    horner_sh=hsh,
                    other_nt=other_nt,
                    lo=lo, hi=hi,
                )
            )
        md2_pl = p.ks.moddown_step2[:level]
        if piecewise:
            md2_mont = empty
            md_bf16, md_hsh = build_bf16_tables(md2_pl, qn[:level])
        else:
            md2_mont = jnp.asarray(self._moddown_s2[:level])
            md_bf16, md_hsh = empty8, empty
        sp_qn = qn[p.max_level:]
        md1_pl, md1_sh = _pair(p.ks.moddown_step1, sp_qn)
        pinv_pl, pinv_sh = _pair(p.ks.pinv_modq[:level], qn[:level])
        tail = None
        if piecewise and level >= 2:
            lm1 = level - 1
            q_last = int(qn[lm1])
            P = p.p_prod
            alpha = p.alpha
            p_modq = np.array([P % int(q) for q in qn[:level]], dtype=np.uint64)
            pq_inv = np.array(
                [pow((P * q_last) % int(qn[i]), -1, int(qn[i]))
                 for i in range(lm1)],
                dtype=np.uint64,
            )
            # [-P*q_last]_{q_i}: consumed by the w-row centering indicator
            # (w~ = w - q_last*[w >= ceil(q_last/2)] — without it the
            # rescale division floors and the r1*s cross term leaves a
            # key-dependent DC bias, see ops/rescale.rescale_poly).
            negpq = np.array(
                [(int(q) - (P * q_last) % int(q)) % int(q)
                 for q in qn[:lm1]], dtype=np.uint64)
            tail_mat = np.concatenate(
                [md2_pl[:lm1], p_modq[:lm1, None], negpq[:, None]], axis=1
            )  # [lm1, alpha+3]: [P/p_j]_{q_i} cols, [-P]_{q_i} (centering,
            # consumed by the explicit v_b row), [P]_{q_i} (the w row),
            # [-P*q_last]_{q_i} (the w centering indicator row)
            t_bf16, t_hsh = build_bf16_tables(tail_mat, qn[:lm1])
            # input "primes" for identity step1: specials, a placeholder
            # for the v_b count row (any prime > v works), q_last, and a
            # placeholder for the {0,1} indicator row.
            in_q = np.concatenate(
                [sp_qn, sp_qn[:1],
                 np.array([q_last, q_last], dtype=np.uint64)]
            )
            one_pl, one_sh = _pair(np.ones(alpha + 3, dtype=np.uint64), in_q)
            md2l_pl, md2l_sh = _pair(
                md2_pl[lm1], np.full(alpha + 1, q_last, dtype=np.uint64)
            )
            tp_pl, tp_sh = _pair(p_modq, qn[:level])
            tpq_pl, tpq_sh = _pair(pq_inv, qn[:lm1])
            tail = TailTables(
                bf16=t_bf16, horner_sh=t_hsh,
                in_q=jnp.asarray(in_q.astype(np.uint32)),
                one_pl=one_pl, one_sh=one_sh,
                p_pl=tp_pl, p_sh=tp_sh,
                pq_inv_pl=tpq_pl, pq_inv_sh=tpq_sh,
                md2_last_pl=md2l_pl, md2_last_sh=md2l_sh,
                last_nt=self.ntt_basis((lm1,), shard_axis),
                out_nt=self.ntt_basis(self.main_rows(lm1), shard_axis),
            )
        kt = KeySwitchLevelTables(
            digits=tuple(digits),
            main_nt=self.ntt_basis(self.main_rows(level), shard_axis),
            ext_nt=self.ntt_basis(ext, shard_axis),
            special_nt=self.ntt_basis(self.special_rows(), shard_axis),
            moddown_s1_mont=jnp.asarray(self._moddown_s1),
            moddown_s1_pl=md1_pl, moddown_s1_sh=md1_sh,
            moddown_s2_mont=md2_mont,
            moddown_bf16=md_bf16,
            moddown_horner_sh=md_hsh,
            pinv_mont=jnp.asarray(self._pinv[:level]),
            pinv_pl=pinv_pl, pinv_sh=pinv_sh,
            tail=tail,
            level=level,
        )
        self._ks_cache[ck] = kt
        return kt

    def rescale_qinv_mont(self, level: int):
        """(mont, plain, shoup) triple of [level-1] [q_{level-1}^{-1}]_{q_i}."""
        if level not in self._rs_cache:
            pl = self.params.rescale_qinv[level - 1, : level - 1].astype(np.uint64)
            qq = self.params.q_arr[: level - 1].astype(np.uint64)
            self._rs_cache[level] = (
                jnp.asarray(self._rescale_qinv[level - 1, : level - 1]),
                jnp.asarray(pl.astype(np.uint32)),
                jnp.asarray(((pl << np.uint64(32)) // qq).astype(np.uint32)),
            )
        return self._rs_cache[level]

    def q_level(self, level: int):
        """Cached device (q, qinv, r2) triples for the first `level` rows."""
        key = ("qlv", level)
        if key not in self._rs_cache:
            self._rs_cache[key] = (
                jnp.asarray(self.q_np[:level]),
                jnp.asarray(self.qinv_np[:level]),
                jnp.asarray(self.r2_np[:level]),
            )
        return self._rs_cache[key]

    def automorph_perm(self, g: int) -> jnp.ndarray:
        if g not in self._perm_cache:
            self._perm_cache[g] = jnp.asarray(self.params.automorph_eval_perm(g))
        return self._perm_cache[g]

    def automorph_shard_route(self, g: int, ns: int):
        """(local_src, perm_pairs, is_identity) shard-permutation route for
        sigma_g on an ns-way column-sharded eval tile
        (ops/automorph.build_shard_route); cached per (g, ns). The column
        map is block-aligned in our bit-reversed eval order, so the
        cross-device part is ONE whole-shard ppermute (or nothing when the
        block map is the identity); perm_pairs is the static pair tuple."""
        key = ("sroute", g, ns)
        if key not in self._perm_cache:
            from .ops.automorph import BlockAlignmentError, build_shard_route

            t = self.params.ntt
            try:
                src_dev, local_src, ident = build_shard_route(
                    self.params.automorph_eval_perm(g), t.n2, t.n1, ns
                )
                pairs = () if ident else tuple(
                    (int(src_dev[i]), i) for i in range(ns)
                )
                route = (jnp.asarray(local_src), pairs, ident)
            except BlockAlignmentError:
                # Gather-route sentinel (pairs=None): the dispatch layer
                # (sharded._hrotate_body) runs automorph_eval_sharded on
                # the full permutation instead of the ppermute route.
                route = (self.automorph_perm(g), None, False)
            self._perm_cache[key] = route
        return self._perm_cache[key]

    def automorph_stage_maps(self, g: int):
        """3-stage (sublane/lane/sublane gather) maps for sigma_g on the
        [n2, n1] eval tile (ops/perm_decomp.py); cached per Galois elt."""
        key = ("stage", g)
        if key not in self._perm_cache:
            from .ops.perm_decomp import decompose_grid_perm

            t = self.params.ntt
            s1, s2, s3 = decompose_grid_perm(
                self.params.automorph_eval_perm(g), t.n2, t.n1
            )
            self._perm_cache[key] = tuple(jnp.asarray(s) for s in (s1, s2, s3))
        return self._perm_cache[key]

    # ---- host <-> device conversion -------------------------------------
    def _eval_tiles(self, flat: np.ndarray) -> np.ndarray:
        """Host flat eval order [..., N] -> device eval tiles [..., n2, n1]."""
        t = self.params.ntt
        return flat.reshape(flat.shape[:-1] + (t.n2, t.n1))

    def upload_ct(self, data_u64: np.ndarray, level: int, scale: float) -> Ciphertext:
        return Ciphertext(
            jnp.asarray(self._eval_tiles(data_u64.astype(np.uint32))),
            level, scale, EVAL,
        )

    def upload_pt(self, data_u64: np.ndarray, level: int, scale: float) -> Plaintext:
        return Plaintext(
            jnp.asarray(self._eval_tiles(data_u64.astype(np.uint32))),
            level, scale, EVAL,
        )

    def upload_kskey_mont(self, digits: List[np.ndarray]):
        """Stack evk digits as ONE Montgomery-form array [dnum, 2, K, R, C].

        The key inner product is HBM-bandwidth-bound on evk reads (it
        streams the whole key once per key switch), so the key is stored as
        a single Montgomery array — half the bytes of a (plain, Shoup)
        pair; the extra REDC multiplies hide under the DMA."""
        p = self.params
        L = p.max_level
        stacked = np.stack(digits).astype(np.uint64)  # [dnum, 2, K, N]
        # Specials-first row layout (see ext_rows).
        stacked = np.concatenate([stacked[:, :, L:], stacked[:, :, :L]], axis=2)
        qn = np.concatenate([p.q_arr[L:], p.q_arr[:L]])[None, None, :, None].astype(np.uint64)
        mont = ((stacked << np.uint64(32)) % qn).astype(np.uint32)
        return jnp.asarray(self._eval_tiles(mont))

    def download(self, x: jnp.ndarray) -> np.ndarray:
        """Device tiles [..., R, C] -> host flat [..., N] uint64."""
        h = np.asarray(jax.device_get(x)).astype(np.uint64)
        return h.reshape(h.shape[:-2] + (h.shape[-2] * h.shape[-1],))
