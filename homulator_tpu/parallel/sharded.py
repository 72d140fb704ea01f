"""Sharded (multi-chip) operation graphs.

Two multi-chip execution paths, both bit-exact vs single chip
(tests/test_sharding.py):

1. **shard_map + explicit collectives** (`make_shardmap_hmult` /
   `make_shardmap_hrotate`):
   every device array keeps its TRAILING (coefficient) axis sharded over
   the mesh's 'coeff' axis — the sequence-parallel analog of how the
   reference splits each polynomial into N/batchSize batches across
   clusters (InsGen.cpp:12, Driver.h:193-246). Under this layout the
   entire hmult/hrotate graph is device-local — tensor product, the bf16
   base conversions (contraction over limbs), the key-switch inner
   product, ModDown, Rescale — EXCEPT:

     * the 4-step NTT inter-transpose: ONE `lax.all_to_all` per transform
       (the reference's interTrans stage, config_4.cfg:48,
       src/Components.cpp:411-419) — ops/ntt.py `_transpose_a2a`;
     * the Galois automorphism: ONE whole-shard ppermute + a local gather
       (AUTOU's cross-lane swap network, include/Components.h:201-238) —
       the column map is block-aligned in the bit-reversed eval order, so
       receive is one shard, (ns-1) x fewer bytes than an all_gather
       (ops/automorph.build_shard_route).

   The single-chip graph runs unmodified inside the shard_map on its
   local column slices (the NTT as phase-split halves around the
   all_to_all, ops/ntt.py `_fwd_phase*` / `_inv_phase*`). Limb counts never
   constrain the mesh: only n1 and n2 (powers of two, 256 each at N=2^16)
   must divide the 'coeff' axis size.

2. **GSPMD-partitioned jnp graph** (`make_sharded_hmult`): the
   scaling-book recipe — annotate input shardings over ('data', 'limb'
   [, 'coeff']) and let the SPMD partitioner insert collectives. Handles
   arbitrary (including non-divisible-limb) layouts; used by the CLI's
   [cluster] knob. Limb axis ≈ reference clusters (Driver.h:158).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..api import hmult_graph
from ..context import (
    DeviceContext, KeySwitchLevelTables, ModUpDigitTables, NttBasis,
    TailTables,
)
from ..ops.automorph import automorph_eval_sharded, automorph_eval_shardperm
from ..ops.keyswitch import keyswitch, keyswitch_pieces
from ..ops.modmath import modadd
from .mesh import bind_tables, place


# --------------------------------------------------------------------------
# PartitionSpec trees for the table pytrees (passed through shard_map so
# each device receives its column slice of the mid-twiddle tables; all
# other tables are replicated).
# --------------------------------------------------------------------------
def _ntt_basis_specs(nb: NttBasis, axis: str) -> NttBasis:
    mid = P(None, None, axis)

    def m(a):
        return mid if getattr(a, "ndim", 0) == 3 else P()

    return NttBasis(
        q=P(), qinv=P(), r2=P(),
        stage1=tuple(P() for _ in nb.stage1),
        tw_mid=m(nb.tw_mid),
        stage2=tuple(P() for _ in nb.stage2),
        istage1=tuple(P() for _ in nb.istage1),
        tw_mid_inv=m(nb.tw_mid_inv),
        istage2=tuple(P() for _ in nb.istage2),
        psi=tuple(P() for _ in nb.psi),
        ipsi=tuple(P() for _ in nb.ipsi),
        n1=nb.n1, n2=nb.n2, leaf=nb.leaf, shard_axis=nb.shard_axis,
    )


def _tail_specs(tt: TailTables, axis: str) -> TailTables:
    return TailTables(
        bf16=P(), horner_sh=P(), in_q=P(), one_pl=P(), one_sh=P(),
        p_pl=P(), p_sh=P(), pq_inv_pl=P(), pq_inv_sh=P(),
        md2_last_pl=P(), md2_last_sh=P(),
        last_nt=_ntt_basis_specs(tt.last_nt, axis),
        out_nt=_ntt_basis_specs(tt.out_nt, axis),
    )


def _keyswitch_specs(kt: KeySwitchLevelTables, axis: str) -> KeySwitchLevelTables:
    digits = tuple(
        ModUpDigitTables(
            step1_mont=P(), step1_pl=P(), step1_sh=P(),
            mat_other_mont=P(), mat_bf16=P(), horner_sh=P(),
            other_nt=(
                _ntt_basis_specs(dt.other_nt, axis)
                if dt.other_nt is not None else None
            ),
            lo=dt.lo, hi=dt.hi,
        )
        for dt in kt.digits
    )
    return KeySwitchLevelTables(
        digits=digits,
        main_nt=_ntt_basis_specs(kt.main_nt, axis),
        ext_nt=_ntt_basis_specs(kt.ext_nt, axis),
        special_nt=_ntt_basis_specs(kt.special_nt, axis),
        moddown_s1_mont=P(), moddown_s1_pl=P(), moddown_s1_sh=P(),
        moddown_s2_mont=P(), moddown_bf16=P(), moddown_horner_sh=P(),
        pinv_mont=P(), pinv_pl=P(), pinv_sh=P(),
        tail=_tail_specs(kt.tail, axis) if kt.tail is not None else None,
        level=kt.level,
    )


# --------------------------------------------------------------------------
# shard_map path (explicit collectives)
# --------------------------------------------------------------------------
def make_shardmap_hmult(
    dc: DeviceContext, level: int, mesh: Mesh, *,
    axis: str = "coeff", data_axis: Optional[str] = None,
):
    """jitted hmult over `mesh` with the coefficient (trailing) axis of
    every array sharded over mesh axis `axis`, running the SINGLE-CHIP
    graph per shard and explicit all_to_all NTT transposes.

    Without data_axis: f(a, b, evk) over [2, level, R, C] ciphertexts.
    With data_axis: f(a_batch, b_batch, evk) over [B, 2, level, R, C]
    (batch data-parallel over `data_axis`, vmapped inside the shard_map).
    Requires axis_size(axis) to divide n1 and n2.
    """
    ns = mesh.shape[axis]
    t = dc.params.ntt
    assert t.n1 % ns == 0 and t.n2 % ns == 0, (t.n1, t.n2, ns)
    kt = dc.keyswitch_tables(level, shard_axis=axis)
    last_nt = dc.ntt_basis((level - 1,), shard_axis=axis)
    out_nt = dc.ntt_basis(dc.main_rows(level - 1), shard_axis=axis)
    rs = dc.rescale_qinv_mont(level)

    kt_sp = _keyswitch_specs(kt, axis)
    lnt_sp = _ntt_basis_specs(last_nt, axis)
    ont_sp = _ntt_basis_specs(out_nt, axis)
    rs_sp = (P(), P(), P())
    evk_sp = P(None, None, None, None, axis)

    if data_axis is None:
        ct_sp = P(None, None, None, axis)
        body = hmult_graph
    else:
        ct_sp = P(data_axis, None, None, None, axis)

        def body(a, b, evk, kt, lnt, ont, rs):
            return jax.vmap(
                lambda x, y: hmult_graph(x, y, evk, kt, lnt, ont, rs)
            )(a, b)

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(ct_sp, ct_sp, evk_sp, kt_sp, lnt_sp, ont_sp, rs_sp),
        out_specs=ct_sp,
        check_vma=False,
    )
    tables = place((kt, last_nt, out_nt, rs), (kt_sp, lnt_sp, ont_sp, rs_sp),
                   mesh)
    return bind_tables(f, *tables)


def _hrotate_body(a, local_src, rotk, kt, axis, perm_pairs):
    """AUTO (whole-shard ppermute + local gather — the column map is
    block-aligned in the bit-reversed eval order, so receive is ONE local
    shard instead of all_gather's ns-1; ops/automorph.build_shard_route)
    -> KeySwitch (local graph, all_to_all NTT transposes) -> add.
    Mirrors _hrotate_graph (api.py) / the reference's HROTATE
    (src/Operation.cpp:1271-1451). perm_pairs=None is the gather-route
    sentinel (non-block-aligned Galois element, ops/automorph.
    BlockAlignmentError): local_src is then the FULL flat permutation and
    the automorphism falls back to all_gather + local permute + re-slice."""
    q = kt.main_nt.q[:, None, None]
    if perm_pairs is None:
        r0 = automorph_eval_sharded(a[0], local_src, axis)
        r1 = automorph_eval_sharded(a[1], local_src, axis)
    else:
        r0 = automorph_eval_shardperm(a[0], local_src, perm_pairs, axis)
        r1 = automorph_eval_shardperm(a[1], local_src, perm_pairs, axis)
    if kt.main_nt.piecewise:
        e0, e1 = keyswitch_pieces(r1, rotk, kt)
    else:
        e0, e1 = keyswitch(r1, rotk, kt)
    return jnp.stack([modadd(r0, e0, q), e1])


def make_shardmap_hrotate(
    dc: DeviceContext, level: int, mesh: Mesh, *, axis: str = "coeff",
):
    """Returns f(a, route, rotk) -> rotated ciphertext data, coefficient
    axis sharded over `axis` (see make_shardmap_hmult). `route` is
    dc.automorph_shard_route(galois_elt(step), ns); the ppermute pairs are
    static, so one program is compiled per distinct BLOCK permutation (a
    small set — the block maps induced by affine Galois actions), cached
    here, and reused across steps that share it."""
    ns = mesh.shape[axis]
    t = dc.params.ntt
    assert t.n1 % ns == 0 and t.n2 % ns == 0, (t.n1, t.n2, ns)
    kt = dc.keyswitch_tables(level, shard_axis=axis)
    kt_sp = _keyswitch_specs(kt, axis)
    kt = place(kt, kt_sp, mesh)
    ct_sp = P(None, None, None, axis)
    evk_sp = P(None, None, None, None, axis)

    @functools.lru_cache(maxsize=None)
    def compiled(perm_pairs):
        # pairs=None: gather-route fallback — local_src is the full flat
        # permutation (replicated), not a per-device table.
        lsrc_sp = P() if perm_pairs is None else P(axis, None)
        f = jax.shard_map(
            functools.partial(_hrotate_body, axis=axis,
                              perm_pairs=perm_pairs),
            mesh=mesh,
            in_specs=(ct_sp, lsrc_sp, evk_sp, kt_sp),
            out_specs=ct_sp,
            check_vma=False,
        )
        return jax.jit(f)

    def run(a, route, rotk):
        local_src, pairs, _ = route
        return compiled(pairs)(a, local_src, rotk, kt)

    def lower(a, route, rotk):
        local_src, pairs, _ = route
        return compiled(pairs).lower(a, local_src, rotk, kt)

    run.lower = lower
    return run


def transform_calls(params, level: int, op: str):
    """Row counts of every ntt/intt CALL of one coeff-path op, in program
    order: ModUp iNTT, per-digit NTTs (other rows only), then the tails
    (hmult: per key iNTT(specials) + iNTT(zl) + NTT(out); hrotate:
    per key iNTT(specials) + NTT(main))."""
    alpha = params.alpha
    beta = params.beta(level)
    calls = [level]
    calls += [
        (alpha + level) - (hi - lo)
        for lo, hi in (params.digit_range(level, d) for d in range(beta))
    ]
    if op == "hmult":
        calls += [alpha, 1, level - 1] * 2
    elif op == "hrotate":
        calls += [alpha, level] * 2
    else:
        raise ValueError(op)
    return calls


def ici_bytes_per_op(params, level: int, ns: int, op: str = "hmult", *,
                     route_identity: bool = False) -> int:
    """EXACT per-device receive volume (bytes) of one shard_map op at
    `level` over an ns-way 'coeff' axis — counted from the collective
    schedule of the graph, the analog of the reference's NoC_Mem_Chip
    counter (src/mem.cpp:95). Reconciled against the collectives in the
    lowered HLO by tests/test_sharding.py (ici_bytes_from_lowered).

    Each limb-transform's inter-transpose all_to_all exchanges a device's
    1/ns shard: the device keeps 1/ns of its local N/ns elements and
    receives the rest — (ns-1)/ns * (N/ns) * 4 bytes. Each automorphism is
    ONE whole-shard ppermute (ops/automorph.build_shard_route): receive =
    the local [level, n2, n1/ns] shard = level * N/ns * 4 — (ns-1) x less
    than an all_gather form. This counts the non-identity worst case by
    default; Galois elements whose induced block map is the identity emit
    NO collective at all — pass route_identity=True (from the route's
    is_identity flag, dc.automorph_shard_route) to bill those correctly.
    """
    n = params.n
    transforms = sum(transform_calls(params, level, op))
    autos = 0
    if op == "hrotate" and not route_identity:
        # 2 automorph ppermutes (zero when the requested element's block
        # map is the identity)
        autos = 2
    per_tf = (ns - 1) * n * 4 // (ns * ns)
    per_auto = level * n * 4 // ns
    return transforms * per_tf + autos * per_auto


def ici_bytes_from_lowered(hlo_text: str, ns: int) -> int:
    """Per-device receive bytes counted from the collectives of a
    LOWERED shard_map program (jit(f).lower(...).as_text()). The shapes
    inside the manual computation are per-device local shards, so:

      all_to_all:         receives (ns-1)/ns of the local operand
      all_gather:         receives (ns-1) x the local operand
      collective_permute: receives the local operand (whole-shard route)

    Used to pin ici_bytes_per_op against the real collective schedule —
    drift in the graph breaks the reconciliation test instead of silently
    invalidating the published volumes.
    """
    import re

    pat = re.compile(
        r'stablehlo\.(all_to_all|all_gather|collective_permute)"?.*?:'
        r"\s*\(tensor<([^>]+)>\)")
    total = 0
    for m in pat.finditer(hlo_text):
        kind, shape = m.group(1), m.group(2)
        dims = shape.split("x")
        elems = 1
        for d in dims[:-1]:
            elems *= int(d)
        nbytes = elems * 4  # ui32
        if kind == "all_to_all":
            total += nbytes * (ns - 1) // ns
        elif kind == "all_gather":
            total += nbytes * (ns - 1)
        else:
            total += nbytes
    return total


# --------------------------------------------------------------------------
# GSPMD path (jnp graph, partitioner-inserted collectives)
# --------------------------------------------------------------------------
def batched_hmult_fn(dc: DeviceContext, level: int):
    """Returns f(a_batch, b_batch, evk) -> out_batch for [B, 2, level, N]."""
    kt = dc.keyswitch_tables(level)
    last_nt = dc.ntt_basis((level - 1,))
    out_nt = dc.ntt_basis(dc.main_rows(level - 1))
    rs = dc.rescale_qinv_mont(level)

    def f(a_batch, b_batch, evk):
        def one(a, b):
            return hmult_graph(a, b, evk, kt, last_nt, out_nt, rs)

        return jax.vmap(one)(a_batch, b_batch)

    return f


def make_sharded_hmult(dc: DeviceContext, level: int, mesh: Mesh):
    """jit-compiled batched hmult. Input shardings: ciphertext batch over
    'data', RNS limbs over 'limb', and — when the mesh has a 'coeff' axis —
    the trailing coefficient-tile axis over 'coeff' (the sequence-parallel
    analog: GSPMD lowers the 4-step NTT's [R, C] transpose under that
    sharding to the cross-device all-to-all the reference models as its
    interTrans stage, config_4.cfg:48)."""
    f = batched_hmult_fn(dc, level)
    co = "coeff" if "coeff" in mesh.axis_names else None
    ct_shard = NamedSharding(mesh, P("data", None, "limb", None, co))
    evk_shard = NamedSharding(mesh, P(None, None, "limb", None, co))
    # Output sharding is left to the partitioner: the rescaled level-1 limb
    # count need not divide the 'limb' axis.
    return jax.jit(f, in_shardings=(ct_shard, ct_shard, evk_shard))
