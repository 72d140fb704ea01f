"""Multi-chip sharding tests on the 8-virtual-device CPU mesh
(the reference's multi-cluster-without-a-cluster testing mode, SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from homulator_tpu.api import CkksEngine, _hrotate_graph, hmult_graph
from homulator_tpu.params import get_params
from homulator_tpu.parallel.mesh import make_mesh
from homulator_tpu.parallel.sharded import (
    make_sharded_hmult, make_shardmap_hmult, make_shardmap_hrotate,
)

SCALE = 2.0**29


@pytest.fixture(scope="module")
def shard_engine():
    params = get_params(n=256, max_level=8, alpha=4)
    eng = CkksEngine(params, seed=5, ntt_mode="montgomery")
    eng.keygen()
    return eng


@pytest.fixture(scope="module")
def piecewise_engine():
    """XLA-leaf engine: the shard_map paths run the piecewise pipeline,
    the same graph the GPU runs, on the CPU mesh."""
    params = get_params(n=256, max_level=8, alpha=4)
    eng = CkksEngine(params, seed=5, ntt_mode="xla")
    eng.keygen()
    return eng


def _hmult_ref(eng, a, b, level):
    dc = eng.dc
    kt = dc.keyswitch_tables(level)
    return np.asarray(
        hmult_graph(
            a, b, eng.relin_key, kt, dc.ntt_basis((level - 1,)),
            dc.ntt_basis(dc.main_rows(level - 1)), dc.rescale_qinv_mont(level),
        )
    )


def _batch(eng, level, B, seed):
    rng = np.random.default_rng(seed)
    p = eng.params
    cts = []
    for _ in range(B):
        m = np.zeros(p.n, dtype=np.int64)
        m[0] = int(rng.normal() * SCALE)
        cts.append(eng.encrypt_ints(m, level, SCALE))
    return jnp.stack([c.data for c in cts])


@pytest.mark.parametrize("shape", [(1, 4), (2, 4), (4, 2), (8, 1)])
def test_sharded_hmult_matches_single_chip(shard_engine, shape):
    eng = shard_engine
    level = 8
    n_dev = shape[0] * shape[1]
    if n_dev > len(jax.devices()):
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(shape=shape, n_devices=n_dev)
    B = max(2, shape[0])
    a_batch = _batch(eng, level, B, seed=1)
    b_batch = _batch(eng, level, B, seed=2)

    ct_shard = NamedSharding(mesh, P("data", None, "limb", None, None))
    evk_shard = NamedSharding(mesh, P(None, None, "limb", None, None))
    a_s = jax.device_put(a_batch, ct_shard)
    b_s = jax.device_put(b_batch, ct_shard)
    evk_s = jax.device_put(eng.relin_key, evk_shard)

    f = make_sharded_hmult(eng.dc, level, mesh)
    out = np.asarray(f(a_s, b_s, evk_s))

    dc = eng.dc
    kt = dc.keyswitch_tables(level)
    last_nt = dc.ntt_basis((level - 1,))
    out_nt = dc.ntt_basis(dc.main_rows(level - 1))
    rs = dc.rescale_qinv_mont(level)
    for i in range(B):
        ref = np.asarray(
            hmult_graph(a_batch[i], b_batch[i], eng.relin_key, kt, last_nt, out_nt, rs)
        )
        assert np.array_equal(out[i], ref), f"batch {i} mismatch at mesh {shape}"


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 4)])
def test_coeff_sharded_hmult_matches_single_chip(shard_engine, shape):
    """Full hmult with the coefficient-tile axis sharded ('coeff' mesh
    axis, the sequence-parallel analog) == single-chip, bit-exact."""
    eng = shard_engine
    level = 8
    n_dev = shape[0] * shape[1] * shape[2]
    if n_dev > len(jax.devices()):
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(shape=shape, n_devices=n_dev)
    B = 2
    a_batch = _batch(eng, level, B, seed=3)
    b_batch = _batch(eng, level, B, seed=4)

    ct_shard = NamedSharding(mesh, P("data", None, "limb", None, "coeff"))
    evk_shard = NamedSharding(mesh, P(None, None, "limb", None, "coeff"))
    a_s = jax.device_put(a_batch, ct_shard)
    b_s = jax.device_put(b_batch, ct_shard)
    evk_s = jax.device_put(eng.relin_key, evk_shard)

    f = make_sharded_hmult(eng.dc, level, mesh)
    out = np.asarray(f(a_s, b_s, evk_s))

    dc = eng.dc
    kt = dc.keyswitch_tables(level)
    last_nt = dc.ntt_basis((level - 1,))
    out_nt = dc.ntt_basis(dc.main_rows(level - 1))
    rs = dc.rescale_qinv_mont(level)
    for i in range(B):
        ref = np.asarray(
            hmult_graph(a_batch[i], b_batch[i], eng.relin_key, kt, last_nt, out_nt, rs)
        )
        assert np.array_equal(out[i], ref), f"batch {i} mismatch at mesh {shape}"


@pytest.mark.parametrize("coeff", [2, 4, 8])
def test_shardmap_hmult_pallas_matches_single_chip(piecewise_engine, coeff):
    """shard_map over the 'coeff' axis running the single-chip piecewise
    graph per shard with explicit all_to_all NTT inter-transposes —
    bit-exact vs single chip."""
    eng = piecewise_engine
    level = 8
    if coeff > len(jax.devices()):
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(shape=(1, coeff), n_devices=coeff,
                     axis_names=("data", "coeff"))
    a = _batch(eng, level, 1, seed=11)[0]
    b = _batch(eng, level, 1, seed=12)[0]
    f = make_shardmap_hmult(eng.dc, level, mesh)
    out = np.asarray(f(a, b, eng.relin_key))
    assert np.array_equal(out, _hmult_ref(eng, a, b, level))


def test_hrotate_hoisted_pallas_path(piecewise_engine):
    """Hoisted rotations on the piecewise pipeline — covers the rep-2
    moddown_pair2 tail routing in _hrotate_hoisted_graph — must be
    bit-identical to per-step hrotate."""
    eng = piecewise_engine
    level = 8
    ct = _batch(eng, level, 1, seed=31)[0]
    from homulator_tpu.context import Ciphertext

    c = Ciphertext(ct, level, SCALE)
    steps = [1, 3]
    outs = eng.hrotate_hoisted(c, steps)
    for s, got in zip(steps, outs):
        want = eng.hrotate(c, s)
        assert np.array_equal(np.asarray(got.data), np.asarray(want.data)), s
    # k >= 4 routes through the lax.scan hoisted graph (constant program
    # size) — must stay bit-identical too.
    steps = [1, 2, 3, 5]
    outs = eng.hrotate_hoisted(c, steps)
    for s, got in zip(steps, outs):
        want = eng.hrotate(c, s)
        assert np.array_equal(np.asarray(got.data), np.asarray(want.data)), s


def test_vmap_hmult_single_chip_batched(piecewise_engine):
    """Single-chip serving shape (scripts/bench_batched.py): jax.vmap over
    the full hmult graph must be bit-exact vs per-example execution."""
    eng = piecewise_engine
    level = 8
    B = 3
    ab = _batch(eng, level, B, seed=21)
    bb = _batch(eng, level, B, seed=22)
    dc = eng.dc
    kt = dc.keyswitch_tables(level)
    last_nt = dc.ntt_basis((level - 1,))
    out_nt = dc.ntt_basis(dc.main_rows(level - 1))
    rs = dc.rescale_qinv_mont(level)
    f = jax.vmap(
        lambda x, y: hmult_graph(x, y, eng.relin_key, kt, last_nt, out_nt, rs)
    )
    out = np.asarray(jax.jit(f)(ab, bb))
    for i in range(B):
        assert np.array_equal(out[i], _hmult_ref(eng, ab[i], bb[i], level)), i


def test_shardmap_hmult_data_parallel_batched(piecewise_engine):
    """data x coeff mesh: batch vmapped inside the shard_map, coefficient
    axis sharded — both axes exercised together."""
    eng = piecewise_engine
    level = 8
    mesh = make_mesh(shape=(2, 4), n_devices=8, axis_names=("data", "coeff"))
    B = 4
    ab = _batch(eng, level, B, seed=13)
    bb = _batch(eng, level, B, seed=14)
    f = make_shardmap_hmult(eng.dc, level, mesh, data_axis="data")
    out = np.asarray(f(ab, bb, eng.relin_key))
    for i in range(B):
        assert np.array_equal(out[i], _hmult_ref(eng, ab[i], bb[i], level)), i


def test_shardmap_hmult_jnp_path(shard_engine):
    """The shard_map orchestration also runs the Montgomery table path —
    same collectives."""
    eng = shard_engine
    level = 8
    mesh = make_mesh(shape=(1, 8), n_devices=8, axis_names=("data", "coeff"))
    a = _batch(eng, level, 1, seed=15)[0]
    b = _batch(eng, level, 1, seed=16)[0]
    f = make_shardmap_hmult(eng.dc, level, mesh)
    out = np.asarray(f(a, b, eng.relin_key))
    assert np.array_equal(out, _hmult_ref(eng, a, b, level))


def test_shardmap_hrotate_pallas_matches_single_chip(piecewise_engine):
    """hrotate on the shard_map path: a2a-routed automorphism + sharded
    key switch, bit-exact vs the single-chip graph."""
    eng = piecewise_engine
    level = 8
    step = 3
    eng.gen_rotation_key(step)
    mesh = make_mesh(shape=(1, 4), n_devices=4, axis_names=("data", "coeff"))
    a = _batch(eng, level, 1, seed=17)[0]
    g = eng.params.galois_elt(step)
    perm = eng.dc.automorph_perm(g)
    route = eng.dc.automorph_shard_route(g, 4)
    f = make_shardmap_hrotate(eng.dc, level, mesh)
    out = np.asarray(f(a, route, eng.rot_keys[step]))
    ref = np.asarray(
        _hrotate_graph(a, perm, eng.rot_keys[step],
                       eng.dc.keyswitch_tables(level))
    )
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("ns", [2, 4, 8])
@pytest.mark.parametrize("step", [1, 3, 17])
def test_automorph_shardperm_route_equals_gather_form(ns, step):
    """The whole-shard ppermute automorphism route == the all_gather form
    == the single-chip gather, element-exact, for several Galois elements
    and mesh sizes (incl. conjugation)."""
    import functools

    from homulator_tpu.ops.automorph import (
        automorph_eval, automorph_eval_shardperm, automorph_eval_sharded,
    )

    params = get_params(n=256, max_level=8, alpha=4)
    eng = CkksEngine(params, seed=9, ntt_mode="montgomery")
    t = params.ntt
    gs = [params.galois_elt(step), params.galois_conj]
    for g in gs:
        perm = eng.dc.automorph_perm(g)
        local_src, pairs, _ = eng.dc.automorph_shard_route(g, ns)
        mesh = make_mesh(shape=(ns,), n_devices=ns, axis_names=("c",))
        rng = np.random.default_rng(int(g))
        x = jnp.asarray(rng.integers(
            0, 2**30, size=(3, t.n2, t.n1), dtype=np.uint64
        ).astype(np.uint32))
        f_route = jax.jit(jax.shard_map(
            functools.partial(
                automorph_eval_shardperm, perm_pairs=pairs, axis="c"),
            mesh=mesh,
            in_specs=(P(None, None, "c"), P("c", None)),
            out_specs=P(None, None, "c"), check_vma=False,
        ))
        f_gather = jax.jit(jax.shard_map(
            lambda v: automorph_eval_sharded(v, perm, "c"), mesh=mesh,
            in_specs=(P(None, None, "c"),),
            out_specs=P(None, None, "c"), check_vma=False,
        ))
        want = np.asarray(automorph_eval(x, perm))
        assert np.array_equal(np.asarray(f_route(x, local_src)), want), (g, ns)
        assert np.array_equal(np.asarray(f_gather(x)), want), (g, ns)


def test_graft_entry_dryrun():
    import sys

    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(8)


def test_coeff_sharded_ntt_matches_single_chip():
    """4-step NTT with the coefficient axis sharded over 8 devices
    (inter-transpose as a cross-device reshard) == unsharded, bit-exact."""
    from homulator_tpu.parallel.coeff_ntt import make_coeff_sharded_ntt
    from homulator_tpu.ops.ntt import ntt as ntt_graph, intt as intt_graph

    params = get_params(n=1024, max_level=4, alpha=2)
    eng = CkksEngine(params, seed=6, ntt_mode="montgomery")
    nb = eng.dc.ntt_basis(eng.dc.main_rows(4))
    n1, n2 = nb.n1, nb.n2
    mesh = make_mesh(shape=(1, 8), n_devices=8)
    ntt_fn, intt_fn = make_coeff_sharded_ntt(nb, mesh, axis="limb")

    rng = np.random.default_rng(3)
    x = np.stack(
        [rng.integers(0, int(q), size=params.n, dtype=np.uint64)
         for q in params.q_arr[:4]]
    ).astype(np.uint32)
    tile = jnp.asarray(x.reshape(4, n1, n2))
    sharded = np.asarray(ntt_fn(tile))
    expected = np.asarray(ntt_graph(jnp.asarray(x.reshape(4, n1, n2)), nb))
    assert np.array_equal(sharded, expected)
    back = np.asarray(intt_fn(jnp.asarray(sharded)))
    assert np.array_equal(back, x.reshape(4, n1, n2))


@pytest.mark.parametrize("op", ["hmult", "hrotate"])
def test_ici_bytes_reconcile_with_hlo(piecewise_engine, op):
    """ici_bytes_per_op == bytes counted over the all_to_all/all_gather
    collectives of the LOWERED shard_map program — drift in the collective
    schedule breaks this instead of silently invalidating published
    volumes (the analog of the reference's NoC_Mem_Chip counter,
    src/mem.cpp:95)."""
    from homulator_tpu.parallel.sharded import (
        ici_bytes_from_lowered, ici_bytes_per_op,
    )

    eng = piecewise_engine
    level = 8
    ns = 4
    mesh = make_mesh(shape=(1, ns), n_devices=ns, axis_names=("data", "coeff"))
    a = _batch(eng, level, 1, seed=21)[0]
    if op == "hmult":
        f = make_shardmap_hmult(eng.dc, level, mesh)
        lowered = jax.jit(f).lower(a, a, eng.relin_key)
    else:
        eng.gen_rotation_key(1)
        route = eng.dc.automorph_shard_route(eng.params.galois_elt(1), ns)
        # the analytic formula counts the non-identity ppermute worst case
        assert route[1], "test step must induce a non-identity block map"
        f = make_shardmap_hrotate(eng.dc, level, mesh)
        lowered = f.lower(a, route, eng.rot_keys[1])
    measured = ici_bytes_from_lowered(lowered.as_text(), ns)
    analytic = ici_bytes_per_op(eng.params, level, ns, op)
    assert measured == analytic, (op, measured, analytic)


# ---------------------------------------------------------------------------
# Limb-axis dispatch (parallel/limb_sharded.py — the reference's primary
# dispatch, Driver.h:155-191: transforms whole per device, rows distributed)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ns,level", [
    (2, 8), (4, 8), (8, 8), (4, 7), (8, 5),
    (4, 4),  # beta = 1 (level == alpha: single digit, no pad)
    (4, 3),  # beta = 1, partial digit AND padded rows
])
def test_limb_hmult_matches_single_chip(piecewise_engine, ns, level):
    """Row-sharded hmult == single-chip on real rows, zeros on pad rows —
    including non-divisible levels (7, 5: padded blocks)."""
    from homulator_tpu.parallel.limb_sharded import (
        evk_limb_row_order, make_limb_hmult, pad_main_rows,
    )

    eng = piecewise_engine
    if ns > len(jax.devices()):
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(shape=(ns,), n_devices=ns, axis_names=("limb",))
    a = _batch(eng, level, 1, seed=41)[0]
    b = _batch(eng, level, 1, seed=42)[0]
    order = evk_limb_row_order(eng.params, level, ns)
    evk_l = jnp.take(eng.relin_key, jnp.asarray(order), axis=2)
    f = make_limb_hmult(eng.dc, level, mesh)
    out = np.asarray(f(pad_main_rows(a, level, ns),
                       pad_main_rows(b, level, ns), evk_l))
    ref = _hmult_ref(eng, a, b, level)
    assert np.array_equal(out[:, : level - 1], ref), (ns, level)
    assert not out[:, level - 1:].any(), "pad rows must be zeroed"


@pytest.mark.parametrize("ns,level", [(2, 8), (4, 8), (8, 8), (4, 6)])
def test_limb_hrotate_matches_single_chip(piecewise_engine, ns, level):
    """Row-sharded hrotate == single-chip; the automorphism is row-local
    (no collective on this axis — why the reference dispatches AUTO by
    limb)."""
    from homulator_tpu.parallel.limb_sharded import (
        evk_limb_row_order, make_limb_hrotate, pad_main_rows,
    )

    eng = piecewise_engine
    if ns > len(jax.devices()):
        pytest.skip("needs 8 virtual devices")
    step = 3
    eng.gen_rotation_key(step)
    mesh = make_mesh(shape=(ns,), n_devices=ns, axis_names=("limb",))
    a = _batch(eng, level, 1, seed=43)[0]
    perm = eng.dc.automorph_perm(eng.params.galois_elt(step))
    order = evk_limb_row_order(eng.params, level, ns)
    rotk_l = jnp.take(eng.rot_keys[step], jnp.asarray(order), axis=2)
    f = make_limb_hrotate(eng.dc, level, mesh)
    out = np.asarray(f(pad_main_rows(a, level, ns), perm, rotk_l))
    ref = np.asarray(_hrotate_graph(a, perm, eng.rot_keys[step],
                                    eng.dc.keyswitch_tables(level)))
    assert np.array_equal(out[:, :level], ref), (ns, level)
    assert not out[:, level:].any(), "pad rows must be zeroed"


def test_limb_hmult_data_parallel_batched(piecewise_engine):
    """data x limb mesh: ciphertext batch vmapped inside the shard_map,
    RNS rows sharded — both axes exercised together (the reference's
    batch round-robin composed with its limb dispatch)."""
    from homulator_tpu.parallel.limb_sharded import (
        evk_limb_row_order, make_limb_hmult, pad_main_rows,
    )

    eng = piecewise_engine
    level = 8
    ns = 4
    mesh = make_mesh(shape=(2, ns), n_devices=8,
                     axis_names=("data", "limb"))
    B = 4
    ab = _batch(eng, level, B, seed=51)
    bb = _batch(eng, level, B, seed=52)
    order = evk_limb_row_order(eng.params, level, ns)
    evk_l = jnp.take(eng.relin_key, jnp.asarray(order), axis=2)
    f = make_limb_hmult(eng.dc, level, mesh, data_axis="data")
    out = np.asarray(f(pad_main_rows(ab, level, ns),
                       pad_main_rows(bb, level, ns), evk_l))
    for i in range(B):
        ref = _hmult_ref(eng, ab[i], bb[i], level)
        assert np.array_equal(out[i][:, : level - 1], ref), i


@pytest.mark.parametrize("op", ["hmult", "hrotate"])
def test_limb_ici_bytes_reconcile_with_hlo(piecewise_engine, op):
    """ici_bytes_per_op_limb == bytes counted over the all_gathers of the
    LOWERED limb-sharded program (same discipline as the coeff path)."""
    from homulator_tpu.parallel.limb_sharded import (
        evk_limb_row_order, ici_bytes_per_op_limb, make_limb_hmult,
        make_limb_hrotate, pad_main_rows,
    )
    from homulator_tpu.parallel.sharded import ici_bytes_from_lowered

    eng = piecewise_engine
    level = 8
    ns = 4
    mesh = make_mesh(shape=(ns,), n_devices=ns, axis_names=("limb",))
    a = _batch(eng, level, 1, seed=44)[0]
    a_p = pad_main_rows(a, level, ns)
    order = evk_limb_row_order(eng.params, level, ns)
    evk_l = jnp.take(eng.relin_key, jnp.asarray(order), axis=2)
    if op == "hmult":
        lowered = make_limb_hmult(eng.dc, level, mesh).lower(a_p, a_p, evk_l)
    else:
        eng.gen_rotation_key(1)
        perm = eng.dc.automorph_perm(eng.params.galois_elt(1))
        lowered = make_limb_hrotate(eng.dc, level, mesh).lower(a_p, perm, evk_l)
    measured = ici_bytes_from_lowered(lowered.as_text(), ns)
    analytic = ici_bytes_per_op_limb(eng.params, level, ns, op)
    assert measured == analytic, (op, measured, analytic)


def test_coeff_shard_ok_predicate():
    """One shardability predicate, shared by cli.py and
    __graft_entry__.dryrun_multichip."""
    from homulator_tpu.parallel.mesh import coeff_shard_ok

    # N=2^16: n1 = n2 = 256 -> ok through ns=32 (tile 8), not 64
    assert coeff_shard_ok(256, 256, 8)
    assert coeff_shard_ok(256, 256, 32)
    assert not coeff_shard_ok(256, 256, 64)
    # non-dividing mesh
    assert not coeff_shard_ok(256, 256, 3)
    # N=256 toy params: 16x16 tiles, 8-row shards only to ns=2
    assert coeff_shard_ok(16, 16, 2)
    assert not coeff_shard_ok(16, 16, 4)
    # the toy dryrun relaxes the minimum
    assert coeff_shard_ok(16, 16, 4, min_tile=4)


def test_hrotate_gather_route_fallback(piecewise_engine):
    """A route with pairs=None (the BlockAlignmentError sentinel) must run the all_gather automorphism fallback inside
    make_shardmap_hrotate and stay bit-exact."""
    eng = piecewise_engine
    level = 8
    step = 3
    eng.gen_rotation_key(step)
    mesh = make_mesh(shape=(1, 4), n_devices=4, axis_names=("data", "coeff"))
    a = _batch(eng, level, 1, seed=23)[0]
    g = eng.params.galois_elt(step)
    perm = eng.dc.automorph_perm(g)
    route = (perm, None, False)  # forced gather-route sentinel
    f = make_shardmap_hrotate(eng.dc, level, mesh)
    out = np.asarray(f(a, route, eng.rot_keys[step]))
    ref = np.asarray(
        _hrotate_graph(a, perm, eng.rot_keys[step],
                       eng.dc.keyswitch_tables(level))
    )
    assert np.array_equal(out, ref)


def test_ici_bytes_route_identity_flag():
    """route_identity=True drops the 2 automorph ppermutes from the coeff
    hrotate bill (identity block maps emit no collective)."""
    from homulator_tpu.parallel.sharded import ici_bytes_per_op

    params = get_params(n=256, max_level=8, alpha=4)
    ns, level = 4, 8
    full = ici_bytes_per_op(params, level, ns, "hrotate")
    ident = ici_bytes_per_op(params, level, ns, "hrotate",
                             route_identity=True)
    assert full - ident == 2 * level * params.n * 4 // ns


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_hybrid_hmult_matches_single_chip(piecewise_engine, shape):
    """2-D limb x coeff hybrid mesh: rows over
    'limb', columns over 'coeff', transforms phase-split within the coeff
    subgroup — bit-exact vs the single-chip graph."""
    from homulator_tpu.parallel.limb_sharded import (
        evk_limb_row_order, make_hybrid_hmult, pad_main_rows,
    )

    eng = piecewise_engine
    level = 8
    ns_l, ns_c = shape
    mesh = make_mesh(shape=shape, n_devices=ns_l * ns_c,
                     axis_names=("limb", "coeff"))
    a = _batch(eng, level, 2, seed=51)
    order = evk_limb_row_order(eng.params, level, ns_l)
    evk_l = jnp.take(eng.relin_key, jnp.asarray(order), axis=2)
    f = make_hybrid_hmult(eng.dc, level, mesh)
    out = np.asarray(f(pad_main_rows(a[0], level, ns_l),
                       pad_main_rows(a[1], level, ns_l), evk_l))
    ref = _hmult_ref(eng, a[0], a[1], level)
    assert np.array_equal(out[:, : level - 1], ref)


def test_hybrid_hrotate_matches_single_chip(piecewise_engine):
    """Hybrid hrotate: limb-row-local + coeff-subgroup ppermute
    automorphism, bit-exact vs single chip."""
    from homulator_tpu.parallel.limb_sharded import (
        evk_limb_row_order, make_hybrid_hrotate, pad_main_rows,
    )

    eng = piecewise_engine
    level = 8
    step = 3
    ns_l, ns_c = 4, 2
    eng.gen_rotation_key(step)
    mesh = make_mesh(shape=(ns_l, ns_c), n_devices=8,
                     axis_names=("limb", "coeff"))
    a = _batch(eng, level, 1, seed=53)[0]
    g = eng.params.galois_elt(step)
    route = eng.dc.automorph_shard_route(g, ns_c)
    order = evk_limb_row_order(eng.params, level, ns_l)
    rotk_l = jnp.take(eng.rot_keys[step], jnp.asarray(order), axis=2)
    f = make_hybrid_hrotate(eng.dc, level, mesh)
    out = np.asarray(f(pad_main_rows(a, level, ns_l), route, rotk_l))
    perm = eng.dc.automorph_perm(g)
    ref = np.asarray(_hrotate_graph(
        a, perm, eng.rot_keys[step], eng.dc.keyswitch_tables(level)))
    assert np.array_equal(out[:, :level], ref)


@pytest.mark.parametrize("op", ["hmult", "hrotate"])
def test_hybrid_ici_bytes_reconcile_with_hlo(piecewise_engine, op):
    """ici_bytes_per_op_hybrid == bytes counted over the collectives of
    the LOWERED hybrid program (same discipline as both 1-D paths).
    Mixed-axis counting: gathers/a2a/ppermute each receive fractions of
    their LOCAL operands over their own mesh axis."""
    import re

    from homulator_tpu.parallel.limb_sharded import (
        evk_limb_row_order, ici_bytes_per_op_hybrid, make_hybrid_hmult,
        make_hybrid_hrotate, pad_main_rows,
    )

    eng = piecewise_engine
    level = 8
    ns_l, ns_c = 4, 2
    mesh = make_mesh(shape=(ns_l, ns_c), n_devices=8,
                     axis_names=("limb", "coeff"))
    a = _batch(eng, level, 1, seed=57)[0]
    a_p = pad_main_rows(a, level, ns_l)
    order = evk_limb_row_order(eng.params, level, ns_l)
    evk_l = jnp.take(eng.relin_key, jnp.asarray(order), axis=2)
    route_ident = False
    if op == "hmult":
        lowered = make_hybrid_hmult(eng.dc, level, mesh).lower(
            a_p, a_p, evk_l)
    else:
        eng.gen_rotation_key(3)
        route = eng.dc.automorph_shard_route(eng.params.galois_elt(3), ns_c)
        route_ident = route[2]
        lowered = make_hybrid_hrotate(eng.dc, level, mesh).lower(
            a_p, route, jnp.take(eng.rot_keys[3], jnp.asarray(order),
                                 axis=2))
    txt = lowered.as_text()
    pat = re.compile(
        r'stablehlo\.(all_to_all|all_gather|collective_permute)"?.*?:'
        r"\s*\(tensor<([^>]+)>\)")
    total = 0
    for m in pat.finditer(txt):
        kind, tshape = m.group(1), m.group(2)
        elems = 1
        for d in tshape.split("x")[:-1]:
            elems = elems * int(d)
        nbytes = elems * 4
        if kind == "all_to_all":
            total += nbytes * (ns_c - 1) // ns_c
        elif kind == "all_gather":
            total += nbytes * (ns_l - 1)
        else:
            total += nbytes
    analytic = ici_bytes_per_op_hybrid(eng.params, level, ns_l, ns_c, op,
                                       route_identity=route_ident)
    assert total == analytic, (op, total, analytic, route_ident)


def test_hybrid_hmult_data_parallel_batched(piecewise_engine):
    """3-D data x limb x coeff mesh: batch vmapped inside the hybrid
    shard_map."""
    from homulator_tpu.parallel.limb_sharded import (
        evk_limb_row_order, make_hybrid_hmult, pad_main_rows,
    )

    eng = piecewise_engine
    level = 8
    mesh = make_mesh(shape=(2, 2, 2), n_devices=8,
                     axis_names=("data", "limb", "coeff"))
    B = 2
    ab = _batch(eng, level, B, seed=71)
    bb = _batch(eng, level, B, seed=72)
    order = jnp.asarray(evk_limb_row_order(eng.params, level, 2))
    evk_l = jnp.take(eng.relin_key, order, axis=2)
    f = make_hybrid_hmult(eng.dc, level, mesh, data_axis="data")
    out = np.asarray(f(pad_main_rows(ab, level, 2),
                       pad_main_rows(bb, level, 2), evk_l))
    for i in range(B):
        ref = _hmult_ref(eng, ab[i], bb[i], level)
        assert np.array_equal(out[i][:, : level - 1], ref), i


def test_hybrid_hrotate_gather_route_fallback(piecewise_engine):
    """The pairs=None gather-route sentinel must also work inside the
    hybrid mesh (all_gather over the coeff subgroup) and stay bit-exact."""
    from homulator_tpu.parallel.limb_sharded import (
        evk_limb_row_order, make_hybrid_hrotate, pad_main_rows,
    )

    eng = piecewise_engine
    level = 8
    step = 3
    ns_l, ns_c = 4, 2
    eng.gen_rotation_key(step)
    mesh = make_mesh(shape=(ns_l, ns_c), n_devices=8,
                     axis_names=("limb", "coeff"))
    a = _batch(eng, level, 1, seed=81)[0]
    g = eng.params.galois_elt(step)
    perm = eng.dc.automorph_perm(g)
    route = (perm, None, False)  # forced gather-route sentinel
    order = jnp.asarray(evk_limb_row_order(eng.params, level, ns_l))
    rotk_l = jnp.take(eng.rot_keys[step], order, axis=2)
    f = make_hybrid_hrotate(eng.dc, level, mesh)
    out = np.asarray(f(pad_main_rows(a, level, ns_l), route, rotk_l))
    ref = np.asarray(_hrotate_graph(
        a, perm, eng.rot_keys[step], eng.dc.keyswitch_tables(level)))
    assert np.array_equal(out[:, :level], ref)


def test_limb_collective_count_matches_hlo(piecewise_engine):
    """limb_collective_count == number of all_gathers in the lowered
    limb-sharded programs (chunked gathers: 2 sites x G chunks)."""
    import re

    from homulator_tpu.parallel.limb_sharded import (
        evk_limb_row_order, limb_collective_count, make_limb_hmult,
        pad_main_rows,
    )

    eng = piecewise_engine
    params = eng.params
    level, ns = 8, 4
    mesh = make_mesh(shape=(ns,), n_devices=ns, axis_names=("limb",))
    a_p = pad_main_rows(_batch(eng, level, 1, seed=3)[0], level, ns)
    order = evk_limb_row_order(params, level, ns)
    evk_l = jnp.take(eng.relin_key, jnp.asarray(order), axis=2)
    lowered = make_limb_hmult(eng.dc, level, mesh).lower(a_p, a_p, evk_l)
    n_gathers = len(re.findall(r"stablehlo\.all_gather",
                               lowered.as_text()))
    assert n_gathers == limb_collective_count(params, level, ns, "hmult")
