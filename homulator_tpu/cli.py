"""CLI: `python -m homulator_tpu run <cfg> <op> <maxLevel> <level> <alpha>`.

Keeps the reference's benchmark contract (README.md:27-35:
`./Homulator.run <configfile> <operationName> <maxExecutionLevel>
<currentLevel> <alpha>`), but executes the operation for real on the
current JAX backend and reports wall-clock latency plus a counters table
(the simulator reports modeled cycles, Operation.cpp:1094-1110).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _setup_jax(platform: str | None, cluster: int | None = None):
    import os

    # The reference's [cluster] positional scales its simulated machine
    # (bench_micro24.cpp:23-25); here it sizes the device mesh. On the CPU
    # backend a cluster count > physical devices is provided by XLA's
    # virtual host devices — the flag must land before backend init.
    if cluster and cluster > 1 and platform == "cpu":
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={cluster}"
        )
    import jax

    from .runtime import enable_compile_cache

    if platform:
        jax.config.update("jax_platforms", platform)
    enable_compile_cache()
    return jax


def choose_axis(params, op: str, ns: int, level: int, *,
                coeff_ok: bool = True, route_identity: bool = False):
    """(axis, bytes_limb, bytes_coeff) for --dispatch auto: the explicit-
    collective axis with the smaller exact per-device receive volume
    (parallel/limb_sharded.ici_bytes_per_op_limb,
    parallel/sharded.ici_bytes_per_op; both reconciled with the lowered
    HLO by tests). Volume alone, no machine constants: which axis is
    faster on a given interconnect is a measurement, not a model."""
    from .parallel.limb_sharded import ici_bytes_per_op_limb
    from .parallel.sharded import ici_bytes_per_op

    b_limb = ici_bytes_per_op_limb(params, level, ns, op)
    b_coeff = (ici_bytes_per_op(params, level, ns, op,
                                route_identity=route_identity)
               if coeff_ok else None)
    axis = "coeff" if (b_coeff is not None and b_coeff < b_limb) else "limb"
    return axis, b_limb, b_coeff


def run_op(args) -> int:
    from .config import RunConfig

    jax = _setup_jax(args.platform, args.cluster)
    from .api import CkksEngine
    from .params import get_params
    from .stats import Statistic, op_modmul_count

    rc = RunConfig.from_cli(args.cfg, args.op, args.max_level, args.level,
                            args.alpha, args.cluster)
    n_mesh = rc.cluster if args.cluster is not None else 1
    cluster_on = bool(n_mesh and n_mesh > 1)
    if cluster_on and n_mesh > len(jax.devices()):
        raise SystemExit(
            f"cluster={n_mesh} > {len(jax.devices())} devices "
            "(use --platform cpu for virtual devices)"
        )
    print(f"# backend={jax.default_backend()} devices={len(jax.devices())}")
    print(f"# N={rc.n} op={rc.op} maxLevel={rc.max_level} level={rc.level} "
          f"alpha={rc.alpha}")

    stats = Statistic()
    params = get_params(rc.n, rc.max_level, rc.alpha, rc.scale_bits)
    # Mesh dispatch (the reference's cluster knob scales its real dispatch,
    # bench_micro24.cpp:23-25). Key-switch ops have explicit-collective
    # shard_map paths, picked per shape by exact per-device receive volume
    # (both formulas are HLO-reconciled by tests/test_sharding.py):
    #
    #   limb  — the reference's PRIMARY dispatch (limb % cluster,
    #           Driver.h:155-191): rows sharded, every NTT whole and
    #           device-local, 2-3 row-block all_gathers total
    #           (parallel/limb_sharded.py);
    #   coeff — the sequence-parallel analog: columns sharded, one
    #           all_to_all per transform call + whole-shard ppermute
    #           automorphisms (parallel/sharded.make_shardmap_*);
    #   hybrid — limb x coeff 2-D mesh (forced only).
    #
    # Non-keyswitch ops (and --dispatch gspmd) use the GSPMD-partitioned
    # XLA graph. Override with --dispatch {auto,limb,coeff,gspmd}.
    from .parallel.mesh import coeff_shard_ok

    t_n1, t_n2 = params.ntt.n1, params.ntt.n2
    ks_op = rc.op in ("hmult", "hrotate")
    # shared shardability predicate with __graft_entry__.dryrun_multichip
    # (parallel/mesh.coeff_shard_ok)
    coeff_ok = ks_op and coeff_shard_ok(t_n1, t_n2, n_mesh)
    if not cluster_on and args.dispatch in ("limb", "coeff", "hybrid"):
        raise SystemExit(
            f"--dispatch {args.dispatch} needs the [cluster] positional "
            "> 1 (the sharded paths are multi-device dispatches)")
    dispatch = None
    ici_limb = ici_coeff = None
    if cluster_on and ks_op and args.dispatch != "gspmd":
        # hrotate's coeff automorphism may be an identity route with no
        # collective for this Galois element — bill the actual schedule.
        # route_ident2 is the same flag at the hybrid's 2-way coeff
        # subgroup (coarser blocks: identity at ns implies identity at 2,
        # not conversely).
        route_ident = route_ident2 = False
        if rc.op == "hrotate":
            from .ops.automorph import (
                BlockAlignmentError, build_shard_route,
            )

            perm_g = params.automorph_eval_perm(params.galois_elt(1))
            for ns_r in {n_mesh if coeff_ok else 0, 2} - {0}:
                try:
                    _, _, ident = build_shard_route(
                        perm_g, t_n2, t_n1, ns_r)
                except BlockAlignmentError:
                    ident = False
                if ns_r == 2:
                    route_ident2 = ident
                if ns_r == n_mesh:
                    route_ident = ident
        dispatch, ici_limb, ici_coeff = choose_axis(
            params, rc.op, n_mesh, rc.level, coeff_ok=coeff_ok,
            route_identity=route_ident)
        hybrid_ok = (n_mesh >= 4 and n_mesh % 2 == 0
                     and ks_op and coeff_shard_ok(t_n1, t_n2, 2))
        if args.dispatch in ("limb", "coeff", "hybrid"):
            dispatch = args.dispatch
            if dispatch == "coeff" and not coeff_ok:
                raise SystemExit(
                    f"--dispatch coeff needs n1,n2 % {n_mesh} == 0 and "
                    f"per-shard tiles >= 8 (n1={t_n1}, n2={t_n2})")
            if dispatch == "hybrid" and not hybrid_ok:
                raise SystemExit(
                    "--dispatch hybrid needs an even cluster >= 4 and a "
                    "2-way-shardable coefficient tile")
    use_shardmap = dispatch in ("limb", "coeff", "hybrid")
    with stats.timer("setup/engine"):
        # GSPMD partitions plain XLA graphs, so it gets the XLA leaf; the
        # shard_map paths and single-device runs take the default leaf.
        mode = "xla" if cluster_on and not use_shardmap else "auto"
        eng = CkksEngine(params, seed=args.seed, ntt_mode=mode)
    with stats.timer("setup/keygen"):
        eng.keygen()

    rng = np.random.default_rng(args.seed)
    slots = rc.n // 2
    v1 = rng.normal(size=slots)
    v2 = rng.normal(size=slots)
    scale = float(1 << rc.scale_bits)
    with stats.timer("setup/encrypt"):
        ct1 = eng.encrypt_complex(v1, rc.level, scale)
        ct2 = eng.encrypt_complex(v2, rc.level, scale)
        pt2 = eng.plaintext_complex(v2, rc.level, scale)

    shardmap_fn = None
    if use_shardmap:
        import dataclasses as _dc

        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .parallel.mesh import make_mesh as _mk

        both = (f"ici/device: limb={ici_limb / 1e6:.2f} MB, coeff="
                + (f"{ici_coeff / 1e6:.2f} MB" if ici_coeff is not None
                   else "n/a (tile shape)")
                + f" -> {dispatch}"
                + ("" if args.dispatch == "auto"
                   else " (forced)"))
        if dispatch == "hybrid":
            # 2-D limb x coeff mesh (the reference's limb dispatch
            # composed with 2-D BCONV/IP tiling, Driver.h:209-285)
            from .parallel.limb_sharded import (
                evk_limb_row_order, ici_bytes_per_op_hybrid,
                make_hybrid_hmult, make_hybrid_hrotate, pad_main_rows,
            )

            ns_l, ns_c = n_mesh // 2, 2
            mesh = _mk(shape=(ns_l, ns_c), n_devices=n_mesh,
                       axis_names=("limb", "coeff"))
            ct_sh = NamedSharding(mesh, P(None, "limb", None, "coeff"))
            key_sh = NamedSharding(
                mesh, P(None, None, "limb", None, "coeff"))
            order = jnp.asarray(evk_limb_row_order(params, rc.level, ns_l))
            limb_a = jax.device_put(
                pad_main_rows(ct1.data, rc.level, ns_l), ct_sh)
            limb_b = None
            if rc.op == "hmult":
                limb_b = jax.device_put(
                    pad_main_rows(ct2.data, rc.level, ns_l), ct_sh)
                eng.relin_key = jax.device_put(
                    jnp.take(eng.relin_key, order, axis=2), key_sh)
                shardmap_fn = make_hybrid_hmult(eng.dc, rc.level, mesh)
            else:
                eng.gen_rotation_key(1)
                eng.rot_keys[1] = jax.device_put(
                    jnp.take(eng.rot_keys[1], order, axis=2), key_sh)
                shardmap_fn = make_hybrid_hrotate(eng.dc, rc.level, mesh)
            ici = ici_bytes_per_op_hybrid(
                params, rc.level, ns_l, ns_c, rc.op,
                route_identity=route_ident2)
            print(f"# dispatch=shard_map axis=hybrid mesh=({ns_l} "
                  f"limb, {ns_c} coeff) ici_bytes_per_device={ici} — "
                  f"{both}")
        elif dispatch == "limb":
            from .parallel.limb_sharded import (
                evk_limb_row_order, make_limb_hmult, make_limb_hrotate,
                pad_main_rows,
            )

            mesh = _mk(shape=(n_mesh,), n_devices=n_mesh,
                       axis_names=("limb",))
            ct_sh = NamedSharding(mesh, P(None, "limb", None, None))
            key_sh = NamedSharding(mesh, P(None, None, "limb", None, None))
            order = jnp.asarray(evk_limb_row_order(params, rc.level, n_mesh))
            # Padded row layouts live OUTSIDE the Ciphertext containers
            # (whose level invariant pins shape[1] == level); op_once
            # re-slices the real rows into a fresh Ciphertext.
            limb_a = jax.device_put(
                pad_main_rows(ct1.data, rc.level, n_mesh), ct_sh)
            limb_b = None
            if rc.op == "hmult":
                limb_b = jax.device_put(
                    pad_main_rows(ct2.data, rc.level, n_mesh), ct_sh)
                eng.relin_key = jax.device_put(
                    jnp.take(eng.relin_key, order, axis=2), key_sh)
                shardmap_fn = make_limb_hmult(eng.dc, rc.level, mesh)
            else:
                eng.gen_rotation_key(1)
                eng.rot_keys[1] = jax.device_put(
                    jnp.take(eng.rot_keys[1], order, axis=2), key_sh)
                shardmap_fn = make_limb_hrotate(eng.dc, rc.level, mesh)
            ici = ici_limb
            print(f"# dispatch=shard_map axis=limb mesh=({n_mesh} "
                  f"limb) ici_bytes_per_device={ici} — {both}")
        else:
            from .parallel.sharded import (
                make_shardmap_hmult, make_shardmap_hrotate,
            )

            mesh = _mk(shape=(1, n_mesh), n_devices=n_mesh,
                       axis_names=("data", "coeff"))
            ct_sh = NamedSharding(mesh, P(None, None, None, "coeff"))
            key_sh = NamedSharding(mesh, P(None, None, None, None, "coeff"))
            ct1 = _dc.replace(ct1, data=jax.device_put(ct1.data, ct_sh))
            if rc.op == "hmult":
                ct2 = _dc.replace(ct2, data=jax.device_put(ct2.data, ct_sh))
                eng.relin_key = jax.device_put(eng.relin_key, key_sh)
                shardmap_fn = make_shardmap_hmult(eng.dc, rc.level, mesh)
            else:
                eng.gen_rotation_key(1)
                eng.rot_keys[1] = jax.device_put(eng.rot_keys[1], key_sh)
                shardmap_fn = make_shardmap_hrotate(eng.dc, rc.level, mesh)
            ici = ici_coeff
            print(f"# dispatch=shard_map axis=coeff mesh=(1 data, "
                  f"{n_mesh} coeff) ici_bytes_per_device={ici} — {both}")
        stats.set("ICI_bytes_per_device", ici)
    elif cluster_on:
        # Limb-shard operands and keys over the mesh (the reference's
        # limb-per-cluster dispatch, Driver.h:158); jitted op graphs
        # propagate the shardings and GSPMD inserts the collectives.
        import dataclasses as _dc

        from jax.sharding import NamedSharding, PartitionSpec as P

        from .parallel.mesh import make_mesh

        mesh = make_mesh(shape=(1, n_mesh), n_devices=n_mesh)
        print(f"# dispatch=gspmd mesh={dict(zip(mesh.axis_names, mesh.devices.shape))}")

        K = params.num_primes
        if rc.level % n_mesh == 0:
            ct_sh = NamedSharding(mesh, P(None, "limb", None, None))
            pt_sh = NamedSharding(mesh, P("limb", None, None))
            # the evk has K (not level) rows — shard its coefficient axis
            # when K doesn't divide (set C/D: K=30/35 over 2/4/8 meshes)
            key_sh = NamedSharding(
                mesh, P(None, None, "limb", None, None)
                if K % n_mesh == 0 else P(None, None, None, None, "limb"))
        else:
            # Limb count not divisible by the mesh: shard the coefficient
            # row (n2) axis instead — always a power of two (the
            # reference's batch-per-cluster round-robin, Driver.h:193-207).
            ct_sh = NamedSharding(mesh, P(None, None, "limb", None))
            pt_sh = NamedSharding(mesh, P(None, "limb", None))
            key_sh = NamedSharding(mesh, P(None, None, None, "limb", None))
        ct1 = _dc.replace(ct1, data=jax.device_put(ct1.data, ct_sh))
        ct2 = _dc.replace(ct2, data=jax.device_put(ct2.data, ct_sh))
        pt2 = _dc.replace(pt2, data=jax.device_put(pt2.data, pt_sh))
        # keys matter only to the keyswitch ops (forced --dispatch gspmd)
        if ks_op and eng.relin_key is not None:
            eng.relin_key = jax.device_put(eng.relin_key, key_sh)
        if ks_op and rc.op == "hrotate":
            eng.gen_rotation_key(1)
            eng.rot_keys[1] = jax.device_put(eng.rot_keys[1], key_sh)

    def op_once():
        if shardmap_fn is not None:
            from .context import Ciphertext

            if rc.op == "hmult":
                if dispatch in ("limb", "hybrid"):
                    data = shardmap_fn(limb_a, limb_b, eng.relin_key)
                    data = data[:, : rc.level - 1]  # drop zeroed pad rows
                else:
                    data = shardmap_fn(ct1.data, ct2.data, eng.relin_key)
                return Ciphertext(
                    data, rc.level - 1,
                    ct1.scale * ct2.scale / params.qs[rc.level - 1],
                )
            if dispatch == "limb":
                perm = eng.dc.automorph_perm(params.galois_elt(1))
                data = shardmap_fn(limb_a, perm, eng.rot_keys[1])
                data = data[:, : rc.level]
            elif dispatch == "hybrid":
                route = eng.dc.automorph_shard_route(
                    params.galois_elt(1), 2)
                data = shardmap_fn(limb_a, route, eng.rot_keys[1])
                data = data[:, : rc.level]
            else:
                route = eng.dc.automorph_shard_route(
                    params.galois_elt(1), n_mesh)
                data = shardmap_fn(ct1.data, route, eng.rot_keys[1])
            return Ciphertext(data, rc.level, ct1.scale)
        if rc.op == "hmult":
            return eng.hmult(ct1, ct2)
        if rc.op == "hadd":
            return eng.hadd(ct1, ct2)
        if rc.op == "hrotate":
            return eng.hrotate(ct1, 1)
        if rc.op == "pmult":
            return eng.pmult(ct1, pt2)
        if rc.op == "padd":
            return eng.padd(ct1, pt2)
        # Extended surface beyond the reference's 5-op contract:
        if rc.op == "hsub":
            return eng.hsub(ct1, ct2)
        if rc.op == "hsquare":
            return eng.hsquare(ct1)
        raise SystemExit(f"unknown op {rc.op!r} "
                         "(expected hmult|hadd|hrotate|pmult|padd"
                         "|hsub|hsquare)")

    with stats.timer("compile+first_run"):
        out = op_once()
        out.data.block_until_ready()

    profile_ctx = None
    if args.profile:
        import jax.profiler

        profile_ctx = jax.profiler.trace(args.profile)
        profile_ctx.__enter__()

    for _ in range(args.iters):
        t0 = time.perf_counter()
        out = op_once()
        out.data.block_until_ready()
        stats.record_time(f"op/{rc.op}", time.perf_counter() - t0)

    if profile_ctx is not None:
        profile_ctx.__exit__(None, None, None)
        print(f"# profiler trace written to {args.profile}")

    beta = params.beta(rc.level)
    stats.set("modmul_count", op_modmul_count(rc.op, rc.n, rc.level, rc.alpha, beta))
    stats.set("limbs", rc.level)
    stats.set("batchCount", rc.n // 256)  # reference batch granularity

    # Measured executable counters (reference Statistic parity: HBM beats,
    # SPM word traffic, per-unit busy work — Staistics.h:30-36). The
    # shard_map path reports ICI volume instead (the compile here would be
    # of the single-chip graph, not what ran).
    try:
        if use_shardmap:
            raise RuntimeError("shard_map path: see ICI_bytes_per_device")
        cc = eng.op_cost_counters(rc.op, ct1, ct2, pt2)
        for k, v in cc.items():
            stats.set(k, v)
        best = min(stats.timings[f"op/{rc.op}"])
        if "HBM_bytes" in cc and best > 0:
            stats.set("HBM_GBps_achieved", cc["HBM_bytes"] / best / 1e9)
    except Exception as e:  # cost analysis is backend-dependent
        print(f"# xla counters unavailable: {e}")

    if args.verify:
        with stats.timer("verify/decrypt"):
            got = eng.decrypt_complex(out)
        if rc.op == "hmult":
            expected = v1 * v2
        elif rc.op == "hadd":
            expected = v1 + v2
        elif rc.op == "hrotate":
            expected = np.roll(v1, -1)
        elif rc.op == "pmult":
            expected = v1 * v2
        elif rc.op == "hsub":
            expected = v1 - v2
        elif rc.op == "hsquare":
            expected = v1 * v1
        else:
            expected = v1 + v2
        err = float(np.max(np.abs(got - expected)))
        print(f"# verify max-abs-err = {err:.3e}")
        if err > 1e-2:
            print("VERIFY FAILED", file=sys.stderr)
            return 1

    ts = stats.timings[f"op/{rc.op}"]
    lat_ms = 1e3 * min(ts)
    print(f"FHE-Op {rc.op} latency: {lat_ms:.3f} ms "
          f"({1e3 / lat_ms:.1f} ops/s)")
    stats.show()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="homulator_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)
    runp = sub.add_parser("run", help="run one FHE operation (reference CLI parity)")
    runp.add_argument("cfg")
    runp.add_argument("op")
    runp.add_argument("max_level", type=int)
    runp.add_argument("level", type=int)
    runp.add_argument("alpha", type=int)
    runp.add_argument("cluster", type=int, nargs="?", default=None,
                      help="optional device-mesh size (the reference's 6th "
                           "positional, bench_micro24.cpp:23-25)")
    runp.add_argument("--dispatch", default="auto",
                      choices=["auto", "limb", "coeff", "hybrid", "gspmd"],
                      help="multi-chip dispatch axis for keyswitch ops "
                           "(auto = the limb or coeff axis with the smaller "
                           "exact per-device receive volume; limb is the "
                           "reference's primary dispatch, Driver.h:155-191)")
    runp.add_argument("--iters", type=int, default=5)
    runp.add_argument("--seed", type=int, default=0)
    runp.add_argument("--verify", action="store_true")
    runp.add_argument("--profile", default=None,
                      help="write a jax.profiler trace to this directory")
    runp.add_argument("--platform", default=None, help="jax platform override (e.g. cpu)")
    args = ap.parse_args(argv)
    if args.cmd == "run":
        return run_op(args)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
