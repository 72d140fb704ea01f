#!/usr/bin/env python3
"""Smoke test of the CKKS op set on the GPU, through the entry points a
user calls, at parameter set B (N=2^16, maxLevel 45, level 35, alpha 15 —
configs/n16.cfg).

One card (the default) — one line per phase, in order:
  card     the card's name and power limit (nvidia-smi, in a child that
           never imports JAX) and JAX's device_kind
  build    the native host library and the CUDA NTT library, from source
  kernels  every kernel compiled at set-B widths and compared with its
           plain reference: CUDA NTT/iNTT vs the XLA leaf, the bf16 base
           conversion vs the Montgomery conversion; the hmult step's
           compiled.memory_analysis()
  ops      keygen + encrypt, then hadd hsub padd pmult hmult hsquare
           hrotate and a 4-step hoisted rotation, each decrypt-verified
           (max-abs-err < 1e-2, the CLI's gate); hmult and hrotate are
           checked bit-exactly against refimpl.py
  matvec   the 64x64 BSGS matvec (linalg.bsgs_matvec), decrypt-verified
  timings  hmult and hrotate end to end for the three key-switch variants
           (montgomery pipeline, piecewise pipeline with the XLA NTT leaf,
           piecewise pipeline with the CUDA NTT leaf), the NTT alone at
           50 and 61 rows, and compile times

`--cards 4` runs only the four-card dispatches (limb, coeff, 2-D hybrid
and GSPMD) for set-B hmult and hrotate, each compared bit-exactly with the
single-card graph in the same process.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
Without a GPU, or outside a checkout of the repository, it exits non-zero
and prints no result. `--out PATH` also writes every number as JSON.

    python chip_smoke.py [--cards 4] [--out results.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

N, MAX_LEVEL, LEVEL, ALPHA = 1 << 16, 45, 35, 15
SCALE = float(1 << 29)
GATE = 1e-2  # the CLI's --verify bound
REPS = 10  # timed calls per variant and turn


def card_line() -> str:
    """nvidia-smi's name and power limit; a child process that stays off
    JAX, so this process is the only one holding the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())


def wall_ms(fn, n: int):
    """Per-call wall times (ms) of fn(), each ending in block_until_ready."""
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        fn().block_until_ready()
        ts.append(1e3 * (time.perf_counter() - t))
    return ts


def median(xs):
    s = sorted(xs)
    return s[len(s) // 2]


class Smoke:
    def __init__(self, args):
        import jax
        import numpy as np

        from homulator_tpu.params import get_params

        self.jax, self.np = jax, np
        self.args = args
        self.params = get_params(n=N, max_level=MAX_LEVEL, alpha=ALPHA)
        self.rng = np.random.default_rng(args.seed)
        self.record = {}

    def line(self, phase: str, text: str, **numbers) -> None:
        self.record[phase] = numbers
        print(f"{phase}: {text}", flush=True)

    # ---- phase 2 -----------------------------------------------------------
    def build(self) -> None:
        from homulator_tpu import native
        from homulator_tpu.ops import ntt_cuda

        t = time.perf_counter()
        if native.build() is None:
            raise RuntimeError("no C++ compiler for the native host library")
        t_native = time.perf_counter() - t
        t = time.perf_counter()
        ntt_cuda.load()
        t_cuda = time.perf_counter() - t
        self.line("build", f"native {t_native:.2f} s, cuda ntt "
                  f"{t_cuda:.2f} s (set-up)",
                  native_s=t_native, cuda_s=t_cuda)

    # ---- phase 3 -----------------------------------------------------------
    def gpu_tests(self) -> dict:
        """Run the repository's `gpu`-marked tests (CUDA NTT vs the XLA
        leaf at set-B widths) in this process, on the card; their output
        is kept off stdout. Returns pass/fail/skip counts."""
        import contextlib
        import io

        import pytest

        counts = {"passed": 0, "failed": 0, "skipped": 0}

        class Tally:
            def pytest_runtest_logreport(self, report):
                if report.when == "call" or report.outcome != "passed":
                    counts[report.outcome] += 1

        root = os.path.dirname(os.path.abspath(__file__))
        prev = self.jax.config.jax_platforms
        with contextlib.redirect_stdout(io.StringIO()):
            rc = pytest.main(
                [os.path.join(root, "tests"), "-m", "gpu", "-q",
                 "-p", "no:cacheprovider"], plugins=[Tally()])
        # tests/conftest.py names the CPU platform; the GPU backend is
        # already up, so that changes nothing here — restore it anyway.
        self.jax.config.update("jax_platforms", prev)
        if rc != 0 or counts["failed"] or counts["skipped"] or not counts[
                "passed"]:
            raise AssertionError(f"gpu tests: rc {rc}, {counts}")
        return counts

    def kernels(self) -> None:
        jax, np = self.jax, self.np
        import jax.numpy as jnp

        from homulator_tpu.context import DeviceContext
        from homulator_tpu.ops.bconv_fused import bconv_fused
        from homulator_tpu.ops.keyswitch import modup_digit

        p = self.params
        t_ = p.ntt
        t = time.perf_counter()
        tests = self.gpu_tests()
        tests_s = time.perf_counter() - t
        dcu = DeviceContext(p, "cuda")
        dx = DeviceContext(p, "xla")
        dm = DeviceContext(p, "montgomery")
        checks = {}
        q_main = jnp.asarray(p.q_arr[:LEVEL].astype(np.uint32))
        x = jnp.asarray(self.rng.integers(
            0, 1 << 32, size=(LEVEL, t_.n1, t_.n2), dtype=np.uint64
        ).astype(np.uint32))
        # bf16 base conversion vs the Montgomery conversion, digit 0 of
        # set B at level 35 (15 input rows + centering row -> 35 rows)
        kt_x = dx.keyswitch_tables(LEVEL)
        kt_m = dm.keyswitch_tables(LEVEL)
        c = x % q_main[:, None, None]
        dt = kt_x.digits[0]
        t = time.perf_counter()
        conv = jax.jit(bconv_fused, static_argnames=("center",))
        args = (c[dt.lo:dt.hi], dt.step1_pl, dt.step1_sh,
                kt_x.main_nt.q[dt.lo:dt.hi], dt.mat_bf16, dt.horner_sh,
                dt.other_nt.q)
        got = conv.lower(*args, center=True).compile()(*args)
        compile_bconv = time.perf_counter() - t
        ref = jax.jit(modup_digit, static_argnums=2)(c, kt_m, 0)
        alpha = p.alpha
        ref_other = jnp.concatenate(
            [ref[:alpha + dt.lo], ref[alpha + dt.hi:]], axis=0)
        checks["bconv_fused"] = bool(jnp.array_equal(got, ref_other))
        bad = [k for k, v in checks.items() if not v]
        if bad:
            raise AssertionError(f"kernel mismatch vs reference: {bad}")

        # the hmult step at set B: compile + memory analysis
        from homulator_tpu.api import _hmult_graph

        kt = dcu.keyswitch_tables(LEVEL)
        ct = jnp.stack([c, c])
        evk = jnp.zeros((p.dnum, 2, p.num_primes, t_.n2, t_.n1), jnp.uint32)
        t = time.perf_counter()
        compiled = _hmult_graph.lower(
            ct, ct, evk, kt, dcu.ntt_basis((LEVEL - 1,)),
            dcu.ntt_basis(dcu.main_rows(LEVEL - 1)),
            dcu.rescale_qinv_mont(LEVEL)).compile()
        compile_hmult = time.perf_counter() - t
        mem = compiled.memory_analysis()
        mem_d = {k: int(getattr(mem, k)) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(mem, k)}
        self.line(
            "kernels",
            f"gpu tests (cuda ntt/intt == xla leaf at [1|50|61, {t_.n1}, "
            f"{t_.n2}], rep 2, vmap) {tests['passed']} passed in "
            f"{tests_s:.1f} s; bconv_fused == montgomery at nd="
            f"{dt.hi - dt.lo}+1 -> {len(ref_other)} rows ok; compile s: "
            f"bconv {compile_bconv:.2f}, hmult step {compile_hmult:.2f}; "
            f"hmult memory_analysis {mem_d}",
            gpu_tests=tests, gpu_tests_s=tests_s, checks=checks,
            compile_bconv_s=compile_bconv, compile_hmult_s=compile_hmult,
            hmult_memory=mem_d)

    # ---- phase 4 -----------------------------------------------------------
    def ops(self) -> None:
        np = self.np
        from homulator_tpu.api import CkksEngine

        p = self.params
        t = time.perf_counter()
        eng = CkksEngine(p, seed=self.args.seed)  # default leaf
        eng.keygen()
        keygen_s = time.perf_counter() - t
        slots = N // 2
        v1 = self.rng.normal(size=slots)
        v2 = self.rng.normal(size=slots)
        t = time.perf_counter()
        r1 = eng.ref.encrypt(eng.ref.encode_complex(v1, LEVEL, SCALE))
        r2 = eng.ref.encrypt(eng.ref.encode_complex(v2, LEVEL, SCALE))
        ct1 = eng.dc.upload_ct(r1.data, LEVEL, SCALE)
        ct2 = eng.dc.upload_ct(r2.data, LEVEL, SCALE)
        pt2 = eng.plaintext_complex(v2, LEVEL, SCALE)
        encrypt_s = time.perf_counter() - t
        steps = [1, 2, 3, 4]
        for s in steps:
            eng.gen_rotation_key(s)
        cases = {
            "hadd": (lambda: eng.hadd(ct1, ct2), v1 + v2),
            "hsub": (lambda: eng.hsub(ct1, ct2), v1 - v2),
            "padd": (lambda: eng.padd(ct1, pt2), v1 + v2),
            "pmult": (lambda: eng.pmult(ct1, pt2), v1 * v2),
            "hmult": (lambda: eng.hmult(ct1, ct2), v1 * v2),
            "hsquare": (lambda: eng.hsquare(ct1), v1 * v1),
            "hrotate": (lambda: eng.hrotate(ct1, 1), np.roll(v1, -1)),
        }
        errs, outs, first_s = {}, {}, {}
        for name, (fn, want) in cases.items():
            t = time.perf_counter()
            out = fn()
            out.data.block_until_ready()
            first_s[name] = time.perf_counter() - t
            outs[name] = out
            errs[name] = float(np.max(np.abs(eng.decrypt_complex(out) - want)))
        t = time.perf_counter()
        hoisted = eng.hrotate_hoisted(ct1, steps)
        hoisted[-1].data.block_until_ready()
        first_s["hoisted4"] = time.perf_counter() - t
        errs["hoisted4"] = max(
            float(np.max(np.abs(eng.decrypt_complex(o) - np.roll(v1, -s))))
            for o, s in zip(hoisted, steps))
        exact = {
            "hmult": bool(np.array_equal(
                eng.dc.download(outs["hmult"].data), eng.ref.hmult(r1, r2).data)),
            "hrotate": bool(np.array_equal(
                eng.dc.download(outs["hrotate"].data),
                eng.ref.hrotate(r1, 1).data)),
        }
        bad = [k for k, e in errs.items() if not e < GATE]
        if bad or not all(exact.values()):
            raise AssertionError(f"ops failed: errs {errs} exact {exact}")
        self.eng, self.cts, self.vs = eng, (ct1, ct2), (v1, v2)
        self.line(
            "ops",
            f"leaf={eng.dc.ntt_mode} keygen {keygen_s:.2f} s, encrypt "
            f"{encrypt_s:.2f} s; max-abs-err "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + "; hmult, hrotate bit-exact vs refimpl",
            leaf=eng.dc.ntt_mode, keygen_s=keygen_s, encrypt_s=encrypt_s,
            errors=errs, exact=exact, first_call_s=first_s)

    # ---- phase 5 -----------------------------------------------------------
    def matvec(self) -> None:
        np = self.np
        from homulator_tpu import linalg

        eng = self.eng
        d = 64
        M = self.rng.normal(size=(d, d)) / d
        xv = self.rng.normal(size=d)
        ct = linalg.encrypt_vector(eng, xv, LEVEL, SCALE)
        t = time.perf_counter()
        out = linalg.bsgs_matvec(eng, ct, M)
        out.data.block_until_ready()
        first_s = time.perf_counter() - t
        t = time.perf_counter()
        out = linalg.bsgs_matvec(eng, ct, M)
        out.data.block_until_ready()
        warm_s = time.perf_counter() - t
        got = eng.decrypt_complex(out).real
        err = float(np.max(np.abs(got - linalg.pack_vector(M @ xv, N // 2))))
        if not err < GATE:
            raise AssertionError(f"matvec max-abs-err {err}")
        self.line("matvec", f"64x64 bsgs max-abs-err {err:.2e}, first call "
                  f"{first_s:.2f} s, warm {1e3 * warm_s:.1f} ms",
                  err=err, first_s=first_s, warm_ms=1e3 * warm_s)

    # ---- phase 6 -----------------------------------------------------------
    def timings(self) -> None:
        jax, np = self.jax, self.np
        import jax.numpy as jnp

        from homulator_tpu import benchlib
        from homulator_tpu.api import CkksEngine
        from homulator_tpu.context import DeviceContext
        from homulator_tpu.ops.ntt import ntt

        p = self.params
        ct1, ct2 = self.cts
        engines, compile_s = {}, {}
        for mode in ("montgomery", "xla", "cuda"):
            eng = CkksEngine(p, seed=self.args.seed, ntt_mode=mode)
            eng.keygen()
            eng.gen_rotation_key(1)
            for op, fn in (("hmult", lambda: eng.hmult(ct1, ct2)),
                           ("hrotate", lambda: eng.hrotate(ct1, 1))):
                t = time.perf_counter()
                fn().data.block_until_ready()
                compile_s[f"{mode}/{op}"] = time.perf_counter() - t
            engines[mode] = eng
        times = {f"{m}/{op}": [] for m in engines for op in ("hmult",
                                                               "hrotate")}
        reps = REPS
        for order in (("montgomery", "xla", "cuda"),
                      ("cuda", "xla", "montgomery")):
            for mode in order:
                eng = engines[mode]
                times[f"{mode}/hmult"] += wall_ms(
                    lambda: eng.hmult(ct1, ct2).data, reps)
                times[f"{mode}/hrotate"] += wall_ms(
                    lambda: eng.hrotate(ct1, 1).data, reps)
        med = {k: median(v) for k, v in times.items()}

        # the NTT alone: per-call wall time and per-transform device time
        # from a chained NTT∘iNTT loop (difference quotient cancels the
        # dispatch)
        ntt_ms = {}
        fwd = jax.jit(ntt)
        for rows_n in (50, 61):
            # 61 > K = 60 at set B: rows past K reuse primes from the start
            rows = tuple(i % p.num_primes for i in range(rows_n))
            q = np.asarray(p.q_arr)[list(rows)]
            x = jnp.asarray(np.stack([
                self.rng.integers(0, int(qq), size=(p.ntt.n1, p.ntt.n2),
                                  dtype=np.uint64) for qq in q
            ]).astype(np.uint32))
            y = x.transpose(0, 2, 1)  # any [M, n2, n1] residues
            for mode in ("xla", "cuda"):
                nb = DeviceContext(p, mode).ntt_basis(rows)
                fwd(x, nb).block_until_ready()
                call = median(wall_ms(lambda: fwd(x, nb), reps))
                pair = benchlib.time_chained(benchlib._chained_ntt, 4, 44,
                                             y, nb)
                ntt_ms[f"{mode}/{rows_n}"] = {
                    "call_ms": call, "transform_ms": 1e3 * pair / 2}
        fastest = min(("montgomery", "xla", "cuda"),
                      key=lambda m: med[f"{m}/hmult"] + med[f"{m}/hrotate"])
        self.line(
            "timings",
            "median ms hmult/hrotate: " + ", ".join(
                f"{m} {med[m + '/hmult']:.3f}/{med[m + '/hrotate']:.3f}"
                for m in ("montgomery", "xla", "cuda"))
            + f" (fastest {fastest}); ntt ms/transform: " + ", ".join(
                f"{k} {v['transform_ms']:.4f}" for k, v in ntt_ms.items())
            + "; compile s: " + ", ".join(
                f"{k} {v:.1f}" for k, v in compile_s.items()),
            median_ms=med, samples_ms=times, ntt=ntt_ms,
            compile_s=compile_s, fastest=fastest, reps_per_turn=reps)

    # ---- --cards 4 ---------------------------------------------------------
    def cards(self) -> None:
        jax, np = self.jax, self.np
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from homulator_tpu.api import (
            CkksEngine, _hmult_graph, _hrotate_graph,
        )
        from homulator_tpu.parallel.limb_sharded import (
            evk_limb_row_order, make_hybrid_hmult, make_hybrid_hrotate,
            make_limb_hmult, make_limb_hrotate, pad_main_rows,
        )
        from homulator_tpu.parallel.mesh import make_mesh
        from homulator_tpu.parallel.sharded import (
            make_shardmap_hmult, make_shardmap_hrotate,
        )

        ns = self.args.cards
        p = self.params
        eng = CkksEngine(p, seed=self.args.seed)
        eng.keygen()
        eng.gen_rotation_key(1)
        v1 = self.rng.normal(size=N // 2)
        v2 = self.rng.normal(size=N // 2)
        ct1 = eng.encrypt_complex(v1, LEVEL, SCALE)
        ct2 = eng.encrypt_complex(v2, LEVEL, SCALE)
        dc = eng.dc
        ref_m = np.asarray(eng.hmult(ct1, ct2).data)  # single-card graphs
        ref_r = np.asarray(eng.hrotate(ct1, 1).data)
        g = p.galois_elt(1)
        perm = dc.automorph_perm(g)
        rk, evk = eng.rot_keys[1], eng.relin_key
        results = {}

        errors = {}

        def run(name, f_m, f_r, post=lambda o, lv: o):
            t = time.perf_counter()
            try:
                measure(name, f_m, f_r, post)
            except Exception as e:  # report every dispatch, then fail
                errors[name] = f"{type(e).__name__}: {e}"
            print(f"# cards: {name} done in {time.perf_counter() - t:.1f} s"
                  f" ({'error' if name in errors else 'ok'})",
                  file=sys.stderr, flush=True)

        def measure(name, f_m, f_r, post):
            outs = []
            for f, ref, lv in ((f_m, ref_m, LEVEL - 1),
                               (f_r, ref_r, LEVEL)):
                t = time.perf_counter()
                out = f()
                out.block_until_ready()
                first = time.perf_counter() - t
                devs = len(out.sharding.device_set)
                got = np.asarray(post(out, lv))
                ms = median(wall_ms(f, REPS))
                outs.append({"exact": bool(np.array_equal(got, ref)),
                             "first_s": first, "median_ms": ms,
                             "devices": devs})
            results[name] = {"hmult": outs[0], "hrotate": outs[1]}

        def cut(o, lv):
            return o[:, :lv]

        # limb: RNS rows over ns cards
        mesh = make_mesh(shape=(ns,), n_devices=ns, axis_names=("limb",))
        order = jnp.asarray(evk_limb_row_order(p, LEVEL, ns))
        ct_sh = NamedSharding(mesh, P(None, "limb", None, None))
        key_sh = NamedSharding(mesh, P(None, None, "limb", None, None))
        a_l = jax.device_put(pad_main_rows(ct1.data, LEVEL, ns), ct_sh)
        b_l = jax.device_put(pad_main_rows(ct2.data, LEVEL, ns), ct_sh)
        evk_l = jax.device_put(jnp.take(evk, order, axis=2), key_sh)
        rk_l = jax.device_put(jnp.take(rk, order, axis=2), key_sh)
        fm = make_limb_hmult(dc, LEVEL, mesh)
        fr = make_limb_hrotate(dc, LEVEL, mesh)
        run("limb", lambda: fm(a_l, b_l, evk_l),
            lambda: fr(a_l, perm, rk_l), cut)

        # coeff: coefficient columns over ns cards
        mesh = make_mesh(shape=(1, ns), n_devices=ns,
                         axis_names=("data", "coeff"))
        ct_sh = NamedSharding(mesh, P(None, None, None, "coeff"))
        key_sh = NamedSharding(mesh, P(None, None, None, None, "coeff"))
        a_c = jax.device_put(ct1.data, ct_sh)
        b_c = jax.device_put(ct2.data, ct_sh)
        evk_c = jax.device_put(evk, key_sh)
        rk_c = jax.device_put(rk, key_sh)
        route = dc.automorph_shard_route(g, ns)
        fm = make_shardmap_hmult(dc, LEVEL, mesh)
        fr = make_shardmap_hrotate(dc, LEVEL, mesh)
        run("coeff", lambda: fm(a_c, b_c, evk_c),
            lambda: fr(a_c, route, rk_c))

        # hybrid: ns/2 limb x 2 coeff
        ns_l = ns // 2
        mesh = make_mesh(shape=(ns_l, 2), n_devices=ns,
                         axis_names=("limb", "coeff"))
        order = jnp.asarray(evk_limb_row_order(p, LEVEL, ns_l))
        ct_sh = NamedSharding(mesh, P(None, "limb", None, "coeff"))
        key_sh = NamedSharding(mesh, P(None, None, "limb", None, "coeff"))
        a_h = jax.device_put(pad_main_rows(ct1.data, LEVEL, ns_l), ct_sh)
        b_h = jax.device_put(pad_main_rows(ct2.data, LEVEL, ns_l), ct_sh)
        evk_h = jax.device_put(jnp.take(evk, order, axis=2), key_sh)
        rk_h = jax.device_put(jnp.take(rk, order, axis=2), key_sh)
        route2 = dc.automorph_shard_route(g, 2)
        fm = make_hybrid_hmult(dc, LEVEL, mesh)
        fr = make_hybrid_hrotate(dc, LEVEL, mesh)
        run("hybrid", lambda: fm(a_h, b_h, evk_h),
            lambda: fr(a_h, route2, rk_h), cut)

        # GSPMD: the partitioner shards the XLA-leaf graph (level 35 does
        # not divide the mesh, so tiles shard their row axis, as the CLI)
        eng_x = CkksEngine(p, seed=self.args.seed, ntt_mode="xla")
        dcx = eng_x.dc
        mesh = make_mesh(shape=(1, ns), n_devices=ns)
        ct_sh = NamedSharding(mesh, P(None, None, "limb", None))
        key_sh = NamedSharding(mesh, P(None, None, "limb", None, None)
                               if p.num_primes % ns == 0
                               else P(None, None, None, "limb", None))
        a_g = jax.device_put(ct1.data, ct_sh)
        b_g = jax.device_put(ct2.data, ct_sh)
        evk_g = jax.device_put(evk, key_sh)
        rk_g = jax.device_put(rk, key_sh)
        kt = dcx.keyswitch_tables(LEVEL)
        tabs = (dcx.ntt_basis((LEVEL - 1,)),
                dcx.ntt_basis(dcx.main_rows(LEVEL - 1)),
                dcx.rescale_qinv_mont(LEVEL))
        run("gspmd", lambda: _hmult_graph(a_g, b_g, evk_g, kt, *tabs),
            lambda: _hrotate_graph(a_g, perm, rk_g, kt))

        bad = [f"{k}/{op}" for k, r in results.items()
               for op in ("hmult", "hrotate")
               if not (r[op]["exact"] and r[op]["devices"] == ns)]
        if bad or errors:
            raise AssertionError(f"four-card mismatch or placement: {bad} "
                                 f"errors {errors} results {results}")
        self.line(
            "cards",
            f"{ns} cards, set-B hmult/hrotate bit-exact vs one card for "
            + ", ".join(results) + "; median ms hmult/hrotate: "
            + ", ".join(f"{k} {r['hmult']['median_ms']:.3f}/"
                        f"{r['hrotate']['median_ms']:.3f}"
                        for k, r in results.items()),
            **results)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=[1, 4],
                    help="4: run only the four-card dispatch phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write results here")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import homulator_tpu  # noqa: F401
    except ImportError:
        print("chip_smoke: homulator_tpu not found; run it from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    from homulator_tpu.runtime import enable_compile_cache, require_gpu

    dev = require_gpu()  # raises without a GPU: no CPU fallback
    enable_compile_cache()
    import jax

    count = len(jax.devices())
    if count < args.cards:
        raise RuntimeError(f"--cards {args.cards} needs {args.cards} GPUs, "
                           f"JAX sees {count}")
    smoke = Smoke(args)
    smoke.line("card", f"{card_line()} | device_kind {dev.device_kind}, "
               f"{count} visible", kind=dev.device_kind, count=count)
    smoke.build()
    if args.cards == 1:
        smoke.kernels()
        smoke.ops()
        smoke.matvec()
        smoke.timings()
    else:
        smoke.cards()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(smoke.record, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
