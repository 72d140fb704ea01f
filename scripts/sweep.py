#!/usr/bin/env python
"""Benchmark sweep: parameter sets A-D x ops x levels (script/** parity).

The reference ships per-set shell sweeps (script/para{A,B,C,D}/*.sh) that
run every op at every level from maxLevel down to 2 and tee logs into
outLogs/<set>/... This runner does the same against the real implementation,
writing one JSON line per run to outLogs/<set>/<op>.jsonl.

Each distinct level is a distinct XLA program; first runs pay compilation
(cached on disk under .jax_cache), so default sweeps sample a level subset.
Use --levels all for the full reference grid (paraA/micro24_A_hmult.sh:13-16).

Usage: python scripts/sweep.py [--sets A B] [--ops hmult hadd] [--levels 35 20 10 2]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Reference parameter sets (script/README.md:17-22). "M" is the
# script/motivation analog: set-A limb structure (maxLevel=28, alpha=28)
# on the N=2^16 config (micro24_motivation.sh:3-6 runs hmult over
# config_4.cfg at every level 28..2).
PARAM_SETS = {
    "A": dict(n=2**15, max_level=28, alpha=28),
    "B": dict(n=2**16, max_level=45, alpha=15),
    "C": dict(n=2**16, max_level=24, alpha=6),
    "D": dict(n=2**16, max_level=26, alpha=9),
    "M": dict(n=2**16, max_level=28, alpha=28),
}
OPS = ["hmult", "hadd", "hrotate", "pmult", "padd"]


def run_sweep(sets, ops, levels_arg, iters, out_dir):
    import jax

    from homulator_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    import numpy as np

    from homulator_tpu import benchlib
    from homulator_tpu.api import CkksEngine
    from homulator_tpu.params import get_params

    for set_name in sets:
        cfg = PARAM_SETS[set_name]
        params = get_params(**cfg)
        eng = CkksEngine(params, seed=1)
        eng.keygen()
        scale = 2.0**29
        if levels_arg == "all":
            levels = list(range(cfg["max_level"], 1, -1))
        elif levels_arg == "auto":
            # Justified subset: each distinct level is a distinct XLA
            # program through the slow remote-compile path, so sample the
            # sweep at {max, 3/4, 1/2, 1/4, 2} per set (latency is a
            # smooth, near-affine function of the limb count — the
            # reference's own per-level cycle curves are piecewise affine).
            L = cfg["max_level"]
            levels = sorted({L, 3 * L // 4, L // 2, L // 4, 2}, reverse=True)
            if set_name == "B":
                levels = sorted(set(levels) | {35}, reverse=True)  # canonical
        else:
            levels = [l for l in levels_arg if 2 <= l <= cfg["max_level"]]
        os.makedirs(os.path.join(out_dir, set_name), exist_ok=True)

        def measure(op, level):
            m = np.zeros(params.n, dtype=np.int64)
            m[0] = int(3 * scale)
            ct1 = eng.encrypt_ints(m, level, scale)
            ct2 = eng.encrypt_ints(m, level, scale)
            pt = eng.plaintext_ints(m, level, 1.0)
            t0 = time.perf_counter()
            # Every op is timed as a chained on-device loop (benchlib):
            # per-dispatch latency cancels in the quotient.
            if op == "hmult":
                sec = benchlib.hmult_seconds(eng, ct1, ct2)
            elif op == "hrotate":
                sec = benchlib.hrotate_seconds(eng, ct1, 1)
            elif op == "hadd":
                sec = benchlib.hadd_seconds(eng, ct1, ct2)
            elif op == "pmult":
                sec = benchlib.pmult_seconds(eng, ct1, pt)
            elif op == "padd":
                sec = benchlib.padd_seconds(eng, ct1, pt)
            else:
                raise SystemExit(f"unknown op {op}")
            rec = {
                "set": set_name, "op": op, "n": params.n,
                "max_level": cfg["max_level"], "level": level,
                "alpha": cfg["alpha"],
                "latency_ms": round(1e3 * sec, 4),
                "setup_s": round(time.perf_counter() - t0, 1),
                "backend": jax.default_backend(),
            }
            with open(os.path.join(out_dir, set_name, f"{op}.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)

        if levels_arg == "all" or len(levels) > 8:
            # LEVEL-major: all ops at one level share the level's device
            # tables, then the caches are dropped — each level's
            # NTT/keyswitch tables are ~100+ MB of HBM and 40+ cached
            # levels would not fit. (Same discipline for any long explicit
            # list, e.g. resuming an interrupted full grid.)
            for level in levels:
                for op in ops:
                    measure(op, level)
                eng.dc._nt_cache.clear()
                eng.dc._ks_cache.clear()
                eng.dc._rs_cache.clear()
        else:
            for op in ops:
                for level in levels:
                    measure(op, level)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sets", nargs="+", default=["B"], choices=list(PARAM_SETS))
    ap.add_argument("--ops", nargs="+", default=OPS, choices=OPS)
    ap.add_argument("--levels", nargs="+", default=["35", "20", "10", "2"])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default="outLogs")
    args = ap.parse_args()
    if args.levels in (["all"], ["auto"]):
        levels = args.levels[0]
    else:
        levels = [int(x) for x in args.levels]
    run_sweep(args.sets, args.ops, levels, args.iters, args.out)


if __name__ == "__main__":
    main()
