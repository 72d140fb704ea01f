#!/usr/bin/env python
"""Single-chip batched-hmult throughput (the serving-shape measurement).

The reference's Driver round-robins independent ciphertext ops over its
simulated clusters (Driver.h:193-207) — the serving regime where
throughput, not single-op latency, is the metric. On one chip the same
regime is a vmap over the op graph: the batch dimension lifts every
kernel and XLA fusion to rep-B, amortizing twiddle/keyswitch-table
reads (the evk and all NTT tables are batch-invariant) over B
independent ops.

Prints one JSON line: per-op latency at B=1 and amortized per-op latency
(+ ops/s) at each batch size, measured by chained on-device loops.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np


def main() -> int:
    import jax
    import jax.numpy as jnp

    from homulator_tpu.runtime import enable_compile_cache

    enable_compile_cache()

    from homulator_tpu import benchlib
    from homulator_tpu.api import CkksEngine, hmult_graph
    from homulator_tpu.params import get_params

    n, max_level, level, alpha = 65536, 45, 35, 15
    params = get_params(n=n, max_level=max_level, alpha=alpha)
    eng = CkksEngine(params, seed=1)
    eng.keygen()

    dc = eng.dc
    kt = dc.keyswitch_tables(level)
    last_nt = dc.ntt_basis((level - 1,))
    out_nt = dc.ntt_basis(dc.main_rows(level - 1))
    rs = dc.rescale_qinv_mont(level)
    evk = eng.relin_key

    scale = 2.0**29
    rng = np.random.default_rng(0)
    m = np.zeros(n, dtype=np.int64)
    m[0] = int(7 * scale)
    ct = eng.encrypt_ints(m, level, scale)

    @jax.jit
    def batched(a, b, iters):
        f = jax.vmap(
            lambda x, y: hmult_graph(x, y, evk, kt, last_nt, out_nt, rs)
        )

        def body(_, carry):
            out = f(carry, b)
            # data dependency: feed the (level-1)-row output back into the
            # first level-1 rows of the carry (shape-only chaining; values
            # are irrelevant to timing)
            return carry.at[:, :, : level - 1].set(out)

        return jax.lax.fori_loop(0, iters, body, a)

    out = {"backend": jax.default_backend(), "op": "hmult",
           "shape": f"L={max_level} l={level} alpha={alpha}"}
    b1 = None
    for B in (1, 2, 4, 8):
        a = jnp.stack([ct.data] * B)
        b = jnp.stack([ct.data] * B)
        t0 = time.perf_counter()
        sec = benchlib.time_chained(batched, 4, max(8, 28 // B), a, b)
        per_op_ms = 1e3 * sec / B
        out[f"batch{B}_per_op_ms"] = round(per_op_ms, 3)
        out[f"batch{B}_ops_per_s"] = round(B / sec, 1)
        out[f"batch{B}_setup_s"] = round(time.perf_counter() - t0, 1)
        if B == 1:
            b1 = per_op_ms
    out["batch8_speedup_vs_b1"] = round(b1 / out["batch8_per_op_ms"], 3)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
