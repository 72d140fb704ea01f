#!/usr/bin/env python
"""Hoisted-rotation benchmark: k rotations of one ciphertext sharing a
single ModUp (Halevi-Shoup hoisting, api.hrotate_hoisted) vs k independent
hrotate calls, at the canonical set-B point (N=2^16, L=45, l=35, a=15).

Correctness of hoisting is covered by tests/test_ops.py; this measures the
speedup (the shared ModUp is ~60% of a key switch).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> int:
    import jax

    from homulator_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from homulator_tpu import benchlib
    from homulator_tpu.api import CkksEngine, _hrotate_hoisted_graph
    from homulator_tpu.params import get_params

    n, max_level, level, alpha = 65536, 45, 35, 15
    params = get_params(n=n, max_level=max_level, alpha=alpha)
    eng = CkksEngine(params, seed=1)
    eng.keygen()
    steps = [1, 2, 4, 8]
    for s in steps:
        eng.gen_rotation_key(s)
    perms = tuple(eng.dc.automorph_perm(params.galois_elt(s)) for s in steps)
    rotks = tuple(eng.rot_keys[s] for s in steps)
    kt = eng.dc.keyswitch_tables(level)

    scale = 2.0**29
    m = np.zeros(n, dtype=np.int64)
    m[0] = int(3 * scale)
    ct = eng.encrypt_ints(m, level, scale)

    @jax.jit
    def chain_hoisted(a, perms, rotks, kt, iters):
        def body(_, carry):
            outs = _hrotate_hoisted_graph(carry, perms, rotks, kt)
            return outs[0]  # feed one rotation back (same level/shape)
        return jax.lax.fori_loop(0, iters, body, a)

    hoisted = benchlib.time_chained(
        chain_hoisted, 2, 16, ct.data, perms, rotks, kt)
    single = benchlib.hrotate_seconds(eng, ct, 1)
    out = {
        "k_rotations": len(steps),
        "hoisted_ms_for_k": round(1e3 * hoisted, 3),
        "hoisted_ms_per_rotation": round(1e3 * hoisted / len(steps), 3),
        "single_hrotate_ms": round(1e3 * single, 3),
        "speedup_vs_k_singles": round(len(steps) * single / hoisted, 2),
    }
    for k, v in out.items():
        print(f"{k:28s} {v}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
