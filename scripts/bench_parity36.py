#!/usr/bin/env python
"""Bit-width parity run: the canonical workload at the reference's MODELED
modulus magnitude.

The reference models 36-bit machine words (config_4.cfg:9
`elementBitWidth = 36`), so its set-B workload `hmult 45 35 15` carries a
36*45 = 1620-bit main modulus, a 36*35 = 1260-bit live modulus and a
36*15 = 540-bit special modulus. This framework uses <2^30 primes (~29.4
effective bits each — numtheory.PRIME_CAP keeps 6q < 2^32 for lazy
sums), so magnitude parity needs MORE, SMALLER primes:

    L'     = ceil(1620 / eff_bits)   main limbs
    level' = ceil(1260 / eff_bits)   live limbs
    alpha' = ceil(540  / eff_bits)   special limbs (dnum stays 3)

computed below from the actually generated primes. This script runs hmult
at BOTH settings and prints one JSON line with the pair, plus the
host-side keygen/encode/encrypt setup costs the serving story needs.
"""

import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def parity36_shape(n: int, max_level: int, alpha: int, level: int):
    """Limb counts whose total modulus bits match the reference's modeled
    36-bit words, from the actually generated prime magnitudes."""
    from homulator_tpu import numtheory as nt

    pool = nt.gen_ntt_primes(n, 2 * (max_level + alpha))
    bits = np.array([math.log2(p) for p in pool])

    def count_for(target):
        csum = np.cumsum(bits)
        return int(np.searchsorted(csum, target) + 1)

    L36 = count_for(36 * max_level)
    a36 = count_for(36 * alpha)
    l36 = count_for(36 * level)
    return L36, a36, l36, float(bits[: L36 + a36].mean())


def run_one(n, max_level, level, alpha, tag, out):
    import jax

    from homulator_tpu import benchlib
    from homulator_tpu.api import CkksEngine
    from homulator_tpu.params import get_params

    t0 = time.perf_counter()
    params = get_params(n=n, max_level=max_level, alpha=alpha)
    eng = CkksEngine(params, seed=1)
    out[f"{tag}_tables_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    eng.keygen()
    out[f"{tag}_keygen_s"] = round(time.perf_counter() - t0, 1)

    scale = 2.0**29
    m = np.zeros(n, dtype=np.int64)
    m[0] = int(7 * scale)
    t0 = time.perf_counter()
    ct1 = eng.encrypt_ints(m, level, scale)
    ct2 = eng.encrypt_ints(m, level, scale)
    out[f"{tag}_encrypt2_s"] = round(time.perf_counter() - t0, 1)

    res = eng.hmult(ct1, ct2)
    dec = eng.decrypt_bigint(res, count=1)
    out[f"{tag}_correct"] = bool(abs(dec[0] / res.scale - 49.0) < 0.01)
    out[f"{tag}_hmult_ms"] = round(
        1e3 * benchlib.hmult_seconds(eng, ct1, ct2), 3)
    out[f"{tag}_shape"] = f"L={max_level} l={level} alpha={alpha} " \
                          f"dnum={params.beta(max_level)}"


def main() -> int:
    import jax

    from homulator_tpu.runtime import enable_compile_cache

    enable_compile_cache()

    n = 65536
    out = {"backend": jax.default_backend()}
    L36, a36, l36, eff = parity36_shape(n, 45, 15, 35)
    out["eff_prime_bits"] = round(eff, 3)
    out["parity_shape"] = {"L": L36, "alpha": a36, "level": l36}
    run_one(n, 45, 35, 15, "native30", out)
    run_one(n, L36, l36, a36, "parity36", out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
