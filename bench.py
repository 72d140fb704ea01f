#!/usr/bin/env python
"""Headline benchmark: the reference's canonical workload — hmult at
N=2^16, maxLevel=45, level=35, alpha=15 (README.md:32-35:
`./Homulator.run ./config/config_4.cfg hmult 45 35 15`) — plus hrotate,
run for real on the GPU. Prints ONE JSON line:

  {"metric": "...", "value": <hmult ms>, "unit": "ms", "correct": ...,
   "hrotate_latency_ms": ..., "device": {"platform", "kind", "count"}, ...}

Latency is the median wall time of warmed-up calls through CkksEngine,
each ending in block_until_ready. `correct` requires the full-slot
decryption of the timed hmult within the CLI's 1e-2 gate. Refuses to run
without a GPU (JAX falls back to the CPU silently when its CUDA plugin
fails to load).
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def _median_ms(fn, n: int) -> float:
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        fn().data.block_until_ready()
        ts.append(1e3 * (time.perf_counter() - t))
    return sorted(ts)[n // 2]


def main() -> int:
    from homulator_tpu.runtime import enable_compile_cache, require_gpu

    dev = require_gpu()
    enable_compile_cache()
    import jax

    from homulator_tpu.api import CkksEngine
    from homulator_tpu.params import get_params

    n, max_level, level, alpha = 65536, 45, 35, 15
    t0 = time.perf_counter()
    params = get_params(n=n, max_level=max_level, alpha=alpha)
    eng = CkksEngine(params, seed=1)
    eng.keygen()
    setup_s = time.perf_counter() - t0  # host keygen + library builds

    scale = float(1 << 29)
    rng = np.random.default_rng(7)
    v1 = rng.normal(size=n // 2)
    v2 = rng.normal(size=n // 2)
    ct1 = eng.encrypt_complex(v1, level, scale)
    ct2 = eng.encrypt_complex(v2, level, scale)

    t0 = time.perf_counter()
    out = eng.hmult(ct1, ct2)
    out.data.block_until_ready()
    eng.hrotate(ct1, 1).data.block_until_ready()
    compile_s = time.perf_counter() - t0
    verify_err = float(np.max(np.abs(eng.decrypt_complex(out) - v1 * v2)))
    ok = verify_err < 1e-2

    hmult_ms = _median_ms(lambda: eng.hmult(ct1, ct2), 20)
    hrotate_ms = _median_ms(lambda: eng.hrotate(ct1, 1), 20)

    print(json.dumps({
        "metric": "hmult_latency_N2^16_L45_l35_a15",
        "value": hmult_ms,
        "unit": "ms",
        "correct": bool(ok),
        "verify_max_err": verify_err,
        "hrotate_latency_ms": hrotate_ms,
        "ntt_leaf": eng.dc.ntt_mode,
        "setup_s": setup_s,
        "compile_s": compile_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
