#!/usr/bin/env python
"""Example: encrypted logistic-regression inference, end to end.

score = <x, w> + b computed under encryption (slotwise pmult +
rotate-and-add summation), then sigmoid approximated by the standard
degree-3 CKKS polynomial

    sigmoid(t) ~ 0.5 + 0.197 t - 0.004 t^3      (|t| <~ 6)

evaluated homomorphically with hsquare/hmult/cmult/cadd — exercising the
full op set including level descent and scale management (every mult is
followed by the rescale its consumer needs; align_levels reconciles the
two polynomial branches).

Runs on the CPU unless JAX_PLATFORMS names a backend (e.g. cuda).

    python examples/encrypted_logreg.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    if not os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", "cpu")

    from homulator_tpu.api import CkksEngine
    from homulator_tpu.params import get_params

    params = get_params(n=256, max_level=10, alpha=5)
    eng = CkksEngine(params)
    eng.keygen()

    slots = params.n // 2
    # The scale must track the prime size (2^scale_bits = 2^29): after a
    # rescale the working scale becomes s^2/q, and the two sigmoid
    # branches (t at one level, t^3 two rescales deeper) only carry
    # MATCHING scales when s ~ q. A smaller s (an earlier revision used
    # 2^26) silently mis-scales the cubic branch by (q/s)^2 ~ 2^12 —
    # align_levels aligns LEVELS, not scales.
    level, scale = 8, 2.0**29
    rng = np.random.default_rng(7)
    # A small "model": weights scaled so |score| stays in the poly's range.
    x = rng.normal(size=slots)
    w = rng.normal(size=slots) / np.sqrt(slots)
    b = 0.3

    ct_x = eng.encrypt_complex(x, level, scale)
    pt_w = eng.plaintext_complex(w, level, scale)

    # ---- score = <x, w> + b (every slot ends up holding the full sum) --
    prod = eng.rescale(eng.pmult(ct_x, pt_w))
    acc = prod
    step = 1
    while step < slots:
        acc = eng.hadd(acc, eng.hrotate(acc, step))
        step *= 2
    t = eng.cadd(acc, b)

    # ---- sigmoid(t) ~ 0.5 + 0.197 t - 0.004 t^3 ------------------------
    t2 = eng.hsquare(t)                      # level-1, scale^2 rescaled
    t3 = eng.hmult(eng.mod_drop(t, 1), t2)   # align t to t2's level first
    lin = eng.cmult(t, 0.197)                # 0.197 t
    cub = eng.cmult(t3, -0.004)              # -0.004 t^3
    lin, cub = eng.align_levels(lin, cub)
    y = eng.cadd(eng.hadd(lin, cub), 0.5)

    got = eng.decrypt_complex(y)[0].real
    score = float(np.dot(x, w) + b)
    expected = 0.5 + 0.197 * score - 0.004 * score**3
    true_sig = 1.0 / (1.0 + np.exp(-score))
    print(f"score (clear)          : {score:.6f}")
    print(f"encrypted sigmoid      : {got:.6f}")
    print(f"poly reference (clear) : {expected:.6f}")
    print(f"true sigmoid           : {true_sig:.6f}")
    err = abs(got - expected)
    print(f"encrypted-vs-poly err  : {err:.2e}")
    assert err < 1e-2, err
    print("OK")


if __name__ == "__main__":
    main()
