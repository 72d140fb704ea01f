#!/usr/bin/env python
"""Example: encrypted dot product <x, w> with rotation-based slot summation.

Demonstrates the full API: keygen, slot encoding, pmult, hoisted rotations
for the log-depth sum tree, decrypt. Works on CPU (small N) or a GPU (JAX_PLATFORMS=cuda).

    python examples/encrypted_dot_product.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    # Small-N demo: CPU unless JAX_PLATFORMS names a backend (e.g. cuda).
    if not os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", "cpu")

    from homulator_tpu.api import CkksEngine
    from homulator_tpu.params import get_params

    params = get_params(n=256, max_level=8, alpha=4)
    eng = CkksEngine(params)
    eng.keygen()

    slots = params.n // 2
    scale = 2.0**29
    rng = np.random.default_rng(0)
    x = rng.normal(size=slots)
    w = rng.normal(size=slots)

    ct = eng.encrypt_complex(x, level=8, scale=scale)
    pt_w = eng.plaintext_complex(w, level=8, scale=scale)

    # slotwise product, then rotate-and-add log2(slots) times to sum.
    prod = eng.rescale(eng.pmult(ct, pt_w))
    acc = prod
    step = 1
    while step < slots:
        acc = eng.hadd(acc, eng.hrotate(acc, step))
        step *= 2

    got = eng.decrypt_complex(acc)[0].real
    expected = float(np.dot(x, w))
    print(f"encrypted <x, w> = {got:.6f}   plaintext = {expected:.6f}   "
          f"err = {abs(got - expected):.2e}")
    print()
    eng.stats.show()
    assert abs(got - expected) < 1e-2


if __name__ == "__main__":
    main()
