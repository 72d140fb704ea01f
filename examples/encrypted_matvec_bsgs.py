#!/usr/bin/env python
"""Example: encrypted matrix-vector product y = M @ x, diagonal method
with baby-step/giant-step (BSGS) rotation structure.

The standard CKKS serving kernel (one dense layer under encryption): M is
a public d x d matrix, x arrives encrypted in the slots. The diagonal
method writes

    y = sum_{k=0}^{d-1} diag_k(M) * rot(x, k)

and BSGS factors k = g*j + i (g = sqrt(d)) so only the g baby rotations
of x plus one giant rotation per group are key-switched:

    y = sum_j rot( sum_i pdiag_{g*j+i} * rot(x, i), g*j )

with the inner-group diagonals pre-rotated by -g*j in the clear. The g
baby rotations share one ModUp via the hoisted-rotation API
(CkksEngine.hrotate_hoisted) — d=16 costs 4 hoisted + 3 giant key
switches instead of 15 plain rotations.

Runs on the CPU unless JAX_PLATFORMS names a backend (e.g. cuda).

    python examples/encrypted_matvec_bsgs.py
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

    params = get_params(n=256, max_level=8, alpha=4)
    eng = CkksEngine(params)
    eng.keygen()

    slots = params.n // 2  # 128
    d = 16                 # matrix dim; d | slots so diagonals wrap cleanly
    g = 4                  # giant step = sqrt(d)
    level, scale = 6, 2.0**26

    rng = np.random.default_rng(3)
    M = rng.normal(size=(d, d)) / d
    x = rng.normal(size=d)

    # Pack x into the slots d-periodically so slot rotation by k realises
    # the length-d cyclic rotation of x in every copy.
    x_slots = np.tile(x, slots // d)
    ct_x = eng.encrypt_complex(x_slots, level, scale)

    # Baby steps: rot(x, 1..g-1) sharing one ModUp (hoisted).
    baby = {0: ct_x}
    steps = list(range(1, g))
    for s, ct in zip(steps, eng.hrotate_hoisted(ct_x, steps)):
        baby[s] = ct

    # Giant groups: inner sums in the clear-rotated diagonal basis.
    acc = None
    for j in range(d // g):
        group = None
        for i in range(g):
            k = g * j + i
            diag_k = np.array([M[t % d, (t + k) % d] for t in range(d)])
            # pre-rotate by -g*j so one giant rotation finishes the group
            pdiag = np.tile(np.roll(diag_k, g * j), slots // d)
            pt = eng.plaintext_complex(pdiag, level, scale)
            term = eng.pmult(baby[i], pt)
            group = term if group is None else eng.hadd(group, term)
        if g * j != 0:
            group = eng.hrotate(group, g * j)
        acc = group if acc is None else eng.hadd(acc, group)

    y = eng.decrypt_complex(acc).real[:d]
    y_ref = M @ x
    err = np.max(np.abs(y - y_ref))
    print("y (encrypted) :", np.round(y, 4))
    print("y (reference) :", np.round(y_ref, 4))
    print(f"max abs error : {err:.3e}")
    assert err < 1e-2, err
    print("OK")


if __name__ == "__main__":
    main()
