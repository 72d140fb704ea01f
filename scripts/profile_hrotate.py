"""Phase-level timing of hrotate(45, 35, 15) on the device.

The second headline op (reference micro24 sweeps both key-switch-bearing
ops). Phases, mirroring _hrotate_graph (api.py): the two automorphism
gathers, the key switch front (shared with hmult — see profile_hmult.py
for its internal anatomy), and the concat-free batched ModDown pair.
Same methodology as profile_hmult.py: shape-preserving chained device
loops, tables as jit arguments.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from homulator_tpu.api import CkksEngine, _hrotate_graph
from homulator_tpu.benchlib import time_chained
from homulator_tpu.ops.automorph import automorph_eval
from homulator_tpu.ops.keyswitch import (
    inner_product_pieces, moddown_pair2, modup_conv_all,
)
from homulator_tpu.params import get_params


@jax.jit
def chain_hrotate(a, perm, rotk, kt, iters):
    def body(_, carry):
        return _hrotate_graph(carry, perm, rotk, kt)
    return jax.lax.fori_loop(0, iters, body, a)


@jax.jit
def chain_auto2(a, perm, iters):
    """Both components' automorphism gathers (the AUTOU analog)."""
    def body(_, carry):
        return jnp.stack(
            [automorph_eval(carry[0], perm), automorph_eval(carry[1], perm)]
        )
    return jax.lax.fori_loop(0, iters, body, a)


@jax.jit
def chain_keyswitch(x, rotk, kt, iters):
    """ModUp + IP + batched ModDown pair: [35,N] -> [35,N]."""
    def body(_, carry):
        convs = modup_conv_all(carry, kt)
        acc0, acc1 = inner_product_pieces(convs, carry, rotk, kt)
        out = moddown_pair2(acc0, acc1, kt)
        return out[0]
    return jax.lax.fori_loop(0, iters, body, x)


@jax.jit
def chain_moddown2(acc_sp, acc_main, kt, iters):
    def body(_, carry):
        out = moddown_pair2((acc_sp, carry), (acc_sp, carry), kt)
        return out[0]
    return jax.lax.fori_loop(0, iters, body, acc_main)


def main():
    from homulator_tpu.runtime import enable_compile_cache

    enable_compile_cache()

    params = get_params(n=1 << 16, max_level=45, alpha=15)
    eng = CkksEngine(params, seed=1)
    eng.keygen()
    eng.gen_rotation_key(1)
    level = 35
    kt = eng.dc.keyswitch_tables(level)
    rotk = eng.rot_keys[1]
    perm = eng.dc.automorph_perm(params.galois_elt(1))

    rng = np.random.default_rng(0)
    m = np.zeros(params.n, dtype=np.int64)
    m[: params.n // 2] = rng.integers(-100, 100, size=params.n // 2)
    ct = eng.encrypt_ints(m, level, 2.0**29)
    a = ct.data
    x = a[1]

    convs = modup_conv_all(x, kt)
    acc0, _ = inner_product_pieces(convs, x, rotk, kt)
    acc_sp = jax.block_until_ready(acc0[0])
    acc_main = jax.block_until_ready(acc0[1])

    for name, fn, args, k2 in (
        ("hrotate (full)", chain_hrotate, (a, perm, rotk, kt), 28),
        ("automorph x2 (AUTOU)", chain_auto2, (a, perm), 200),
        ("keyswitch (modup+ip+moddown2)", chain_keyswitch, (x, rotk, kt), 32),
        ("moddown pair2 (both keys)", chain_moddown2,
         (acc_sp, acc_main, kt), 100),
    ):
        sec = time_chained(fn, 4, k2, *args)
        print(f"{name:32s} {sec * 1e3:8.3f} ms")


if __name__ == "__main__":
    main()
