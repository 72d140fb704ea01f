#!/usr/bin/env python
"""Automorphism kernel bake-off at N=2^16 on the attached chip
(SURVEY.md §7 step 5: gather vs one-hot matmul vs staged permutation).

Candidates, all bit-identical (asserted before timing):
  flat    — one jnp.take over the flattened 65536-wide slot axis
            (ops/automorph.automorph_eval, the round-1 kernel)
  staged  — 3-stage routing-network form: sublane gather, lane gather,
            sublane gather via take_along_axis (ops/perm_decomp.py)
  onehot  — the staged form with the two sublane-gather stages realized
            as one-hot bf16-plane einsums on the MXU (exact: one-hot
            selects a single 8-bit plane value). The FLAT one-hot matmul
            the survey hypothesized is a [65536, 65536] matrix — 8.6 GB
            in bf16 and ~34 GB of HBM reads per limb: ruled out by
            arithmetic, measured here in its only realizable (staged)
            form.

Timing: chained device loops (benchlib.time_chained) over the hrotate
workload shape [2*level, n2, n1] at set B (level 35). Also times hrotate
end-to-end with the winning kernel.
"""

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
    from homulator_tpu.api import CkksEngine
    from homulator_tpu.ops.automorph import automorph_eval, automorph_eval_staged
    from homulator_tpu.params import get_params

    n, max_level, level, alpha = 65536, 45, 35, 15
    params = get_params(n=n, max_level=max_level, alpha=alpha)
    eng = CkksEngine(params, seed=1)
    eng.keygen()
    g = params.galois_elt(1)
    perm = eng.dc.automorph_perm(g)
    s1, s2, s3 = eng.dc.automorph_stage_maps(g)

    rng = np.random.default_rng(0)
    M = 2 * level
    t = params.ntt
    x = jnp.asarray(
        rng.integers(0, 1 << 30, size=(M, t.n2, t.n1), dtype=np.uint64
                     ).astype(np.uint32))

    # one-hot bf16-plane stage tables (sublane stages only; the lane stage
    # stays a gather — a per-row-distinct one-hot lane matmul is the same
    # batched structure again).
    oh1 = jnp.asarray(
        (np.asarray(s1)[:, None, :] == np.arange(t.n2)[None, :, None])
        .astype(np.float32)).astype(jnp.bfloat16)  # [r_out, s, c]
    oh3 = jnp.asarray(
        (np.asarray(s3)[:, None, :] == np.arange(t.n2)[None, :, None])
        .astype(np.float32)).astype(jnp.bfloat16)

    def _onehot_sub(y, oh):
        # y: [M, R, C] uint32 -> planes [4, M, R, C] bf16; per column c:
        # out[m, r, c] = sum_s oh[r, s, c] * y[m, s, c]; exact per plane.
        planes = jnp.stack(
            [((y >> (8 * k)) & 0xFF).astype(jnp.int32).astype(jnp.bfloat16)
             for k in range(4)])
        d = jnp.einsum("rsc,pmsc->pmrc", oh, planes,
                       preferred_element_type=jnp.float32)
        d = d.astype(jnp.int32).astype(jnp.uint32)
        return (d[0] | (d[1] << 8) | (d[2] << 16) | (d[3] << 24))

    def onehot_auto(y):
        t1 = _onehot_sub(y, oh1)
        t2 = jnp.take_along_axis(t1, s2[None], axis=-1)
        return _onehot_sub(t2, oh3)

    import functools

    @jax.jit
    def chain_flat(y, perm, iters):
        def body(_, c):
            return automorph_eval(c, perm)
        return jax.lax.fori_loop(0, iters, body, y)

    @jax.jit
    def chain_staged(y, s1, s2, s3, iters):
        def body(_, c):
            return automorph_eval_staged(c, s1, s2, s3)
        return jax.lax.fori_loop(0, iters, body, y)

    @jax.jit
    def chain_onehot(y, iters):
        def body(_, c):
            return onehot_auto(c)
        return jax.lax.fori_loop(0, iters, body, y)

    # correctness first
    ref = np.asarray(automorph_eval(x, perm))
    assert np.array_equal(np.asarray(automorph_eval_staged(x, s1, s2, s3)), ref), \
        "staged != flat"
    assert np.array_equal(np.asarray(onehot_auto(x)), ref), "onehot != flat"
    print("# all candidates bit-identical on [70, 256, 256]")

    res = {}
    res["flat_ms"] = 1e3 * benchlib.time_chained(chain_flat, 4, 64, x, perm)
    res["staged_ms"] = 1e3 * benchlib.time_chained(
        chain_staged, 4, 64, x, s1, s2, s3)
    res["onehot_ms"] = 1e3 * benchlib.time_chained(chain_onehot, 4, 32, x)
    for k, v in res.items():
        print(f"{k:12s} {v:8.3f} ms per sigma_g on [70, 256, 256]")

    # end-to-end hrotate with the current kernel
    scale = 2.0**29
    m = np.zeros(n, dtype=np.int64)
    m[0] = int(3 * scale)
    ct = eng.encrypt_ints(m, level, scale)
    hr = benchlib.hrotate_seconds(eng, ct, 1)
    print(f"hrotate(45,35,15) end-to-end: {1e3 * hr:.3f} ms")
    import json
    print(json.dumps({"automorph_bakeoff": res, "hrotate_ms": 1e3 * hr}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
