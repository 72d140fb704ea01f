#!/usr/bin/env python
"""End-to-end encrypted-workload benchmark on the GPU: BSGS matvec.

The workload-level number the reference (a per-op cycle simulator) could
never produce: a d x d encrypted matrix-vector product — the standard
CKKS serving kernel (one dense layer under encryption) — compiled as ONE
XLA program at the canonical set-B parameters and timed as a chained
on-device loop (homulator_tpu/benchlib.py methodology).

Structure (examples/encrypted_matvec_bsgs.py, scaled up): diagonal method
with baby-step/giant-step, g = sqrt(d); the g-1 baby rotations share one
ModUp via Halevi-Shoup hoisting, each giant group pays one key switch:

    y = sum_j rot( sum_i pdiag_{g*j+i} * rot(x, i), g*j )

Decrypt-verified against the cleartext M @ x before timing. Appends one
JSON line to outLogs/workloads/matvec_bsgs.jsonl.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def main() -> int:
    import jax

    from homulator_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from homulator_tpu import benchlib
    from homulator_tpu.api import (
        CkksEngine, _hrotate_graph, _hrotate_hoisted_graph,
    )
    from homulator_tpu.ops.modmath import modadd, mont_mul, to_mont
    from homulator_tpu.params import get_params

    smoke = "--smoke" in sys.argv  # CPU harness check (tiny params)
    if smoke:
        jax.config.update("jax_platforms", "cpu")
        n, max_level, level, alpha = 256, 8, 6, 4
        d, g = 16, 4
        scale = 2.0**26
    else:
        n, max_level, level, alpha = 65536, 45, 35, 15
        d, g = 64, 8
        scale = 2.0**29
    params = get_params(n=n, max_level=max_level, alpha=alpha)
    eng = CkksEngine(params, seed=7)
    eng.keygen()
    slots = n // 2

    rng = np.random.default_rng(7)
    M = rng.normal(size=(d, d)) / d
    x = rng.normal(size=d)
    x_slots = np.tile(x, slots // d)
    ct_x = eng.encrypt_complex(x_slots, level, scale)

    # Rotation keys: baby steps 1..g-1 (hoisted, one ModUp) and giant
    # steps g*j.
    baby_steps = list(range(1, g))
    giant_steps = [g * j for j in range(1, d // g)]
    for s in baby_steps + giant_steps:
        eng.gen_rotation_key(s)
    kt = eng.dc.keyswitch_tables(level)
    baby_perms = tuple(eng.dc.automorph_perm(params.galois_elt(s))
                       for s in baby_steps)
    baby_rotks = tuple(eng.rot_keys[s] for s in baby_steps)
    giant_perms = tuple(eng.dc.automorph_perm(params.galois_elt(s))
                        for s in giant_steps)
    giant_rotks = tuple(eng.rot_keys[s] for s in giant_steps)

    # Pre-rotated diagonal plaintexts, stacked [d, level, n2, n1] and
    # pre-lifted to Montgomery form (public data, one-time host prep).
    t0 = time.perf_counter()
    pts = []
    for j in range(d // g):
        for i in range(g):
            k = g * j + i
            diag_k = np.array([M[t % d, (t + k) % d] for t in range(d)])
            pdiag = np.tile(np.roll(diag_k, g * j), slots // d)
            pts.append(eng.plaintext_complex(pdiag, level, scale).data)
    pt_stack = jnp.stack(pts)  # [d, level, n2, n1]
    q, qinv, r2 = eng.dc.q_level(level)
    q3, qi3, r23 = q[:, None, None], qinv[:, None, None], r2[:, None, None]
    pt_mont = jax.jit(lambda p: to_mont(p, r23[None], q3[None], qi3[None]))(
        pt_stack)
    prep_s = time.perf_counter() - t0

    # Stacked giant-group tables so the group loop compiles ONCE as a
    # lax.scan body (the fully-inlined graph of 8 key switches exceeded
    # the remote compile endpoint's patience).
    J = d // g
    giant_perm_stack = jnp.stack(giant_perms)            # [J-1, N]
    giant_rotk_stack = jnp.stack(giant_rotks)            # [J-1, ...]
    pt_groups = pt_mont.reshape(J, g, *pt_mont.shape[1:])

    def group_sum(pm_j, baby_stack):
        """sum_i pdiag_{g*j+i} * baby_i, both components: one batched
        Montgomery multiply over [g, 2, level, R, C] + a modadd tree."""
        t = mont_mul(baby_stack, pm_j[:, None], q3[None, None],
                     qi3[None, None])
        while t.shape[0] > 1:
            h = t.shape[0] // 2
            t = modadd(t[:h], t[h:], q3[None, None])
        return t[0]

    baby_perm_stack = jnp.stack(baby_perms)
    baby_rotk_stack = jnp.stack(baby_rotks)

    # lax.scan serializes the giant groups; a 2-wide
    # partially-unrolled body keeps program size bounded (one compiled
    # pair body, not J-1 inlined key switches) while giving XLA two
    # INDEPENDENT key-switch chains per step to overlap. Modular addition
    # is associative, so the reassociated accumulation is bit-identical.
    scan_width = 2 if "--scan-width=2" in sys.argv else 1

    def matvec(ct, ptg, bps, brs, gps, grs, kt):
        """The ENTIRE encrypted matvec as one traced graph (scan over
        giant groups). All large tables arrive as ARGUMENTS: captured jit
        constants (2+ GB of diagonals and stacked keys) are embedded in
        the serialized program and overwhelm the remote compile path."""
        rots = _hrotate_hoisted_graph(
            ct, tuple(bps[i] for i in range(g - 1)),
            tuple(brs[i] for i in range(g - 1)), kt)
        baby_stack = jnp.concatenate([ct[None], rots], axis=0)  # [g, ...]
        acc = group_sum(ptg[0], baby_stack)

        def group(pm_j, perm_j, rotk_j):
            return _hrotate_graph(group_sum(pm_j, baby_stack), perm_j,
                                  rotk_j, kt)

        ngrp = J - 1
        if scan_width == 1 or ngrp < 2:
            def body(acc, xs):
                return modadd(acc, group(*xs), q3[None]), 0.0

            acc, _ = jax.lax.scan(body, acc, (ptg[1:], gps, grs))
            return acc
        npairs = ngrp // 2

        def pair(t):
            return t[:2 * npairs].reshape(npairs, 2, *t.shape[1:])

        def body2(acc, xs):
            pm2, perm2, rotk2 = xs
            g0 = group(pm2[0], perm2[0], rotk2[0])
            g1 = group(pm2[1], perm2[1], rotk2[1])
            return modadd(acc, modadd(g0, g1, q3[None]), q3[None]), 0.0

        acc, _ = jax.lax.scan(
            body2, acc, (pair(ptg[1:]), pair(gps), pair(grs)))
        if ngrp % 2:
            acc = modadd(acc, group(ptg[-1], gps[-1], grs[-1]), q3[None])
        return acc

    # ---- one compiled program: verify at iters=1, then chained timing ---
    @jax.jit
    def chain(a, ptg, bps, brs, gps, grs, kt_, iters):
        def body(_, carry):
            return matvec(carry, ptg, bps, brs, gps, grs, kt_)
        return jax.lax.fori_loop(0, iters, body, a)

    from homulator_tpu.context import Ciphertext

    big = (pt_groups, baby_perm_stack, baby_rotk_stack,
           giant_perm_stack, giant_rotk_stack, kt)
    t0 = time.perf_counter()
    out = chain(ct_x.data, *big, 1)
    out.block_until_ready()
    compile_s = time.perf_counter() - t0
    y = eng.decrypt_complex(
        Ciphertext(out, level, scale * scale)).real[:d]
    err = float(np.max(np.abs(y - M @ x)))
    print(f"# verify max-abs-err = {err:.3e}", flush=True)
    assert err < 1e-2, err

    if smoke:
        print("# smoke OK (verify passed; no artifact written)")
        return 0
    sec = benchlib.time_chained(chain, 2, 10, ct_x.data, *big)
    rec = {
        "workload": "matvec_bsgs", "n": n, "max_level": max_level,
        "level": level, "alpha": alpha, "d": d, "g": g,
        "scan_width": scan_width,
        "e2e_ms": round(1e3 * sec, 3),
        "keyswitches": len(baby_steps) + len(giant_steps),
        "hoisted_modups": 1, "pmults": d,
        "verify_err": err, "compile_s": round(compile_s, 1),
        "host_prep_s": round(prep_s, 1),
        "backend": jax.default_backend(),
    }
    os.makedirs(os.path.join(ROOT, "outLogs", "workloads"), exist_ok=True)
    with open(os.path.join(ROOT, "outLogs", "workloads",
                           "matvec_bsgs.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
