"""Phase-level timing of hmult(45, 35, 15) on the device.

Each phase is timed as a shape-preserving chained device loop (see
benchlib): the loop body runs the phase and projects the result back to
the carry's shape so iterations are data-dependent. All tables are passed
as jit arguments (closure capture would inline them as constants).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from homulator_tpu.api import CkksEngine, hmult_graph
from homulator_tpu.benchlib import time_chained
from homulator_tpu.ops.keyswitch import moddown, modup_all, modup_digit
from homulator_tpu.ops.modmath import modadd, mont_mul, shoup_mul, to_mont
from homulator_tpu.ops.ntt import intt, ntt
from homulator_tpu.ops.rescale import rescale_poly
from homulator_tpu.params import get_params


@jax.jit
def chain_hmult(a, b, evk, kt, last_nt, out_nt, rs, iters):
    def body(_, carry):
        out = hmult_graph(carry, b, evk, kt, last_nt, out_nt, rs)
        return jnp.concatenate([out, carry[:, -1:]], axis=1)
    return jax.lax.fori_loop(0, iters, body, a)


@jax.jit
def chain_tensor(a, nt, iters):
    q, qi, r2 = nt.q[:, None, None], nt.qinv[:, None, None], nt.r2[:, None, None]

    def body(_, carry):
        a0m = to_mont(carry[0], r2, q, qi)
        a1m = to_mont(carry[1], r2, q, qi)
        d0 = mont_mul(carry[0], a0m, q, qi)
        d1 = modadd(mont_mul(carry[1], a0m, q, qi),
                    mont_mul(carry[0], a1m, q, qi), q)
        d2 = mont_mul(carry[1], a1m, q, qi)
        return jnp.stack([modadd(d0, d1, q), d2])

    return jax.lax.fori_loop(0, iters, body, a)


@jax.jit
def chain_intt_main(x, nt, iters):
    def body(_, carry):
        return intt(ntt(carry, nt), nt)
    return jax.lax.fori_loop(0, iters, body, x)


@jax.jit
def chain_modup_bconv(x, kt, iters):
    """Fused bconv kernels only (no NTTs): [35,N] -> [35,N]."""
    from homulator_tpu.ops.bconv_fused import bconv_fused
    L = x.shape[0]

    def body(_, carry):
        acc = None
        for d in range(len(kt.digits)):
            dt = kt.digits[d]
            conv = bconv_fused(
                carry[dt.lo:dt.hi], dt.step1_pl, dt.step1_sh,
                kt.main_nt.q[dt.lo:dt.hi], dt.mat_bf16, dt.horner_sh,
                dt.other_nt.q, center=True,
            )[-L:]
            acc = conv if acc is None else modadd(acc, conv, kt.main_nt.q[:, None, None])
        return acc

    return jax.lax.fori_loop(0, iters, body, x)


@jax.jit
def chain_ntt_ext(x, kt, iters):
    def body(_, carry):
        return intt(ntt(carry, kt.ext_nt), kt.ext_nt)
    return jax.lax.fori_loop(0, iters, body, x)


@jax.jit
def chain_ip(x, evk, kt, iters):
    from homulator_tpu.ops.modmath import lazy_sum_reduce, mont_mul_lazy

    ext_q = kt.ext_nt.q[:, None, None]
    ext_qi = kt.ext_nt.qinv[:, None, None]
    k_ext = x.shape[0]

    def body(_, carry):
        t0s, t1s = [], []
        for d in range(len(kt.digits)):
            t0s.append(mont_mul_lazy(carry, evk[d, 0, :k_ext], ext_q, ext_qi))
            t1s.append(mont_mul_lazy(carry, evk[d, 1, :k_ext], ext_q, ext_qi))
        return modadd(
            lazy_sum_reduce(t0s, ext_q), lazy_sum_reduce(t1s, ext_q), ext_q
        )

    return jax.lax.fori_loop(0, iters, body, x)


@jax.jit
def chain_moddown(x, kt, iters):
    def body(_, carry):
        low = moddown(carry, kt)
        return jnp.concatenate([carry[: x.shape[0] - low.shape[0]], low])
    return jax.lax.fori_loop(0, iters, body, x)


@jax.jit
def chain_tail(x, d, kt, iters):
    """Fused moddown+rescale: [50,N],[35,N] -> re-padded [50,N]."""
    from homulator_tpu.ops.keyswitch import moddown_rescale

    alpha = kt.special_nt.q.shape[0]

    def body(_, carry):
        low = moddown_rescale((carry[:alpha], carry[alpha:]), d, kt)  # [34, N]
        return jnp.concatenate([carry[: x.shape[0] - low.shape[0]], low])
    return jax.lax.fori_loop(0, iters, body, x)


@jax.jit
def chain_ntt_m(x, nt, iters):
    def body(_, carry):
        return intt(ntt(carry, nt), nt)
    return jax.lax.fori_loop(0, iters, body, x)


@jax.jit
def chain_ksw_tail(x, evk, kt, iters):
    """Full keyswitch incl. fused tails: [35,N] -> [35,N] (pad w/ last)."""
    from homulator_tpu.ops.keyswitch import (
        inner_product_pieces, moddown_rescale, modup_conv_all,
    )

    def body(_, carry):
        convs = modup_conv_all(carry, kt)
        acc0, acc1 = inner_product_pieces(convs, carry, evk, kt)
        r0 = moddown_rescale(acc0, carry, kt)
        r1 = moddown_rescale(acc1, carry, kt)
        out = modadd(r0, r1, kt.main_nt.q[: r0.shape[0], None, None])
        return jnp.concatenate([out, carry[-1:]], axis=0)
    return jax.lax.fori_loop(0, iters, body, x)


@jax.jit
def chain_rescale(x, last_nt, out_nt, rs, iters):
    def body(_, carry):
        r = rescale_poly(carry, last_nt, out_nt, rs)
        return jnp.concatenate([r, carry[-1:]])
    return jax.lax.fori_loop(0, iters, body, x)


@jax.jit
def chain_modup_all(x, kt, iters):
    def body(_, carry):
        digs = modup_all(ntt(carry, kt.main_nt), kt)
        acc = None
        for dg in digs:
            c = intt(dg, kt.ext_nt)[kt.special_nt.q.shape[0]:]
            acc = c if acc is None else modadd(acc, c, kt.main_nt.q[:, None, None])
        return acc
    return jax.lax.fori_loop(0, iters, body, x)


def main():
    from homulator_tpu.runtime import enable_compile_cache, require_gpu

    require_gpu()
    enable_compile_cache()
    params = get_params(n=1 << 16, max_level=45, alpha=15)
    eng = CkksEngine(params, seed=1)
    eng.keygen()
    level = 35
    dc = eng.dc
    kt = dc.keyswitch_tables(level)
    last_nt = dc.ntt_basis((level - 1,))
    out_nt = dc.ntt_basis(dc.main_rows(level - 1))
    rs = dc.rescale_qinv_mont(level)
    evk = eng.relin_key

    rng = np.random.default_rng(0)
    m = np.zeros(params.n, dtype=np.int64)
    m[: params.n // 2] = rng.integers(-100, 100, size=params.n // 2)
    ct = eng.encrypt_ints(m, level, 2.0**29)
    a = ct.data  # [2, 35, N]

    x35 = a[0]
    x50 = jnp.concatenate([a[0][:15], a[0]], axis=0)

    rows = []

    def run(name, fn, *args, k1=4, k2=20, reps=3):
        # Scale iterations so device time dominates dispatch noise: first
        # a cheap estimate, then k2 sized for >=100ms of device time.
        t0 = time_chained(fn, k1, k2, *args)
        if t0 * (k2 - k1) < 0.1:
            k2b = k1 + max(int(0.1 / max(t0, 1e-6)), k2 - k1)
            k2b = min(k2b, 400)
        else:
            k2b = k2
        ts = sorted(time_chained(fn, k1, k2b, *args) for _ in range(reps))
        t = ts[0]
        rows.append((name, t * 1e3))
        print(f"{name:28s} {t * 1e3:8.3f} ms   (k2={k2b})")

    run("hmult (full)", chain_hmult, a, a, evk, kt, last_nt, out_nt, rs)
    run("tensor EWE", chain_tensor, a, kt.main_nt)
    run("ntt+intt main(35)", chain_intt_main, x35, kt.main_nt)
    run("modup bconv x3 (no NTT)", chain_modup_bconv, x35, kt)
    run("ntt+intt ext(50) x1", chain_ntt_ext, x50, kt)
    run("inner product (3d x 2k)", chain_ip, x50, evk, kt)
    run("moddown (x1)", chain_moddown, x50, kt)
    run("tail fused md+rs (x1)", chain_tail, x50, x35, kt)
    run("rescale (x1)", chain_rescale, x35, last_nt, out_nt, rs)
    run("modup_all (full)", chain_modup_all, x35, kt)
    for m in (1, 8, 35):
        nt_m = dc.ntt_basis(tuple(range(m)))
        run(f"ntt+intt M={m}", chain_ntt_m, a[0][:m], nt_m)
    run("keyswitch+2tails", chain_ksw_tail, x35, evk, kt)

    d = dict(rows)
    est = (d["tensor EWE"] + d["modup_all (full)"]
           + d["inner product (3d x 2k)"] + 2 * d["moddown (x1)"]
           + 2 * d["rescale (x1)"])
    print("\nModel: hmult ≈ tensor + modup_all + ip + 2*moddown + 2*rescale")
    print(f"sum of parts ≈ {est:.3f} ms vs full {d['hmult (full)']:.3f} ms")
    print("(modup_all chain includes an extra intt(50)x3 + ntt(35); "
          "subtract ~3.5 ext-intt-limbs worth when reading it)")


if __name__ == "__main__":
    main()
