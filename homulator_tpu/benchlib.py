"""Benchmark measurement helpers.

Per-dispatch wall times mix host dispatch and device work, so ops can be
timed as a *device-side chained loop*: one jitted program runs the op body
k times with a data dependency between iterations (lax.fori_loop), and the
difference quotient (T(k2) - T(k1)) / (k2 - k1) cancels dispatch overhead
and any constant costs. Completion is forced by fetching a tiny slice.
"""

from __future__ import annotations

import functools
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .api import (
    _hadd_graph, _hrotate_graph, _padd_graph, _pmult_graph, hmult_graph,
)
from .ops.keyswitch import keyswitch
from .ops.ntt import intt, ntt


@jax.jit
def _chained_hmult(a, b, evk, kt, last_nt, out_nt, rs, iters):
    """Runs the full hmult body `iters` times (dynamic trip count — ONE
    compiled program serves every k); each iteration's output is
    re-extended to the input level (pad with the dropped limb of `a`) and
    fed back, forcing sequential device execution."""
    def body(_, carry):
        out = hmult_graph(carry, b, evk, kt, last_nt, out_nt, rs)
        return jnp.concatenate([out, carry[:, -1:]], axis=1)

    return jax.lax.fori_loop(0, iters, body, a)


@jax.jit
def _chained_hadd(a, b, q, iters):
    def body(_, carry):
        return _hadd_graph(carry, b, q)

    return jax.lax.fori_loop(0, iters, body, a)


@jax.jit
def _chained_padd(a, pt, q, iters):
    def body(_, carry):
        return _padd_graph(carry, pt, q)

    return jax.lax.fori_loop(0, iters, body, a)


@jax.jit
def _chained_pmult(a, pt, q, qinv, r2, iters):
    def body(_, carry):
        return _pmult_graph(carry, pt, q, qinv, r2)

    return jax.lax.fori_loop(0, iters, body, a)


@jax.jit
def _chained_hrotate(a, perm, rotk, kt, iters):
    """hrotate keeps the level, so the output feeds back directly."""
    def body(_, carry):
        return _hrotate_graph(carry, perm, rotk, kt)

    return jax.lax.fori_loop(0, iters, body, a)


@jax.jit
def _chained_ntt(x, nb, iters):
    """iters rounds of NTT∘iNTT over eval-domain tiles [M, n2, n1]."""
    def body(_, carry):
        return ntt(intt(carry, nb), nb)

    return jax.lax.fori_loop(0, iters, body, x)


def _force(x) -> None:
    np.asarray(jax.device_get(x.ravel()[:8]))


def _min_time(fn, args, k: int, reps: int) -> float:
    """MIN wall time over `reps` calls of fn(*args, k). The host adds
    additive noise spikes; min is the right estimator for each
    endpoint SEPARATELY (min of the difference is biased low — it picks the
    single most favorable noise draw and reads ~0 for cheap ops)."""
    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        _force(fn(*args, k))
        best = min(best, time.perf_counter() - t)
    return best


def time_chained(
    fn: Callable, k1: int, k2: int, *args, reps: int = 3,
    min_diff_s: float = 0.05, k2_cap: int = 50_000,
) -> float:
    """Seconds per iteration via difference quotient (dynamic trip counts:
    both k run the same compiled program, so growing k2 never recompiles).
    k2 is grown adaptively until the endpoint difference is well above the
    host noise floor (tens of ms), which the fixed chain lengths of
    cheap elementwise ops at small N would otherwise drown in."""
    _force(fn(*args, k1))  # warm / compile
    while True:
        t1 = _min_time(fn, args, k1, reps)
        t2 = _min_time(fn, args, k2, reps)
        diff = t2 - t1
        if diff >= min_diff_s or k2 >= k2_cap:
            return max(diff, 1e-9) / (k2 - k1)
        k2 = min(k2 * 4, k2_cap)


def hmult_seconds(eng, ct1, ct2, k1: int = 4, k2: int = 28) -> float:
    dc = eng.dc
    level = ct1.level
    kt = dc.keyswitch_tables(level)
    last_nt = dc.ntt_basis((level - 1,))
    out_nt = dc.ntt_basis(dc.main_rows(level - 1))
    rs = dc.rescale_qinv_mont(level)
    return time_chained(
        _chained_hmult, k1, k2, ct1.data, ct2.data, eng.relin_key,
        kt, last_nt, out_nt, rs,
    )


def ntt_pair_seconds(eng, x, level: int, k1: int = 4, k2: int = 150) -> float:
    """Seconds per (NTT + iNTT) over `level` limbs. x: eval tiles
    [level, n2, n1]."""
    nb = eng.dc.ntt_basis(eng.dc.main_rows(level))
    return time_chained(_chained_ntt, k1, k2, x, nb)


def hadd_seconds(eng, ct1, ct2, k1: int = 16, k2: int = 400) -> float:
    q, _, _ = eng.dc.q_level(ct1.level)
    return time_chained(_chained_hadd, k1, k2, ct1.data, ct2.data, q)


def padd_seconds(eng, ct, pt, k1: int = 16, k2: int = 400) -> float:
    q, _, _ = eng.dc.q_level(ct.level)
    return time_chained(_chained_padd, k1, k2, ct.data, pt.data, q)


def pmult_seconds(eng, ct, pt, k1: int = 16, k2: int = 400) -> float:
    q, qinv, r2 = eng.dc.q_level(ct.level)
    return time_chained(_chained_pmult, k1, k2, ct.data, pt.data, q, qinv, r2)


def hrotate_seconds(eng, ct, step: int = 1, k1: int = 4, k2: int = 28) -> float:
    if step not in eng.rot_keys:
        eng.gen_rotation_key(step)
    g = eng.params.galois_elt(step)
    perm = eng.dc.automorph_perm(g)
    kt = eng.dc.keyswitch_tables(ct.level)
    return time_chained(
        _chained_hrotate, k1, k2, ct.data, perm, eng.rot_keys[step], kt
    )
