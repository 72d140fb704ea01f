"""Public operation API: hmult / hadd / hrotate / pmult / padd (+ keyswitch,
rescale, ntt) — the same operation surface the reference exposes through its
Operation layer (include/Operation.h:178-321), as jitted JAX graphs.

Where the reference builds per-op instruction DAGs and dispatches them to a
simulated machine (InsGen/Driver), here each operation is ONE traced XLA
program: the instruction stream dissolves into the jit graph, hazard logic
into SSA dataflow, and the Driver's cluster scheduling into XLA/sharding
(SURVEY.md §2 "Driver ... the scheduler layer becomes XLA").
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .context import COEFF, EVAL, Ciphertext, DeviceContext, Plaintext
from .ops.automorph import automorph_eval
from .ops.keyswitch import (
    inner_product_moddown, inner_product_pieces, keyswitch,
    keyswitch_pieces, moddown_pair, moddown_pair2, moddown_rescale,
    moddown_rescale2, modup_all, modup_conv_all,
)
from .ops.modmath import modadd, modsub, mont_mul, to_mont
from .ops.ntt import intt, ntt
from .ops.rescale import rescale_poly
from .params import CkksParams
from .refimpl import RefCkks, RefPlaintext
from .stats import Statistic, op_modmul_count


# --------------------------------------------------------------------------
# jitted op graphs (module level so the jit cache is shared across engines)
# --------------------------------------------------------------------------
@jax.jit
def _hadd_graph(a, b, q):
    return modadd(a, b, q[None, :, None, None])


@jax.jit
def _hsub_graph(a, b, q):
    return modsub(a, b, q[None, :, None, None])


@jax.jit
def _padd_graph(a, pt, q):
    c0 = modadd(a[0], pt, q[:, None, None])
    return jnp.stack([c0, a[1]])


@jax.jit
def _pmult_graph(a, pt, q, qinv, r2):
    q2, qi2, r22 = q[:, None, None], qinv[:, None, None], r2[:, None, None]
    ptm = to_mont(pt, r22, q2, qi2)
    return jnp.stack([mont_mul(a[0], ptm, q2, qi2), mont_mul(a[1], ptm, q2, qi2)])


def _keyswitch_rescale_tail(d0, d1, d2, evk_mont, kt, last_nt, out_nt,
                            rs_qinv_mont):
    """KeySwitch(d2) -> relinearize add -> 2x Rescale. On the piecewise
    pipeline the ModDown + add + Rescale of each component run as ONE fused
    division by P*q_last (ops/keyswitch.moddown_rescale — bit-identical)."""
    q = kt.main_nt.q[:, None, None]
    if kt.tail is not None and kt.main_nt.shard_axis is None:
        convs = modup_conv_all(d2, kt)
        acc0, acc1 = inner_product_pieces(convs, d2, evk_mont, kt)
        # Both tails batched: one rep=2 transform per NTT stage and one
        # batched elementwise chain (ops/keyswitch.moddown_rescale2).
        return moddown_rescale2(acc0, acc1, d0, d1, kt)
    if kt.tail is not None:
        convs = modup_conv_all(d2, kt)
        acc0, acc1 = inner_product_pieces(convs, d2, evk_mont, kt)
        r0 = moddown_rescale(acc0, d0, kt)
        r1 = moddown_rescale(acc1, d1, kt)
        return jnp.stack([r0, r1])
    ext_digits = modup_all(d2, kt)
    e0, e1 = inner_product_moddown(ext_digits, evk_mont, kt)
    c0 = modadd(d0, e0, q)
    c1 = modadd(d1, e1, q)
    r0 = rescale_poly(c0, last_nt, out_nt, rs_qinv_mont)
    r1 = rescale_poly(c1, last_nt, out_nt, rs_qinv_mont)
    return jnp.stack([r0, r1])


def hmult_graph(a, b, evk_mont, kt, last_nt, out_nt, rs_qinv_mont):
    """TensorCompute -> KeySwitch(d2) -> relinearize add -> 2x Rescale
    (mirrors HMULT's program, src/Operation.cpp:913-1112)."""
    main = kt.main_nt
    q, qi, r2 = main.q[:, None, None], main.qinv[:, None, None], main.r2[:, None, None]
    a0m = to_mont(a[0], r2, q, qi)
    a1m = to_mont(a[1], r2, q, qi)
    d0 = mont_mul(b[0], a0m, q, qi)
    d1 = modadd(mont_mul(b[1], a0m, q, qi), mont_mul(b[0], a1m, q, qi), q)
    d2 = mont_mul(b[1], a1m, q, qi)
    return _keyswitch_rescale_tail(
        d0, d1, d2, evk_mont, kt, last_nt, out_nt, rs_qinv_mont
    )


_hmult_graph = jax.jit(hmult_graph)


@jax.jit
def _hrotate_graph(a, perm, rotk_mont, kt):
    """AUTO(c0), AUTO(c1) -> KeySwitch(sigma(c1)) -> add
    (mirrors HROTATE, src/Operation.cpp:1271-1451)."""
    main = kt.main_nt
    q = main.q[:, None, None]
    r0 = automorph_eval(a[0], perm)
    r1 = automorph_eval(a[1], perm)
    if main.piecewise:
        # Piecewise pipeline: own digit rows pass through without
        # the concat/iNTT/NTT round trip, and ModDown never materializes
        # the [alpha+level, N] accumulator.
        e0, e1 = keyswitch_pieces(r1, rotk_mont, kt)
    else:
        e0, e1 = keyswitch(r1, rotk_mont, kt)
    return jnp.stack([modadd(r0, e0, q), e1])


@jax.jit
def _hsquare_graph(a, evk_mont, kt, last_nt, out_nt, rs_qinv_mont):
    """Squaring: d0 = c0^2, d1 = 2*c0*c1, d2 = c1^2 (one fewer tensor
    multiply than hmult), then the same keyswitch + rescale tail."""
    main = kt.main_nt
    q, qi, r2 = main.q[:, None, None], main.qinv[:, None, None], main.r2[:, None, None]
    a0m = to_mont(a[0], r2, q, qi)
    a1m = to_mont(a[1], r2, q, qi)
    d0 = mont_mul(a[0], a0m, q, qi)
    cross = mont_mul(a[1], a0m, q, qi)
    d1 = modadd(cross, cross, q)
    d2 = mont_mul(a[1], a1m, q, qi)
    return _keyswitch_rescale_tail(
        d0, d1, d2, evk_mont, kt, last_nt, out_nt, rs_qinv_mont
    )


@jax.jit
def _const_mul_graph(a, c_mont, q, qinv):
    return mont_mul(a, c_mont[None, :, None, None], q[None, :, None, None],
                    qinv[None, :, None, None])


@jax.jit
def _hrotate_hoisted_graph(a, perms, rotks, kt):
    """Many rotations of one ciphertext sharing a single ModUp
    (Halevi-Shoup hoisting; bit-identical to per-step hrotate because the
    automorphism commutes with the RNS digit decomposition)."""
    main = kt.main_nt
    q = main.q[:, None, None]
    outs = []
    if main.piecewise:
        # Piecewise hoisting: share one ModUp's conversion outputs; the
        # automorphism is applied per piece (it commutes row-wise).
        convs = modup_conv_all(a[1], kt)
        for perm, rotk in zip(perms, rotks):
            rot_convs = tuple(automorph_eval(c, perm) for c in convs)
            r1 = automorph_eval(a[1], perm)
            acc0, acc1 = inner_product_pieces(rot_convs, r1, rotk, kt)
            if main.shard_axis is None:
                # Both components' tails in one rep-2 batched pass (same
                # routing as keyswitch_pieces).
                e = moddown_pair2(acc0, acc1, kt)
                e0, e1 = e[0], e[1]
            else:
                e0 = moddown_pair(acc0, kt)
                e1 = moddown_pair(acc1, kt)
            r0 = automorph_eval(a[0], perm)
            outs.append(jnp.stack([modadd(r0, e0, q), e1]))
        return jnp.stack(outs)
    ext_digits = modup_all(a[1], kt)
    for perm, rotk in zip(perms, rotks):
        rot_digits = tuple(automorph_eval(dg, perm) for dg in ext_digits)
        e0, e1 = inner_product_moddown(rot_digits, rotk, kt)
        r0 = automorph_eval(a[0], perm)
        outs.append(jnp.stack([modadd(r0, e0, q), e1]))
    return jnp.stack(outs)


@jax.jit
def _hrotate_hoisted_scan_graph(a, perm_stack, rotk_stack, kt):
    """Hoisted rotations with the per-rotation tail as a lax.scan body:
    bit-identical to _hrotate_hoisted_graph on the piecewise pipeline, but
    the program size is CONSTANT in the rotation count (the inlined form
    grows one key switch per rotation, and compile time with it).
    perm_stack: int32[k, N];
    rotk_stack: [k, dnum, 2, K, R, C]."""
    main = kt.main_nt
    q = main.q[:, None, None]
    convs = modup_conv_all(a[1], kt)

    def body(carry, xs):
        perm, rotk = xs
        rot_convs = tuple(automorph_eval(c, perm) for c in convs)
        r1 = automorph_eval(a[1], perm)
        acc0, acc1 = inner_product_pieces(rot_convs, r1, rotk, kt)
        e = moddown_pair2(acc0, acc1, kt)
        r0 = automorph_eval(a[0], perm)
        return carry, jnp.stack([modadd(r0, e[0], q), e[1]])

    _, outs = jax.lax.scan(body, 0, (perm_stack, rotk_stack))
    return outs


@jax.jit
def _keyswitch_graph(d, evk_mont, kt):
    e0, e1 = keyswitch(d, evk_mont, kt)
    return jnp.stack([e0, e1])


@jax.jit
def _rescale_graph(a, last_nt, out_nt, rs_qinv_mont):
    r0 = rescale_poly(a[0], last_nt, out_nt, rs_qinv_mont)
    r1 = rescale_poly(a[1], last_nt, out_nt, rs_qinv_mont)
    return jnp.stack([r0, r1])


@jax.jit
def _ntt_graph(x, nb):
    return ntt(x, nb)


@jax.jit
def _intt_graph(x, nb):
    return intt(x, nb)


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------
class CkksEngine:
    """One CKKS context on the current JAX backend.

    Key generation / encryption / encoding run host-side through the exact
    reference engine (refimpl.RefCkks) and keys are uploaded in Montgomery
    form; all homomorphic operations run on device.
    """

    def __init__(self, params: CkksParams, seed: int = 0, ntt_mode: str = "auto"):
        self.params = params
        self.dc = DeviceContext(params, ntt_mode=ntt_mode)
        self.ref = RefCkks(params, seed)
        self.relin_key: Optional[jnp.ndarray] = None
        self.rot_keys: Dict[int, jnp.ndarray] = {}
        self._conj_keys: Dict[int, jnp.ndarray] = {}
        self._const_cache: Dict = {}
        # Metrics surface mirroring the reference's Statistic counters
        # (Staistics.h): op counts, modeled modmul work, HBM word traffic.
        self.stats = Statistic()

    def _count(self, op: str, level: int, components: int = 2) -> None:
        p = self.params
        self.stats.increase(f"op/{op}")
        try:
            self.stats.increase(
                "modmul_total",
                op_modmul_count(op, p.n, level, p.alpha, p.beta(level)),
            )
        except ValueError:
            pass
        # words in+out of HBM for the ciphertext operands/results (the
        # reference's MEM_(c) analog, mem.cpp:68-69).
        self.stats.increase("MEM_words", 3 * components * level * p.n)

    # ---- keys ------------------------------------------------------------
    def keygen(self) -> None:
        self.ref.keygen()
        self.relin_key = self.dc.upload_kskey_mont(self.ref.relin_key.digits)

    def gen_rotation_key(self, step: int) -> None:
        key = self.ref.gen_rotation_key(step)
        self.rot_keys[step] = self.dc.upload_kskey_mont(key.digits)

    # ---- io --------------------------------------------------------------
    def encrypt_ints(self, coeffs: np.ndarray, level: int, scale: float) -> Ciphertext:
        pt = self.ref.encode_ints(coeffs, level, scale)
        ct = self.ref.encrypt(pt)
        return self.dc.upload_ct(ct.data, level, scale)

    def plaintext_ints(self, coeffs: np.ndarray, level: int, scale: float) -> Plaintext:
        pt = self.ref.encode_ints(coeffs, level, scale)
        return self.dc.upload_pt(pt.data, level, scale)

    def encrypt_complex(self, values: np.ndarray, level: int, scale: float) -> Ciphertext:
        """Encrypt N/2 complex slots (canonical-embedding encode + encrypt)."""
        pt = self.ref.encode_complex(values, level, scale)
        ct = self.ref.encrypt(pt)
        return self.dc.upload_ct(ct.data, level, scale)

    def plaintext_complex(self, values: np.ndarray, level: int, scale: float) -> Plaintext:
        pt = self.ref.encode_complex(values, level, scale)
        return self.dc.upload_pt(pt.data, level, scale)

    def decrypt_complex(self, ct: Ciphertext) -> np.ndarray:
        from .refimpl import RefCiphertext

        data = self.dc.download(ct.data)
        return self.ref.decrypt_complex(
            RefCiphertext(data, ct.level, ct.scale, ct.domain)
        )

    def decrypt_bigint(self, ct: Ciphertext, count=None):
        from .refimpl import RefCiphertext

        data = self.dc.download(ct.data)
        return self.ref.decrypt_to_bigint(
            RefCiphertext(data, ct.level, ct.scale, ct.domain), count=count
        )

    # ---- ops -------------------------------------------------------------
    def hadd(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.level == b.level and a.domain == b.domain == EVAL
        self._count("hadd", a.level)
        q, _, _ = self.dc.q_level(a.level)
        return Ciphertext(_hadd_graph(a.data, b.data, q), a.level, a.scale)

    def hsub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.level == b.level
        self._count("hsub", a.level)
        q, _, _ = self.dc.q_level(a.level)
        return Ciphertext(_hsub_graph(a.data, b.data, q), a.level, a.scale)

    def padd(self, a: Ciphertext, pt: Plaintext) -> Ciphertext:
        assert a.level == pt.level
        self._count("padd", a.level)
        q, _, _ = self.dc.q_level(a.level)
        return Ciphertext(_padd_graph(a.data, pt.data, q), a.level, a.scale)

    def pmult(self, a: Ciphertext, pt: Plaintext) -> Ciphertext:
        assert a.level == pt.level
        l = a.level
        self._count("pmult", l)
        q, qinv, r2 = self.dc.q_level(l)
        out = _pmult_graph(a.data, pt.data, q, qinv, r2)
        return Ciphertext(out, l, a.scale * pt.scale)

    def hmult(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert self.relin_key is not None, "call keygen() first"
        assert a.level == b.level and a.level >= 2
        l = a.level
        self._count("hmult", l)
        kt = self.dc.keyswitch_tables(l)
        last_nt = self.dc.ntt_basis((l - 1,))
        out_nt = self.dc.ntt_basis(self.dc.main_rows(l - 1))
        out = _hmult_graph(
            a.data, b.data, self.relin_key, kt, last_nt, out_nt,
            self.dc.rescale_qinv_mont(l),
        )
        return Ciphertext(out, l - 1, a.scale * b.scale / self.params.qs[l - 1])

    def hrotate(self, a: Ciphertext, step: int) -> Ciphertext:
        if step not in self.rot_keys:
            self.gen_rotation_key(step)
        self._count("hrotate", a.level)
        g = self.params.galois_elt(step)
        perm = self.dc.automorph_perm(g)
        kt = self.dc.keyswitch_tables(a.level)
        out = _hrotate_graph(a.data, perm, self.rot_keys[step], kt)
        return Ciphertext(out, a.level, a.scale)

    def hsquare(self, a: Ciphertext) -> Ciphertext:
        assert self.relin_key is not None, "call keygen() first"
        assert a.level >= 2, a.level  # rescale drops one limb (as in hmult)
        l = a.level
        self._count("hsquare", l)
        kt = self.dc.keyswitch_tables(l)
        last_nt = self.dc.ntt_basis((l - 1,))
        out_nt = self.dc.ntt_basis(self.dc.main_rows(l - 1))
        out = _hsquare_graph(
            a.data, self.relin_key, kt, last_nt, out_nt,
            self.dc.rescale_qinv_mont(l),
        )
        return Ciphertext(out, l - 1, a.scale * a.scale / self.params.qs[l - 1])

    def conjugate(self, a: Ciphertext) -> Ciphertext:
        """Complex conjugation of all slots (Galois element 2N-1)."""
        g = self.params.galois_conj
        if g not in self._conj_keys:
            key = self.ref._gen_galois_key(g)
            self._conj_keys[g] = self.dc.upload_kskey_mont(key.digits)
        perm = self.dc.automorph_perm(g)
        kt = self.dc.keyswitch_tables(a.level)
        out = _hrotate_graph(a.data, perm, self._conj_keys[g], kt)
        return Ciphertext(out, a.level, a.scale)

    def cmult(self, a: Ciphertext, value: float, scale_bits: int = None) -> Ciphertext:
        """Multiply by a public real scalar (no encoding round-trip)."""
        sb = self.params.scale_bits if scale_bits is None else scale_bits
        delta = float(1 << sb)
        c = int(round(value * delta))
        l = a.level
        key = ("cmult", c, l)
        if key not in self._const_cache:
            qs = self.params.q_arr[:l].astype(np.int64)
            res = (np.int64(c) % qs).astype(np.uint64)
            cm = ((res << np.uint64(32)) % qs.astype(np.uint64)).astype(np.uint32)
            self._const_cache[key] = jnp.asarray(cm)
        q, qinv, _ = self.dc.q_level(l)
        out = _const_mul_graph(a.data, self._const_cache[key], q, qinv)
        return Ciphertext(out, l, a.scale * delta)

    def cadd(self, a: Ciphertext, value: float) -> Ciphertext:
        """Add a public real scalar (to the constant coefficient)."""
        c = int(round(value * a.scale))
        n = self.params.n
        m = np.zeros(n, dtype=np.int64)
        m[0] = c
        pt = self.plaintext_ints(m, a.level, a.scale)
        return self.padd(a, pt)

    def mod_drop(self, a: Ciphertext, levels: int = 1) -> Ciphertext:
        """Drop limbs without rescaling (modulus switch by truncation);
        used to align operand levels."""
        new_level = a.level - levels
        assert new_level >= 1
        return Ciphertext(a.data[:, :new_level], new_level, a.scale)

    def align_levels(self, a: Ciphertext, b: Ciphertext):
        if a.level == b.level:
            return a, b
        if a.level > b.level:
            return self.mod_drop(a, a.level - b.level), b
        return a, self.mod_drop(b, b.level - a.level)

    def hrotate_hoisted(self, a: Ciphertext, steps) -> list:
        """Rotate one ciphertext by several steps, sharing one ModUp."""
        for step in steps:
            if step not in self.rot_keys:
                self.gen_rotation_key(step)
        perms = tuple(
            self.dc.automorph_perm(self.params.galois_elt(s)) for s in steps
        )
        rotks = tuple(self.rot_keys[s] for s in steps)
        kt = self.dc.keyswitch_tables(a.level)
        if kt.main_nt.piecewise and len(steps) >= 4:
            # scan form: program size constant in the rotation count
            # (bit-identical; the inlined form grows one key switch per
            # rotation, and compile time with it).
            outs = _hrotate_hoisted_scan_graph(
                a.data, jnp.stack(perms), jnp.stack(rotks), kt)
        else:
            outs = _hrotate_hoisted_graph(a.data, perms, rotks, kt)
        return [
            Ciphertext(outs[i], a.level, a.scale) for i in range(len(steps))
        ]

    def keyswitch_poly(self, d: jnp.ndarray, key: jnp.ndarray, level: int):
        kt = self.dc.keyswitch_tables(level)
        return _keyswitch_graph(d, key, kt)

    def op_cost_counters(self, op: str, a: Ciphertext,
                         b: Optional[Ciphertext] = None,
                         pt: Optional[Plaintext] = None) -> Dict[str, float]:
        """Measured XLA cost/memory counters for one op's compiled graph
        (stats.xla_counters — HBM bytes, buffer residency, flops). Shares
        the jit compilation cache with normal execution."""
        from .stats import xla_counters

        l = a.level
        if op == "hmult":
            kt = self.dc.keyswitch_tables(l)
            args = (a.data, b.data, self.relin_key, kt,
                    self.dc.ntt_basis((l - 1,)),
                    self.dc.ntt_basis(self.dc.main_rows(l - 1)),
                    self.dc.rescale_qinv_mont(l))
            graph = _hmult_graph
        elif op == "hrotate":
            if 1 not in self.rot_keys:
                self.gen_rotation_key(1)
            perm = self.dc.automorph_perm(self.params.galois_elt(1))
            args = (a.data, perm, self.rot_keys[1],
                    self.dc.keyswitch_tables(l))
            graph = _hrotate_graph
        elif op == "hadd":
            q, _, _ = self.dc.q_level(l)
            args = (a.data, b.data, q)
            graph = _hadd_graph
        elif op == "pmult":
            q, qinv, r2 = self.dc.q_level(l)
            args = (a.data, pt.data, q, qinv, r2)
            graph = _pmult_graph
        elif op == "padd":
            q, _, _ = self.dc.q_level(l)
            args = (a.data, pt.data, q)
            graph = _padd_graph
        elif op == "hsub":
            q, _, _ = self.dc.q_level(l)
            args = (a.data, b.data, q)
            graph = _hsub_graph
        elif op == "hsquare":
            kt = self.dc.keyswitch_tables(l)
            args = (a.data, self.relin_key, kt,
                    self.dc.ntt_basis((l - 1,)),
                    self.dc.ntt_basis(self.dc.main_rows(l - 1)),
                    self.dc.rescale_qinv_mont(l))
            graph = _hsquare_graph
        else:
            raise ValueError(op)
        return xla_counters(graph.lower(*args).compile())

    def rescale(self, a: Ciphertext) -> Ciphertext:
        l = a.level
        last_nt = self.dc.ntt_basis((l - 1,))
        out_nt = self.dc.ntt_basis(self.dc.main_rows(l - 1))
        out = _rescale_graph(a.data, last_nt, out_nt, self.dc.rescale_qinv_mont(l))
        return Ciphertext(out, l - 1, a.scale / self.params.qs[l - 1])

    def ntt(self, x: jnp.ndarray, level: int) -> jnp.ndarray:
        """x: [M, N] flat coeff order -> [M, N] flat eval order (host-view
        utility; on-device graphs keep the 3-D tile layouts throughout)."""
        t = self.params.ntt
        M = x.shape[0]
        y = _ntt_graph(
            x.reshape(M, t.n1, t.n2),
            self.dc.ntt_basis(self.dc.main_rows(level)),
        )
        return y.reshape(M, self.params.n)

    def intt(self, x: jnp.ndarray, level: int) -> jnp.ndarray:
        t = self.params.ntt
        M = x.shape[0]
        y = _intt_graph(
            x.reshape(M, t.n2, t.n1),
            self.dc.ntt_basis(self.dc.main_rows(level)),
        )
        return y.reshape(M, self.params.n)
