"""ctypes bindings for the native host core (native/ckks_core.cpp).

The library is compiled from that source with the host's C++ compiler at
first use, into `<checkout>/build/` under a name keyed by the source's
hash (`python -c "from homulator_tpu import native; native.build()"`
builds it ahead of time). Callers fall back to the numpy reference path
when no compiler is available. The native kernels are bit-identical to
refimpl.py (asserted in tests/test_native.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

from .runtime import ROOT, build_dir

_SRC = os.path.join(ROOT, "native", "ckks_core.cpp")
_FLAGS = ["-O3", "-march=native", "-fPIC", "-Wall", "-std=c++17", "-shared"]
# OpenMP threads the per-limb loops; a compiler without libgomp builds the
# same code single-threaded (the pragmas are then ignored).
_OPENMP = ["-fopenmp"]
_NO_OPENMP = ["-Wno-unknown-pragmas"]
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_U64P = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")


def build() -> Optional[str]:
    """Compile the library if this source has no build yet; return its
    path, or None without a C++ compiler. Writes a temporary file and
    renames it, so concurrent builders never load a half-written library."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    with open(_SRC, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    out = os.path.join(build_dir(), f"libckks_core-{tag}.so")
    if not os.path.exists(out):
        tmp = f"{out}.{os.getpid()}.tmp"
        res = subprocess.run([cxx, *_FLAGS, *_OPENMP, "-o", tmp, _SRC],
                             capture_output=True, text=True)
        if res.returncode != 0:
            subprocess.run([cxx, *_FLAGS, *_NO_OPENMP, "-o", tmp, _SRC],
                           check=True)
        os.replace(tmp, out)
    return out


def load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    c_int, c_ll = ctypes.c_int, ctypes.c_longlong
    lib.ckks_ntt_fwd.argtypes = [_U64P, c_int, c_int, c_int, _U64P, _U64P, _U64P, _U64P]
    lib.ckks_ntt_inv.argtypes = [_U64P, c_int, c_int, c_int, _U64P, _U64P, _U64P, _U64P]
    for f in (lib.ckks_ewe_mul, lib.ckks_ewe_add, lib.ckks_ewe_sub):
        f.argtypes = [_U64P, _U64P, _U64P, c_int, c_ll, _U64P]
    lib.ckks_bconv.argtypes = [_U64P, _U64P, _U64P, c_int, c_int, c_ll, _U64P]
    lib.ckks_core_version.restype = c_int
    _LIB = lib
    return lib


def available() -> bool:
    return load() is not None


class NativeNtt:
    """Per-params flattened tables for the native NTT (psi_br layout)."""

    def __init__(self, params):
        self.p = params
        t = params.ntt
        K = params.num_primes
        self.n1, self.n2 = t.n1, t.n2

        def flat(stages, n):
            out = np.zeros((K, n), dtype=np.uint64)
            for s, arr in enumerate(stages):
                out[:, (1 << s): (1 << (s + 1))] = arr
            return np.ascontiguousarray(out)

        self.psi1 = flat(t.sub1.stage_tw, t.n1)
        self.psi2 = flat(t.sub2.stage_tw, t.n2)
        self.ipsi1 = flat(t.sub1.inv_stage_tw, t.n1)
        self.ipsi2 = flat(t.sub2.inv_stage_tw, t.n2)
        self.tw_mid = np.ascontiguousarray(t.tw_mid.reshape(K, -1))
        self.tw_mid_inv = np.ascontiguousarray(t.tw_mid_inv.reshape(K, -1))
        self.qs = np.ascontiguousarray(params.q_arr)

    def _rows(self, idx):
        idx = np.asarray(idx)
        return (
            np.ascontiguousarray(self.qs[idx]),
            np.ascontiguousarray(self.psi1[idx]),
            np.ascontiguousarray(self.tw_mid[idx]),
            np.ascontiguousarray(self.psi2[idx]),
            np.ascontiguousarray(self.ipsi1[idx]),
            np.ascontiguousarray(self.tw_mid_inv[idx]),
            np.ascontiguousarray(self.ipsi2[idx]),
        )

    def ntt(self, x: np.ndarray, idx) -> np.ndarray:
        lib = load()
        assert lib is not None
        qs, p1, mid, p2, _, _, _ = self._rows(idx)
        out = np.ascontiguousarray(x, dtype=np.uint64).copy()
        lib.ckks_ntt_fwd(out, out.shape[0], self.n1, self.n2, qs, p1, mid, p2)
        return out

    def intt(self, x: np.ndarray, idx) -> np.ndarray:
        lib = load()
        assert lib is not None
        qs, _, _, _, ip1, midi, ip2 = self._rows(idx)
        out = np.ascontiguousarray(x, dtype=np.uint64).copy()
        lib.ckks_ntt_inv(out, out.shape[0], self.n1, self.n2, qs, ip1, midi, ip2)
        return out
