"""CUDA leaf for the 4-step NTT (ops/ntt_cuda.cu), called through jax.ffi.

The library is compiled from the source in this directory with nvcc for
Hopper (sm_90a) at first use, into `<checkout>/build/` under a name keyed
by the source's hash, and registered as two FFI targets. It exists only
where the CUDA toolkit does; CPU runs use the XLA leaf (ops/ntt.py).

Layouts match ops/ntt.py: forward [..., n1, n2] coeff tiles -> [..., n2,
n1] eval tiles, inverse the reverse. Leading dims (vmap batches, rep
stacked copies of one basis) use table row (row % M).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import jax
import jax.numpy as jnp

from ..runtime import build_dir

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ntt_cuda.cu")
_FWD = "homulator_ntt_fwd"
_INV = "homulator_ntt_inv"
_LIB: Optional[ctypes.CDLL] = None


def nvcc_path() -> Optional[str]:
    """nvcc on PATH or under the toolkit's default prefix, else None."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else None


def nvcc_command(nvcc: str, out: str) -> list:
    return [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", out, _SRC,
    ]


def build() -> str:
    """Compile the library if this source has no build yet; return its
    path. Writes a temporary file and renames it, so concurrent builders
    never load a half-written library."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA NTT leaf needs the "
                           "CUDA toolkit")
    with open(_SRC, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    out = os.path.join(build_dir(), f"libhomulator_ntt-{tag}.so")
    if not os.path.exists(out):
        tmp = f"{out}.{os.getpid()}.tmp"
        res = subprocess.run(nvcc_command(nvcc, tmp), capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stderr[-4000:]}")
        os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build (if needed), load and register the FFI targets once."""
    global _LIB
    if _LIB is None:
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            _FWD, jax.ffi.pycapsule(lib.HomulatorNttFwd), platform="CUDA")
        jax.ffi.register_ffi_target(
            _INV, jax.ffi.pycapsule(lib.HomulatorNttInv), platform="CUDA")
        _LIB = lib
    return _LIB


def _call(name: str, x, out_shape, tables):
    out = jax.ShapeDtypeStruct(out_shape, jnp.uint32)
    y, _ = jax.ffi.ffi_call(name, (out, out), vmap_method="expand_dims")(
        x, *tables)
    return y


def ntt_cuda(x, nb):
    """x [..., n1, n2] coeff tiles -> [..., n2, n1] eval tiles."""
    n1, n2 = x.shape[-2:]
    tw1, tw1_sh, tw2, tw2_sh = nb.psi
    return _call(_FWD, x, x.shape[:-2] + (n2, n1),
                 (nb.q, nb.qinv, tw1, tw1_sh, nb.tw_mid, tw2, tw2_sh))


def intt_cuda(x, nb):
    """x [..., n2, n1] eval tiles -> [..., n1, n2] coeff tiles."""
    n2, n1 = x.shape[-2:]
    itw1, itw1_sh, itw2, itw2_sh = nb.ipsi
    return _call(_INV, x, x.shape[:-2] + (n1, n2),
                 (nb.q, nb.qinv, itw2, itw2_sh, nb.tw_mid_inv, itw1, itw1_sh))
