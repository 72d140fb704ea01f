"""The CUDA NTT leaf (ops/ntt_cuda.py).

On the CPU: what surrounds the kernel — result shapes through the FFI
call (leading batch dims, rep copies, vmap), the choice of leaf, and the
build command. Tests marked `gpu` compare the kernel with the XLA leaf at
set-B widths; they skip here and run on the card under chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from homulator_tpu.context import CUDA, XLA, DeviceContext, default_ntt_mode
from homulator_tpu.ops import ntt_cuda
from homulator_tpu.ops.ntt import intt, intt_rep, ntt, ntt_rep
from homulator_tpu.params import get_params


@pytest.fixture(scope="module")
def xla_ctx():
    return DeviceContext(get_params(n=2048, max_level=6, alpha=3), "xla")


def _as_cuda(nb):
    """The same tables with the CUDA leaf selected (shape checks only)."""
    import dataclasses

    return dataclasses.replace(nb, leaf=CUDA)


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_cuda_call_shapes(xla_ctx, lead):
    """Forward [..., M, n1, n2] -> [..., M, n2, n1] and back, for any
    leading dims (table rows are reused modulo M)."""
    nb = _as_cuda(xla_ctx.ntt_basis(xla_ctx.main_rows(5)))
    t = xla_ctx.params.ntt
    x = jax.ShapeDtypeStruct(lead + (5, t.n1, t.n2), jnp.uint32)
    y = jax.eval_shape(ntt, x, nb)
    assert y.shape == lead + (5, t.n2, t.n1) and y.dtype == jnp.uint32
    z = jax.eval_shape(intt, y, nb)
    assert z.shape == x.shape and z.dtype == jnp.uint32


def test_cuda_rep_and_vmap_shapes(xla_ctx):
    """rep stacked copies go to the kernel as one [rep, M, ...] batch;
    vmap adds a leading dim (vmap_method expand_dims)."""
    nb = _as_cuda(xla_ctx.ntt_basis(xla_ctx.main_rows(4)))
    t = xla_ctx.params.ntt
    x = jax.ShapeDtypeStruct((8, t.n1, t.n2), jnp.uint32)
    assert jax.eval_shape(lambda v: ntt_rep(v, nb, 2), x).shape == (
        8, t.n2, t.n1)
    xe = jax.ShapeDtypeStruct((8, t.n2, t.n1), jnp.uint32)
    assert jax.eval_shape(lambda v: intt_rep(v, nb, 2), xe).shape == (
        8, t.n1, t.n2)
    xb = jax.ShapeDtypeStruct((3, 4, t.n1, t.n2), jnp.uint32)
    assert jax.eval_shape(jax.vmap(lambda v: ntt(v, nb)), xb).shape == (
        3, 4, t.n2, t.n1)


def test_cuda_call_passes_shoup_and_mid_tables(xla_ctx, monkeypatch):
    """The wrapper hands the kernel the flat Shoup stage tables and the
    Montgomery mid twiddles, in the handler's argument order."""
    seen = {}

    def fake_call(name, x, out_shape, tables):
        seen[name] = (out_shape, tables)
        return jnp.zeros(out_shape, jnp.uint32)

    monkeypatch.setattr(ntt_cuda, "_call", fake_call)
    nb = _as_cuda(xla_ctx.ntt_basis(xla_ctx.main_rows(3)))
    t = xla_ctx.params.ntt
    x = jnp.zeros((3, t.n1, t.n2), jnp.uint32)
    ntt_cuda.ntt_cuda(x, nb)
    ntt_cuda.intt_cuda(x.transpose(0, 2, 1), nb)
    shape, tabs = seen["homulator_ntt_fwd"]
    assert shape == (3, t.n2, t.n1)
    assert tabs[0] is nb.q and tabs[1] is nb.qinv and tabs[4] is nb.tw_mid
    assert tabs[2] is nb.psi[0] and tabs[6] is nb.psi[3]
    shape, tabs = seen["homulator_ntt_inv"]
    assert shape == (3, t.n1, t.n2)
    assert tabs[4] is nb.tw_mid_inv
    assert tabs[2] is nb.ipsi[2] and tabs[5] is nb.ipsi[0]


def test_flat_shoup_tables(xla_ctx):
    """psi[s-th stage, block b] sits at 2^s + b; quotients are
    floor(w * 2^32 / q)."""
    p = xla_ctx.params
    nb = xla_ctx.ntt_basis((1, 4))
    tw1, tw1_sh = np.asarray(nb.psi[0]), np.asarray(nb.psi[1])
    for s, stage in enumerate(p.ntt.sub1.stage_tw):
        assert np.array_equal(tw1[:, 1 << s: 2 << s], stage[[1, 4]])
    q = p.q_arr[[1, 4]].astype(np.uint64)[:, None]
    want = (tw1.astype(np.uint64) << np.uint64(32)) // q
    assert np.array_equal(tw1_sh, want.astype(np.uint32))


def test_leaf_choice_on_cpu():
    """auto resolves to the XLA leaf off a GPU, and the piecewise
    pipeline runs on it; only the montgomery leaf carries stage tuples."""
    assert default_ntt_mode() == XLA
    p = get_params(n=256, max_level=4, alpha=2)
    dc = DeviceContext(p)
    nb = dc.ntt_basis(dc.main_rows(4))
    assert dc.ntt_mode == XLA and nb.piecewise and nb.psi and not nb.stage1
    mb = DeviceContext(p, "montgomery").ntt_basis((0, 1))
    assert not mb.piecewise and mb.stage1 and not mb.psi
    with pytest.raises(ValueError):
        DeviceContext(p, "interpret")


def test_nvcc_command_targets_hopper(tmp_path):
    cmd = ntt_cuda.nvcc_command("nvcc", str(tmp_path / "x.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith("ntt_cuda.cu") and "-shared" in cmd
    assert jax.ffi.include_dir() in cmd


def test_cuda_build_without_toolkit_fails_loudly(monkeypatch):
    """No silent fallback: asking for the CUDA leaf without nvcc raises."""
    monkeypatch.setattr(ntt_cuda, "nvcc_path", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        ntt_cuda.build()


# ---- on the card -----------------------------------------------------------
@pytest.fixture(scope="module")
def set_b():
    return get_params(n=1 << 16, max_level=45, alpha=15)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 50, 61])
def test_cuda_ntt_matches_xla_leaf(gpu, set_b, rows):
    """CUDA NTT/iNTT == the XLA leaf at set-B widths ([rows, 256, 256];
    61 > K reuses primes), and iNTT inverts NTT."""
    p = set_b
    r = tuple(i % p.num_primes for i in range(rows))
    nbc = DeviceContext(p, "cuda").ntt_basis(r)
    nbx = DeviceContext(p, "xla").ntt_basis(r)
    rng = np.random.default_rng(rows)
    q = p.q_arr[list(r)]
    x = jnp.asarray(np.stack([
        rng.integers(0, int(qq), size=(p.ntt.n1, p.ntt.n2), dtype=np.uint64)
        for qq in q]).astype(np.uint32))
    f, i = jax.jit(ntt), jax.jit(intt)
    y = f(x, nbc)
    assert np.array_equal(np.asarray(y), np.asarray(f(x, nbx)))
    assert np.array_equal(np.asarray(i(y, nbc)), np.asarray(x))
    assert np.array_equal(np.asarray(i(y, nbx)), np.asarray(x))


@pytest.mark.gpu
def test_cuda_rep_and_vmap_match_xla_leaf(gpu, set_b):
    p = set_b
    r = tuple(range(50))
    nbc = DeviceContext(p, "cuda").ntt_basis(r)
    nbx = DeviceContext(p, "xla").ntt_basis(r)
    rng = np.random.default_rng(7)
    q = p.q_arr[:50].astype(np.uint64)
    x = jnp.asarray((rng.integers(0, 1 << 32, size=(2, 50, p.ntt.n1,
                                                      p.ntt.n2),
                                  dtype=np.uint64)
                     % q[None, :, None, None]).astype(np.uint32))
    rep = jax.jit(ntt_rep, static_argnums=2)
    x2 = x.reshape((100,) + x.shape[2:])
    assert np.array_equal(np.asarray(rep(x2, nbc, 2)),
                          np.asarray(rep(x2, nbx, 2)))
    vb = jax.jit(jax.vmap(ntt, in_axes=(0, None)))
    assert np.array_equal(np.asarray(vb(x, nbc)), np.asarray(vb(x, nbx)))
