"""Coefficient-axis-sharded NTT: the multi-chip scaling path for large N.

This is the device-mesh version of how the reference scales the polynomial
degree: it splits each poly into N/batchSize batches across unit lanes and
pays a dedicated cross-lane transpose inside the NTTU
(interTrans_delay=256, config_4.cfg:48; SURVEY.md §5 "sequence
parallelism" analog). Here the [M, n1, n2] coefficient tile is sharded on
the n2 (column) axis:

  step 1   — size-n1 sub-NTTs along n1: local to each device
  twiddle  — elementwise: local
  transpose + reshard — the 4-step inter-transpose: GSPMD lowers the
             resharding of the transposed array to an all_to_all
             (exactly the data movement the reference models as its
             inter-cluster stage)
  step 2   — size-n2 sub-NTTs along n2: local again

Uses the Montgomery table path, which the SPMD partitioner can split;
bit-identical to the single-device transform.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..context import MONTGOMERY, NttBasis
from ..ops.modmath import mont_mul
from ..ops.ntt import _ct_stages, _gs_stages


def _ntt_sharded_body(y, nb: NttBasis, spec_cols):
    """y: [M, n1, n2] coefficient tile, columns sharded -> [M, n2, n1]
    evaluation tile (the forward 4-step's natural output layout)."""
    M = y.shape[0]
    q3 = nb.q.reshape(M, 1, 1)
    qi3 = nb.qinv.reshape(M, 1, 1)
    y = _ct_stages(y, nb.stage1, nb.q, nb.qinv)
    y = mont_mul(y, nb.tw_mid, q3, qi3)
    y = y.transpose(0, 2, 1)
    # Reshard the transposed tile onto the column axis: the inter-transpose
    # all_to_all over the mesh.
    y = jax.lax.with_sharding_constraint(y, spec_cols)
    y = _ct_stages(y, nb.stage2, nb.q, nb.qinv)
    return y


def _intt_sharded_body(y, nb: NttBasis, spec_cols):
    """y: [M, n2, n1] evaluation tile, columns sharded -> [M, n1, n2]."""
    M = y.shape[0]
    q3 = nb.q.reshape(M, 1, 1)
    qi3 = nb.qinv.reshape(M, 1, 1)
    y = _gs_stages(y, nb.istage2, nb.q, nb.qinv)
    y = y.transpose(0, 2, 1)
    y = jax.lax.with_sharding_constraint(y, spec_cols)
    y = mont_mul(y, nb.tw_mid_inv, q3, qi3)
    y = _gs_stages(y, nb.istage1, nb.q, nb.qinv)
    return y


def make_coeff_sharded_ntt(nb: NttBasis, mesh: Mesh, axis: str = "limb"):
    """Returns (ntt_fn, intt_fn) over [M, n1, n2] / [M, n2, n1] tiles with
    the trailing (column) axis sharded over `axis`. nb must be a jnp-path
    (Montgomery) NttBasis."""
    assert nb.leaf == MONTGOMERY, "coefficient sharding uses the Montgomery tables"
    spec_cols = NamedSharding(mesh, P(None, None, axis))

    ntt_fn = jax.jit(
        lambda x: _ntt_sharded_body(x, nb, spec_cols),
        in_shardings=spec_cols, out_shardings=spec_cols,
    )
    intt_fn = jax.jit(
        lambda x: _intt_sharded_body(x, nb, spec_cols),
        in_shardings=spec_cols, out_shardings=spec_cols,
    )
    return ntt_fn, intt_fn
