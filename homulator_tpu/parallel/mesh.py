"""Device mesh construction for multi-chip CKKS.

The reference's parallel machine is `cluster` accelerator clusters joined
by a pull-on-miss NoC (SURVEY.md §2 "Parallelism & communication
inventory"); its real work axes are RNS limbs (NTT/AUTO dispatched to
cluster `level % cluster`, Driver.h:158,178), coefficient batches (every
op split into N/batchSize batch instructions, InsGen.cpp:12), and
ciphertext batches. On a device mesh, those become mesh axes:

  'data'  — ciphertext-batch data parallelism (embarrassingly parallel)
  'limb'  — limb (RNS) parallelism; elementwise ops shard freely, base
            conversion contracts over limbs (XLA inserts the all-gather /
            reduce the NoC modeled on-miss)
  'coeff' — coefficient-axis sharding (the sequence-parallel analog,
            SURVEY.md §5): the 4-step NTT's inter-transpose becomes the
            cross-device reshard the reference models as its
            interTrans stage (interTrans_delay=256, config_4.cfg:48)

Same code path 1 chip -> 1 host -> multi-host via jax.sharding.Mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXES = ("data", "limb", "coeff")


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    n_devices: Optional[int] = None,
    axis_names: Optional[Tuple[str, ...]] = None,
) -> Mesh:
    """Build a mesh over the first n_devices devices. Default axes are
    ('data', 'limb') for a 2-tuple shape and ('data', 'limb', 'coeff')
    for a 3-tuple."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = devs[:n_devices]
    if shape is None:
        shape = (1, n_devices)
    if axis_names is None:
        axis_names = AXES[: len(shape)] if len(shape) <= 3 else None
    assert axis_names is not None and len(axis_names) == len(shape)
    assert int(np.prod(shape)) == n_devices, (shape, n_devices)
    arr = np.array(devs).reshape(shape)
    return Mesh(arr, axis_names)


def coeff_shard_ok(n1: int, n2: int, ns: int, *, min_tile: int = 8) -> bool:
    """Single source of truth for 'can the coeff-axis explicit-collective
    dispatch run at this mesh size', shared by cli.py and
    dryrun_multichip. Both NTT tile dims must divide evenly and the
    per-shard slice of the SMALLER tile dim must keep at least min_tile
    rows (the toy dryrun shapes relax min_tile)."""
    return (
        n1 % ns == 0 and n2 % ns == 0 and min(n1, n2) // ns >= min_tile
    )


def ct_batch_sharding(mesh: Mesh) -> NamedSharding:
    """Batched ciphertexts [B, 2, L, R, C]: batch over 'data', limbs over
    'limb', trailing coefficient axis over 'coeff' when the mesh has it."""
    co = "coeff" if "coeff" in mesh.axis_names else None
    return NamedSharding(mesh, P("data", None, "limb", None, co))


def limb_sharding(mesh: Mesh) -> NamedSharding:
    """Single ciphertext [2, L, R, C]: limbs over 'limb' (+ 'coeff')."""
    co = "coeff" if "coeff" in mesh.axis_names else None
    return NamedSharding(mesh, P(None, "limb", None, co))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def place(tree, specs, mesh: Mesh):
    """Put a table pytree on `mesh` once, laid out by its PartitionSpec
    tree, so every call finds the tables resident on every device instead
    of re-sending them from the device they were created on."""
    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                             is_leaf=lambda x: isinstance(x, P))
    return jax.device_put(tree, shardings)


def bind_tables(f, *tables):
    """jit(f) with its trailing table arguments bound: run(*args) calls
    f(*args, *tables); run.lower(*args) lowers the same program."""
    jf = jax.jit(f)

    def run(*args):
        return jf(*args, *tables)

    run.lower = lambda *args: jf.lower(*args, *tables)
    return run
