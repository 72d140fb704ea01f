"""CLI contract tests (reference bench_micro24 positional parity).

In-process `cli.main()` calls on the tiny config; conftest already pinned
the CPU backend with 8 virtual devices, so the optional [cluster]
positional exercises both real dispatch layers (shard_map and GSPMD). Every run goes through `--verify` (full-slot decrypt check) —
a latency print alone would pass on wrong results.
"""

import pytest

from homulator_tpu import cli

CFG = "configs/tiny.cfg"


@pytest.mark.parametrize(
    "op", ["hadd", "hsub", "pmult", "padd", "hmult", "hrotate", "hsquare"]
)
def test_cli_single_chip_ops_verify(op, capsys):
    rc = cli.main(["run", CFG, op, "8", "4", "4", "--verify", "--iters", "1"])
    outp = capsys.readouterr().out
    assert rc == 0, outp
    assert "verify max-abs-err" in outp


@pytest.mark.parametrize("op,expect", [
    # auto picks the axis with the smaller exact per-device ICI volume; at
    # the tiny shape that is coeff for hmult (24 transforms * small tiles
    # < the limb row gathers) and limb for hrotate (the coeff path's two
    # automorphism all_gathers dominate; on the limb axis AUTO is free).
    ("hmult", "dispatch=shard_map axis=coeff"),
    ("hrotate", "dispatch=shard_map axis=limb"),
    ("hadd", "dispatch=gspmd"),
])
def test_cli_cluster_dispatch(op, expect, capsys):
    """The 6th positional routes key-switch ops to a shard_map path — the
    dispatch AXIS picked by exact receive volume, both volumes printed —
    and others to GSPMD."""
    rc = cli.main(
        ["run", CFG, op, "8", "4", "4", "2", "--verify", "--iters", "1",
         "--platform", "cpu"]
    )
    outp = capsys.readouterr().out
    assert rc == 0, outp
    assert expect in outp
    if "shard_map" in expect:
        assert "ici_bytes_per_device" in outp
        assert "ici/device: limb=" in outp  # the bake-off line


@pytest.mark.parametrize("op,axis,cluster", [
    # coeff at cluster 2 only: at ns=4 the tiny 16x16 tile breaks the
    # per-shard tile guard (16/4 < 8) — itself covered below.
    ("hmult", "limb", "4"), ("hmult", "coeff", "2"),
    ("hrotate", "limb", "4"), ("hrotate", "coeff", "2"),
])
def test_cli_forced_dispatch_divisible(op, axis, cluster, capsys):
    return test_cli_forced_dispatch(op, axis, cluster, capsys, level="4")


@pytest.mark.parametrize("op,axis,cluster", [
    # level 5 does NOT divide the mesh: the limb path pads rows (the
    # padded layout must never enter a Ciphertext container — regression
    # for the level-invariant assert the first cluster runs tripped).
    ("hmult", "limb", "4"), ("hrotate", "limb", "4"),
])
def test_cli_forced_dispatch(op, axis, cluster, capsys, level="5"):
    """--dispatch forces either explicit-collective axis; both
    decrypt-verify on the virtual mesh."""
    rc = cli.main(
        ["run", CFG, op, "8", level, "4", cluster, "--verify", "--iters",
         "1", "--platform", "cpu", "--dispatch", axis]
    )
    outp = capsys.readouterr().out
    assert rc == 0, outp
    assert f"dispatch=shard_map axis={axis}" in outp
    assert "(forced)" in outp
    assert "verify max-abs-err" in outp


def test_cli_forced_coeff_rejects_bad_tiles():
    """Forcing coeff past the per-shard tile guard fails loudly, not
    wrongly."""
    with pytest.raises(SystemExit, match="dispatch coeff"):
        cli.main(["run", CFG, "hmult", "8", "4", "4", "4", "--iters", "1",
                  "--platform", "cpu", "--dispatch", "coeff"])


def test_cli_unknown_op():
    with pytest.raises(SystemExit):
        cli.main(["run", CFG, "bogus", "8", "4", "4"])


def test_choose_axis_volume_fallback():
    """--dispatch auto picks the axis with the smaller exact per-device
    receive volume: hrotate goes to limb at the tiny shape (its
    automorphism needs no collective there), and the returned volumes are
    the HLO-reconciled formulas."""
    from homulator_tpu.params import get_params
    from homulator_tpu.parallel.limb_sharded import ici_bytes_per_op_limb
    from homulator_tpu.parallel.sharded import ici_bytes_per_op

    params = get_params(n=256, max_level=8, alpha=4)
    axis, b_limb, b_coeff = cli.choose_axis(params, "hmult", 2, 4)
    assert b_limb == ici_bytes_per_op_limb(params, 4, 2, "hmult")
    assert b_coeff == ici_bytes_per_op(params, 4, 2, "hmult")
    assert axis == ("coeff" if b_coeff < b_limb else "limb")
    axis_r, _, _ = cli.choose_axis(params, "hrotate", 2, 4)
    assert axis_r == "limb"


@pytest.mark.parametrize("ns,level", [(2, 4), (4, 8), (8, 8)])
def test_choose_axis_by_volume(ns, level):
    """The rule is the volume comparison and nothing else; without a
    shardable coefficient tile it is limb."""
    from homulator_tpu.params import get_params

    params = get_params(n=1 << 12, max_level=8, alpha=4)
    for op in ("hmult", "hrotate"):
        axis, b_limb, b_coeff = cli.choose_axis(params, op, ns, level)
        assert axis == ("coeff" if b_coeff < b_limb else "limb"), (op, ns)
        axis0, _, none = cli.choose_axis(params, op, ns, level,
                                         coeff_ok=False)
        assert axis0 == "limb" and none is None


@pytest.mark.parametrize("op", ["hmult", "hrotate"])
def test_cli_forced_hybrid_dispatch(op, capsys):
    """--dispatch hybrid runs the 2-D limb x coeff mesh and
    decrypt-verifies (level 5 also exercises row padding on the 2-D
    mesh)."""
    rc = cli.main(
        ["run", CFG, op, "8", "5", "4", "4", "--verify", "--iters", "1",
         "--platform", "cpu", "--dispatch", "hybrid"]
    )
    outp = capsys.readouterr().out
    assert rc == 0, outp
    assert "axis=hybrid mesh=(2 limb, 2 coeff)" in outp
    assert "verify max-abs-err" in outp


def test_cli_hybrid_rejected_on_odd_cluster():
    with pytest.raises(SystemExit, match="hybrid"):
        cli.main(["run", CFG, "hmult", "8", "4", "4", "2", "--iters", "1",
                  "--platform", "cpu", "--dispatch", "hybrid"])
