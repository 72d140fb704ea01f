# Shared driver for the reference-parity benchmark wrappers.
#
# Mirrors /root/reference/script/para*/micro24_*.sh <cluster>: sweeps the
# op at every level maxLevel..2 for the set, teeing JSONL into outLogs/.
#
#   cluster absent or 1 -> the measured single-device sweep on the attached
#                          GPU (scripts/sweep.py, chained-loop timings).
#   cluster N > 1       -> the sharded dispatch surface on an N-virtual-
#                          device CPU mesh via the CLI's 6th positional
#                          (the shard_map path runs per level with full
#                          decrypt --verify instead of timings).
run_set_op() {
  set_name=$1; op=$2; max_level=$3; alpha=$4; n=$5; cluster=${6:-1}
  root=$(cd "$(dirname "$0")/../.." && pwd)
  if [ "$cluster" -le 1 ]; then
    # --out must be the repo-root outLogs: run.sh cds into script/paraX/,
    # so sweep.py's relative default would land the jsonl in the wrong tree.
    exec python "$root/scripts/sweep.py" --sets "$set_name" --ops "$op" \
      --levels all --out "$root/outLogs"
  fi
  cfg="$root/configs/n16.cfg"
  [ "$n" = 32768 ] && cfg="$root/configs/n15.cfg"
  # Cluster mode mirrors the reference's per-cluster log tree
  # (script/paraB/micro24_B_hmult.sh:7-16 -> outLogs/<set>/<cluster>/...):
  # outLogs/<set>/c<cluster>/<op>.log. Levels are the justified subset
  # {max, 3/4, 1/2, 1/4, 2} (each level is a separate XLA program and the
  # virtual-device runs are functional decrypt-verified sweeps, not
  # timings — scripts/sweep.py --levels all is the measured grid). Both
  # explicit-collective dispatch axes are exercised per level.
  outdir="$root/outLogs/$set_name/c$cluster"
  mkdir -p "$outdir"
  set -o pipefail
  levels=$(printf '%s\n' "$max_level" $((3*max_level/4)) $((max_level/2)) \
    $((max_level/4)) 2 | sort -runk1)
  case "$op" in
    hmult|hrotate)
      # all explicit-collective axes; the 2-D hybrid needs an even
      # cluster >= 4 (cli.py --dispatch hybrid)
      disps="limb coeff"
      [ "$cluster" -ge 4 ] && [ $((cluster % 2)) -eq 0 ] && \
        disps="$disps hybrid"
      ;;
    *) disps="auto" ;;                    # non-keyswitch ops: GSPMD
  esac
  for lvl in $levels; do
    [ "$lvl" -lt 2 ] && continue
    for disp in $disps; do
      # run.sh cds into script/paraX/, so the package root must be on the
      # import path explicitly.
      PYTHONPATH="$root" python -m homulator_tpu run "$cfg" "$op" \
        "$max_level" "$lvl" "$alpha" "$cluster" --platform cpu --iters 1 \
        --verify --dispatch "$disp" 2>&1 | tee -a "$outdir/$op.log" \
        || exit 1
    done
  done
}
