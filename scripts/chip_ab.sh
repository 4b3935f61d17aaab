#!/usr/bin/env bash
# Parent against change on one card: chip_smoke.py from two unpacked trees
# in turns (parent, change, change, parent), so both see the same card,
# power limit and neighbours.  Each run's output goes to
# <out dir>/ab<i>_<parent|change>.{log,err}; scripts/ab_table.py compares
# them.
#
#   bash scripts/chip_ab.sh <parent dir> <change dir> <out dir> [seconds per run]
#
# Run it from the repository root on a machine with the card.  Each tree
# (a `git archive` unpack) builds its own kernels into its own build/.
set -u
parent=$1
change=$2
out=$(mkdir -p "$3" && cd "$3" && pwd)
limit=${4:-600}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
i=0
for side in parent change change parent; do
  i=$((i + 1))
  if [ "$side" = parent ]; then dir=$parent; else dir=$change; fi
  (cd "$dir" && timeout "$limit" python3 chip_smoke.py) \
    > "$out/ab${i}_${side}.log" 2> "$out/ab${i}_${side}.err"
  echo "run $i $side rc=$?"
  tail -n 2 "$out/ab${i}_${side}.err"
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
