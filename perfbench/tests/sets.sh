#!/bin/bash
# Measure a cell's spread on the card: one first run (it builds the
# kernels; its set-up is kept apart), then two sets of runs on the same
# seeds, then traced runs. Outputs go to chiprun_out/sets/<cell>/.
#   bash perfbench/tests/sets.sh <cell> <seconds> "<seeds of a set>" "<traced seeds>"
set -u
cell=$1; seconds=$2; seeds=$3; traced=$4
out=chiprun_out/sets/$cell
mkdir -p "$out"
run() {  # name seed trace
    python3 perfbench/run.py --workload "$cell" --seed "$2" --seconds "$seconds" \
        --trace "$3" > "$out/$1.out" 2> "$out/$1.err"
    echo "$cell $1 seed $2 trace $3 rc $? $(tail -c 300 "$out/$1.out" | tr -d '\n' | cut -c1-300)"
}
run first 7 0
for set in a b; do
    for s in $seeds; do run "$set-$s" "$s" 0; done
done
for s in $traced; do run "trace-$s" "$s" 1; done
