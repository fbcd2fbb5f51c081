#!/bin/bash
# Runs of the port's benchmark from one or more checkouts, each from its
# checkout's root, for --seconds the benchmark's run_seconds; a traced
# run goes through tools/stage_breakdown.py.
#
#   bash tools/stage_runs.sh OUT TAG:DIR:WORKLOAD:SEED:TRACE ...
#
# Writes OUT/<tag>_<workload>_<seed>_t<trace>.{out,err} and prints, for
# each run, its exit code and seconds, the result line, the PROBE lines
# and the harness's steps by kind and rows over the window.  Compare two
# checkouts in one call (parent, change, change, parent), so that both
# meet one card.  Needs a card.
set -u
here=$(cd "$(dirname "$0")" && pwd)
seconds=$(python3 -c 'import json, sys; print(json.load(open(sys.argv[1]))["run_seconds"])' "$here/../BENCHMARK.json")
mkdir -p "$1"
out=$(cd "$1" && pwd)
shift
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for spec in "$@"; do
  IFS=: read -r tag dir wl seed tr <<< "$spec"
  f=$out/${tag}_${wl}_${seed}_t${tr}
  if [ "$tr" = 1 ]; then prog=$here/stage_breakdown.py; else prog=cardbench/run.py; fi
  t0=$(date +%s)
  (cd "$dir" && timeout 600 python3 "$prog" --workload "$wl" --seed "$seed" \
     --seconds "$seconds" --trace "$tr") > "$f.out" 2> "$f.err"
  rc=$?
  echo "== $tag $wl $seed t$tr rc=$rc $(( $(date +%s) - t0 ))s"
  tail -n 1 "$f.out" | cut -c1-3000
  grep '^PROBE' "$f.err" | cut -c1-2500
  grep -o 'steps by kind and rows.*' "$f.err"
  if [ $rc -ne 0 ]; then tail -n 5 "$f.err"; fi
done
true
