#!/bin/bash
# Multi-process scaling (the `mpirun -n N mpiBWA` analog): one process per
# shard, then a deterministic chunk-order merge. Output is byte-identical
# to the single-process run for any shard count. Run one shard per card
# (`cli launch -n N` pins them); within one process, MPIBWA_DEVICES=all
# fans chunks over the local cards instead.
set -euo pipefail
HERE=$(cd "$(dirname "$0")" && pwd)
REPO=$(dirname "$HERE")
N=${N:-2}
WORK=${WORK:-${TMPDIR:-/tmp}/mpibwa_example}
GENOME_BP=${GENOME_BP:-5000000}
PAIRS=${PAIRS:-10000}

cd "$REPO"
if [ ! -f "$WORK/genome.fa.bwt" ]; then
    # seeded genome + 2x150 pairs (mpibwa_tpu/io/simulate.py), then its index
    python -m mpibwa_tpu.io.simulate "$WORK" --genome-bp "$GENOME_BP" \
        --pairs "$PAIRS"
    python -m mpibwa_tpu.cli index "$WORK/genome.fa"
fi

pids=()
for i in $(seq 0 $((N - 1))); do
    CUDA_VISIBLE_DEVICES=$i MPIBWA_SHARD=$i MPIBWA_NSHARDS=$N \
        python -m mpibwa_tpu.cli mem -K 3000000 -o "$WORK/shard$i" \
        "$WORK/genome.fa" "$WORK/r1.fq" &
    pids+=($!)
done
for p in "${pids[@]}"; do wait "$p"; done

shards=()
for i in $(seq 0 $((N - 1))); do shards+=("$WORK/shard$i.sam"); done
python -m mpibwa_tpu.cli merge "$WORK/merged.sam" "${shards[@]}"
echo "output: $WORK/merged.sam"
