#!/bin/bash
# Paired-end alignment of a generated read set (the equivalent of the
# reference's examples/standard.sh mpirun invocation).
set -euo pipefail
HERE=$(cd "$(dirname "$0")" && pwd)
REPO=$(dirname "$HERE")
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

python -m mpibwa_tpu.cli mem -t 8 -o "$WORK/pe" "$WORK/genome.fa" \
    "$WORK/r1.fq" "$WORK/r2.fq"
echo "output: $WORK/pe.sam"
