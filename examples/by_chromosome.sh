#!/bin/bash
# Per-chromosome output fan-out (the mpiBWAByChr equivalent): one file per
# contig plus discordant + unmapped, each with a full header; with -f the
# discordant file is dropped and fixmate is applied.
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

python -m mpibwa_tpu.cli membychr -o "$WORK/by_chr" "$WORK/genome.fa" \
    "$WORK/r1.fq" "$WORK/r2.fq"
ls -la "$WORK/by_chr"
