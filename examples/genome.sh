#!/bin/bash
# Index construction from FASTA (the reference's examples/genome.sh:
# bwa index + mpiBWAIdx). Our builder reproduces bwa's artifacts
# byte-identically and then packs the flat .tpumap image.
set -euo pipefail
HERE=$(cd "$(dirname "$0")" && pwd)
REPO=$(dirname "$HERE")
WORK=${WORK:-${TMPDIR:-/tmp}/mpibwa_example}
GENOME_BP=${GENOME_BP:-5000000}

cd "$REPO"
python -m mpibwa_tpu.io.simulate "$WORK" --genome-bp "$GENOME_BP" --pairs 1
python -m mpibwa_tpu.cli index "$WORK/genome.fa"   # .bwt/.sa/.ann/.amb/.pac
python -m mpibwa_tpu.cli idx "$WORK/genome.fa"     # .tpumap flat image
ls -la "$WORK"
