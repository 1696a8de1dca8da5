#!/usr/bin/env bash
#PBS -N mpibwa-tpu
#PBS -l nodes=4:ppn=1
#PBS -l walltime=04:00:00
# PBS launcher for a GPU cluster (the examples/pbs.sh analog of the
# reference): one shard per node via the ssh-based launch mode; inputs and
# OUT live on the shared filesystem.
set -euo pipefail
cd "$PBS_O_WORKDIR"

REF=${REF:?reference prefix}
R1=${R1:?R1 fastq}
R2=${R2:-}
OUT=${OUT:?output prefix}

HOSTS=$(sort -u "$PBS_NODEFILE" | paste -sd,)
MPIBWA_DEVICES=all python3 -m mpibwa_tpu.cli launch --hosts "$HOSTS" \
    mem -o "$OUT" "$REF" "$R1" ${R2:+"$R2"}
