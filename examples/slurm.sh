#!/usr/bin/env bash
#SBATCH --job-name=mpibwa-tpu
#SBATCH --nodes=4                 # one shard per GPU host
#SBATCH --ntasks-per-node=1
#SBATCH --time=04:00:00
# Slurm launcher for a GPU cluster (the examples/slurm.sh analog of the
# reference). Every node runs one shard against its local cards
# (MPIBWA_DEVICES=all); inputs + OUT live on the shared filesystem.
set -euo pipefail

REF=${REF:?reference prefix}
R1=${R1:?R1 fastq}
R2=${R2:-}
OUT=${OUT:?output prefix}

export MPIBWA_DEVICES=all
export MPIBWA_NSHARDS=$SLURM_JOB_NUM_NODES

srun --ntasks="$SLURM_JOB_NUM_NODES" bash -c '
  export MPIBWA_SHARD=$SLURM_PROCID
  python3 -m mpibwa_tpu.cli mem -o "'"$OUT"'.shard$SLURM_PROCID" \
      "'"$REF"'" "'"$R1"'" '"${R2:+\"$R2\"}"'
'
# deterministic extent merge on the launching node
python3 -m mpibwa_tpu.cli merge "$OUT" "$OUT".shard*.sam
