#!/usr/bin/env bash
# Multi-host distribution: the `mpirun -hostfile hosts mpiBWA` analog.
#
# Shards round-robin over the hosts via ssh (override with --rsh); the
# reference prefix, FASTQ inputs and OUT must live on a filesystem shared
# by every host (the same requirement mpiBWA's MPI-IO output has). Each
# shard aligns its deterministic slice of the chunk sequence on its own
# host's GPU(s); the launcher merges the per-shard extents into one file.
#
# Usage: ./multi_host.sh "host1,host2" OUT REF R1.fastq [R2.fastq]
# (hosts of "localhost,localhost" exercise the same code path with two
# local process groups — handy for a smoke test without a cluster.)
set -euo pipefail
cd "$(dirname "$0")/.."

HOSTS=${1:?comma-separated host list}
OUT=${2:?output prefix}
REF=${3:?reference prefix}
R1=${4:?R1 fastq}
R2=${5:-}

python3 -m mpibwa_tpu.cli launch --hosts "$HOSTS" mem -o "$OUT" "$REF" "$R1" ${R2:+"$R2"}
echo "wrote $OUT.sam"
