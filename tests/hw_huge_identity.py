"""GPU identity slice at GRCh38 scale (>= 2^31 positions).

Run OUTSIDE pytest (tests/conftest.py pins the CPU backend process-wide):
    python tests/hw_huge_identity.py <prefix> <reads.fastq> <want.sam>

Loads a >= 2^31-position index onto the GPU (int64 position path),
aligns the reads through the default device engines, and byte-compares
the SAM to the oracle output the caller produced. Prints the measured
device-resident index bytes. Exit codes: 0 identity, 2 no GPU, 1
mismatch/failure. This is the on-hardware half of BASELINE config 3.
"""

import sys

import numpy as np


def main() -> int:
    prefix, fq, want_path = sys.argv[1], sys.argv[2], sys.argv[3]
    import jax

    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX backend is {jax.default_backend()}",
              file=sys.stderr)
        return 2
    import jax.numpy as jnp

    from mpibwa_tpu.core.opts import mem_opt_init
    from mpibwa_tpu.index.format import load_index
    from mpibwa_tpu.io.fastq import read_fastq
    from mpibwa_tpu.ops.fmd import DeviceFMIndex
    from mpibwa_tpu.pipeline.device_align import DeviceAligner

    idx = load_index(prefix)
    assert idx.seq_len >= (1 << 31), "not a GRCh38-scale index"
    dfm = DeviceFMIndex(idx)
    assert dfm.idt == jnp.int64  # the real int64 path on real hardware
    hbm = (np.asarray(dfm.o2_tables()).nbytes + np.asarray(dfm.sa).nbytes
           + np.asarray(dfm.pac).nbytes)
    print(f"device index bytes: {hbm} "
          f"({hbm / idx.seq_len:.3f} B/base at seq_len {idx.seq_len})",
          file=sys.stderr, flush=True)
    al = DeviceAligner(idx, mem_opt_init(), dfm=dfm)
    reads = read_fastq(fq)
    al.process_seqs(reads, 0)
    got = "".join(s.sam for s in reads)
    want = open(want_path).read()
    if got != want:
        print("MISMATCH vs oracle", file=sys.stderr)
        return 1
    print(f"IDENTITY OK on {jax.default_backend()} "
          f"({len(reads)} reads, seq_len {idx.seq_len})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
