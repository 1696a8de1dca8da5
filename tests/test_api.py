"""Library API surface (bwamem_extra.c parity): mem_align1 + SMEM iterator."""

import numpy as np

from mpibwa_tpu.api import Aligner
from mpibwa_tpu.io.fastq import read_fastq



def test_align1_and_smem_iter(index, r1_path):
    al = Aligner(index)
    reads = read_fastq(r1_path, limit=8)
    n_mapped = 0
    for s in reads:
        seq = "".join("ACGTN"[min(c, 4)] for c in s.seq)
        regs = al.align1(seq)
        if regs:  # unmapped reads on the small reference yield []
            n_mapped += 1
            # primary marking ran: a non-secondary entry leads
            assert regs[0].secondary == -1
            assert all(r.qb < r.qe and r.rb < r.re for r in regs)
        # SMEM iterator: every yielded batch covers its start position and
        # every mem is a (x0, x1, x2, info) tuple with sane bounds
        total = 0
        for mems in al.smem_iter(seq):
            for x0, x1, x2, info in mems:
                st, en = info >> 32, info & 0xFFFFFFFF
                assert 0 <= st < en <= len(seq)
                assert x2 > 0
                total += 1
        assert total > 0, s.name
    assert n_mapped > 0
