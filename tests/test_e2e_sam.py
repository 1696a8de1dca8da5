"""End-to-end SAM identity vs bwa-mem goldens (subsets for CI speed), on
the hg19.small index and HCC1187C reads they were made from.

The full-10K identity runs are covered by test_full_10k (marked slow); the
default suite uses the 1K golden subsets.
"""

import pytest

from mpibwa_tpu.core.fm import FMIndex
from mpibwa_tpu.core.opts import MEM_F_PE, mem_opt_init
from mpibwa_tpu.core.pipeline import process_seqs
from mpibwa_tpu.core.refseq import RefSeq
from mpibwa_tpu.io.fastq import interleave, read_fastq



@pytest.fixture(scope="module")
def engines(golden_index):
    return FMIndex.from_index(golden_index), RefSeq(golden_index)


def _diff(got: str, want: str) -> str:
    gl, wl = got.splitlines(), want.splitlines()
    for i, (g, w) in enumerate(zip(gl, wl)):
        if g != w:
            return f"line {i}:\n got: {g[:220]}\nwant: {w[:220]}"
    return f"line counts differ: got {len(gl)} want {len(wl)}"


def test_se_200(engines, golden_dir, golden_fastq):
    fm, refs = engines
    opt = mem_opt_init()
    seqs = read_fastq(golden_fastq("HCC1187C_R1_10K.fastq"), limit=200)
    process_seqs(opt, fm, refs, seqs)
    got = "".join(s.sam for s in seqs)
    names = {s.name for s in seqs}
    want = "".join(
        l for l in open(golden_dir / "se_1k.sam").read().splitlines(keepends=True)
        if l.split("\t", 1)[0] in names)
    assert got == want, _diff(got, want)


def test_pe_1k(engines, golden_dir, golden_fastq):
    """PE identity on the 1K-pair batch (pestat is batch-scoped, so the
    golden was generated with exactly this batch)."""
    fm, refs = engines
    opt = mem_opt_init()
    opt.flag |= MEM_F_PE
    r1 = read_fastq(golden_fastq("HCC1187C_R1_10K.fastq"), limit=1000)
    r2 = read_fastq(golden_fastq("HCC1187C_R2_10K.fastq"), limit=1000)
    seqs = interleave(r1, r2)
    process_seqs(opt, fm, refs, seqs)
    got = "".join(s.sam for s in seqs)
    want = (golden_dir / "pe_1k.sam").read_text()
    assert got == want, _diff(got, want)


@pytest.mark.slow
def test_full_10k_se(engines, golden_dir, golden_fastq):
    fm, refs = engines
    opt = mem_opt_init()
    seqs = read_fastq(golden_fastq("HCC1187C_R1_10K.fastq"))
    process_seqs(opt, fm, refs, seqs)
    got = "".join(s.sam for s in seqs)
    want = (golden_dir / "se_10k.sam").read_text()
    assert got == want, _diff(got, want)


@pytest.mark.slow
def test_full_10k_pe(engines, golden_dir, golden_fastq):
    fm, refs = engines
    opt = mem_opt_init()
    opt.flag |= MEM_F_PE
    seqs = interleave(read_fastq(golden_fastq("HCC1187C_R1_10K.fastq")),
                      read_fastq(golden_fastq("HCC1187C_R2_10K.fastq")))
    process_seqs(opt, fm, refs, seqs)
    got = "".join(s.sam for s in seqs)
    want = (golden_dir / "pe_10k.sam").read_text()
    assert got == want, _diff(got, want)


def test_pe_1k_trim(engines, golden_dir, golden_fastq):
    """Trimmed (variable-length) PE identity — the mainParallel.c:1520-2556
    branch's read shape. Golden from the oracle on the first 1K pairs of
    the bundled *_TRIM fastqs."""
    fm, refs = engines
    opt = mem_opt_init()
    opt.flag |= MEM_F_PE
    r1 = read_fastq(golden_fastq("HCC1187C_R1_10K_TRIM.fastq"), limit=1000)
    r2 = read_fastq(golden_fastq("HCC1187C_R2_10K_TRIM.fastq"), limit=1000)
    seqs = interleave(r1, r2)
    process_seqs(opt, fm, refs, seqs)
    got = "".join(s.sam for s in seqs)
    want = (golden_dir / "pe_1k_trim.sam").read_text()
    assert got == want, _diff(got, want)


@pytest.mark.slow
def test_full_10k_pe_trim(engines, golden_dir, golden_fastq):
    """Full trimmed-PE file vs the reference engine
    (find_chunks_info_trim input shape, parallel_aux.c:861)."""
    fm, refs = engines
    opt = mem_opt_init()
    opt.flag |= MEM_F_PE
    seqs = interleave(read_fastq(golden_fastq("HCC1187C_R1_10K_TRIM.fastq")),
                      read_fastq(golden_fastq("HCC1187C_R2_10K_TRIM.fastq")))
    process_seqs(opt, fm, refs, seqs)
    got = "".join(s.sam for s in seqs)
    want = (golden_dir / "pe_10k_trim.sam").read_text()
    assert got == want, _diff(got, want)


def test_pe_trim_device(golden_index, golden_dir, golden_fastq):
    """Trimmed-PE identity through the device pipeline (variable-length
    reads exercise the length-bucket padding paths)."""
    from mpibwa_tpu.core.opts import mem_opt_init
    from mpibwa_tpu.pipeline.device_align import DeviceAligner

    opt = mem_opt_init()
    opt.flag |= MEM_F_PE
    al = DeviceAligner(golden_index, opt)
    r1 = read_fastq(golden_fastq("HCC1187C_R1_10K_TRIM.fastq"), limit=1000)
    r2 = read_fastq(golden_fastq("HCC1187C_R2_10K_TRIM.fastq"), limit=1000)
    seqs = interleave(r1, r2)
    al.process_seqs(seqs, n_processed=0)
    got = "".join(s.sam for s in seqs)
    want = (golden_dir / "pe_1k_trim.sam").read_text()
    assert got == want, _diff(got, want)


def test_pe_1k_device(golden_index, golden_dir, golden_fastq):
    """PE identity through the device pipeline (same 1K-pair batch as
    test_pe_1k: pestat is batch-scoped so the golden matches exactly)."""
    from mpibwa_tpu.core.opts import mem_opt_init
    from mpibwa_tpu.pipeline.device_align import DeviceAligner

    opt = mem_opt_init()
    opt.flag |= MEM_F_PE
    al = DeviceAligner(golden_index, opt)
    r1 = read_fastq(golden_fastq("HCC1187C_R1_10K.fastq"), limit=1000)
    r2 = read_fastq(golden_fastq("HCC1187C_R2_10K.fastq"), limit=1000)
    seqs = interleave(r1, r2)
    al.process_seqs(seqs, n_processed=0)
    got = "".join(s.sam for s in seqs)
    want = (golden_dir / "pe_1k.sam").read_text()
    assert got == want, _diff(got, want)


def test_se_300_T20(engines, golden_dir, golden_fastq):
    """-T (score threshold) option parity (mainParallel.c:318)."""
    fm, refs = engines
    opt = mem_opt_init()
    opt.T = 20
    seqs = read_fastq(golden_fastq("HCC1187C_R1_10K.fastq"), limit=300)
    process_seqs(opt, fm, refs, seqs)
    got = "".join(s.sam for s in seqs)
    want = (golden_dir / "se_300_T20.sam").read_text()
    assert got == want, _diff(got, want)


def test_se_300_all_hits(engines, golden_dir, golden_fastq):
    """-a (output all hits as secondary) parity (MEM_F_ALL paths in
    mem_reg2sam / mem_gen_alt)."""
    from mpibwa_tpu.core.opts import MEM_F_ALL

    fm, refs = engines
    opt = mem_opt_init()
    opt.flag |= MEM_F_ALL
    seqs = read_fastq(golden_fastq("HCC1187C_R1_10K.fastq"), limit=300)
    process_seqs(opt, fm, refs, seqs)
    got = "".join(s.sam for s in seqs)
    want = (golden_dir / "se_300_a.sam").read_text()
    assert got == want, _diff(got, want)


@pytest.mark.parametrize("golden,setup", [
    ("se_300_k25.sam", lambda o: setattr(o, "min_seed_len", 25)),    # -k25
    ("se_300_L10.sam", lambda o: (setattr(o, "pen_clip5", 10),       # -L10
                                  setattr(o, "pen_clip3", 10))),
])
def test_se_300_option_variants(engines, golden_dir, golden, setup,
                                golden_fastq):
    """Option parity for -k (min seed len) and -L (clipping penalty)
    against oracle goldens."""
    fm, refs = engines
    opt = mem_opt_init()
    setup(opt)
    seqs = read_fastq(golden_fastq("HCC1187C_R1_10K.fastq"), limit=300)
    process_seqs(opt, fm, refs, seqs)
    got = "".join(s.sam for s in seqs)
    want = (golden_dir / golden).read_text()
    assert got == want, _diff(got, want)


def test_se_softclip_supplementary(engines, golden_dir):
    """-Y parity (soft-clip instead of hard-clip on supplementary
    alignments), on the subset of reads that actually produce SA: splits."""
    from mpibwa_tpu.core.opts import MEM_F_SOFTCLIP

    fm, refs = engines
    opt = mem_opt_init()
    opt.flag |= MEM_F_SOFTCLIP
    seqs = read_fastq(str(golden_dir / "supp_reads.fq"))
    process_seqs(opt, fm, refs, seqs)
    got = "".join(s.sam for s in seqs)
    want = (golden_dir / "se_supp_Y.sam").read_text()
    assert got == want, _diff(got, want)
