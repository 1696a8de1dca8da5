"""The seeded genome and read simulator (mpibwa_tpu/io/simulate.py)."""

import numpy as np
import pytest

from mpibwa_tpu.io import simulate as S

SMALL = S.GenomeSpec(contig_lengths=(400_000, 150_000), seed=11)


@pytest.fixture(scope="module")
def genome():
    return S.simulate_genome(SMALL)


def test_genome_deterministic(genome):
    again = S.simulate_genome(SMALL)
    assert [n for n, _ in again] == ["chr1", "chr2"]
    for (_, a), (_, b) in zip(genome, again):
        assert np.array_equal(a, b)
    other = S.simulate_genome(S.GenomeSpec(contig_lengths=(400_000, 150_000),
                                           seed=12))
    assert not np.array_equal(genome[0][1], other[0][1])


def test_genome_shape(genome):
    assert [len(g) for _, g in genome] == [400_000, 150_000]
    for _, g in genome:
        assert g.dtype == np.uint8 and g.max() <= 4
        L = len(g)
        # telomeres and the centromere-like run are N
        assert (g[: min(10_000, L // 200)] == 4).all()
        assert (g[L - min(10_000, L // 200):] == 4).all()
        c0 = int(L * 0.49) - (L // 100) // 2
        assert (g[c0 : c0 + L // 100] == 4).all()
        acgt = g[g < 4]
        gc = np.isin(acgt, (1, 2)).mean()
        assert 0.38 < gc < 0.44


def test_repeats_raise_kmer_multiplicity(genome):
    """Half the sequence in repeat families: far more repeated 24-mers
    than an i.i.d. background of the same length has."""
    def repeated_kmers(g, k=24):
        g = g[g < 4].astype(np.uint64)
        h = np.zeros(len(g) - k + 1, np.uint64)
        for i in range(k):
            h = (h << np.uint64(2)) | g[i : len(g) - k + 1 + i]
        _, counts = np.unique(h, return_counts=True)
        return counts[counts > 1].sum() / len(h)

    rep = repeated_kmers(genome[0][1])
    flat = S.simulate_genome(S.GenomeSpec(contig_lengths=(400_000,),
                                          repeat_frac=0.0, seed=11))
    assert rep > 0.02 and repeated_kmers(flat[0][1]) < 0.001


@pytest.mark.parametrize("read_len", [101, 150])
def test_reads_carry_their_truth(genome, read_len):
    """With no errors and no mutations every read is the reference at its
    named position and strand; qualities have the read's length."""
    spec = S.ReadSpec(read_len=read_len, error_rate=0.0, mut_rate=0.0)
    names, r1, r2, q1, q2 = S.simulate_pairs(genome, 300, spec, seed=3)
    assert r1.shape == r2.shape == q1.shape == q2.shape == (300, read_len)
    ref = dict(genome)
    for i, name in enumerate(names):
        contig, p1, p2, fwd1 = S.parse_truth(name)
        g = ref[contig]
        for seq, pos, fwd in ((r1[i], p1, fwd1), (r2[i], p2, not fwd1)):
            window = g[pos - 1 : pos - 1 + read_len]
            want = window if fwd else (3 - window)[::-1]
            assert np.array_equal(seq, want), name
            assert (window < 4).all()  # fragments avoid N gaps


def test_reads_deterministic_and_noisy(genome):
    a = S.simulate_pairs(genome, 500, seed=5)
    b = S.simulate_pairs(genome, 500, seed=5)
    assert a[0] == b[0] and np.array_equal(a[1], b[1])
    names, r1 = a[0], a[1]
    # ~2% sequencing error (+ mutations) against the true window
    ref = dict(genome)
    mism = total = 0
    for i, name in enumerate(names[:200]):
        contig, p1, _, fwd1 = S.parse_truth(name)
        w = ref[contig][p1 - 1 : p1 + 149]
        want = w if fwd1 else (3 - w)[::-1]
        mism += int((r1[i] != want).sum())
        total += 150
    assert 0.01 < mism / total < 0.06
    # insert sizes around 500
    isz = [abs(S.parse_truth(n)[2] - S.parse_truth(n)[1]) + 150
           for n in names]
    assert 470 < np.mean(isz) < 530


def test_fastq_and_truth_share(genome, tmp_path):
    from mpibwa_tpu.io.fastq import read_fastq

    names, r1, r2, q1, q2 = S.simulate_pairs(genome, 20, seed=1)
    p = tmp_path / "r1.fq"
    S.write_fastq(str(p), names, r1, q1, 1)
    got = read_fastq(str(p))
    assert [s.name for s in got] == names
    assert np.array_equal(got[3].seq, r1[3])
    # a SAM with one read at its origin, one elsewhere, one unmapped
    c, p1, _, fwd1 = S.parse_truth(names[0])
    flag = 0x40 | (0 if fwd1 else 0x10)
    sam = tmp_path / "x.sam"
    sam.write_text(
        "@SQ\tSN:chr1\tLN:1\n"
        f"{names[0]}\t{flag}\t{c}\t{p1 + 3}\t60\t*\n"
        f"{names[1]}\t{0x40}\tchr2\t5\t60\t*\n"
        f"{names[2]}\t{0x44}\t*\t0\t0\t*\n"
        f"{names[0]}\t{flag | 0x800}\t{c}\t1\t0\t*\n")
    assert S.truth_share(str(sam)) == (1, 3)
