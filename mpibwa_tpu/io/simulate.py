"""Seeded genome and read simulator: the repository's only input source.

Genome: contigs of given lengths (default: one contig of GRCh38 chr1's
length, 248,956,422 bp, NCBI NC_000001.11) over an i.i.d. background at
41% GC, with N gaps (telomere runs at both ends, one centromere-like run of
1% of the contig near its middle, and one short gap per 20 Mbp) and
interspersed repeat families covering `repeat_frac` of the sequence (about
half of a human genome, IHGSC 2001, Nature 409:860):

- L1-like: 6 kbp consensus, three subfamilies, copies 5'-truncated;
- Alu-like: 300 bp consensus, three subfamilies, mostly full length;
- other interspersed (LTR/DNA-transposon-like): eight 0.4-3 kbp consensus
  sequences, copies of random fragments;
- simple and tandem repeats: 1-6 bp and 10-60 bp units in arrays.

Each copy lands on either strand with 5-20% substitution divergence from
its subfamily consensus (tandem arrays: 2-10%). Copies overwrite the
background at uniform positions, so later copies nest into earlier ones.

Reads: paired-end under samtools wgsim's model: fragment length
N(insert, insert_sd), base error rate 0.02, mutation rate 0.001 of which a
fraction 0.15 are indels (extension probability 0.3), read 1 taken from
the forward strand at the fragment start or, with probability 1/2, from
the reverse strand at its end. Mutations are drawn per read instead of on
one shared haplotype (reads of a pair do not overlap at the default
insert). Fragments that touch an N gap are redrawn.

Read names carry the truth: ``{contig}_{pos1}_{pos2}_{strand}_{i}`` where
pos1/pos2 are the 1-based leftmost reference positions of read 1 and read
2 and strand is ``f`` when read 1 is on the forward strand, ``r``
otherwise. Quality strings are drawn from real HCC1187C records
(hcc1187c_quals.txt.gz: 2,000 read-1 and 2,000 read-2 strings of 101
bases, sampled from the primary records of the repository's bwa-mem
golden output); reads longer than 101 bases get the first 101 qualities
of one string followed by the last qualities of another.

Everything is a function of the seed.
"""

from __future__ import annotations

import dataclasses
import gzip
import math
import os
from typing import List, Sequence, Tuple

import numpy as np

CHR1_LEN = 248_956_422  # GRCh38 chr1, NC_000001.11

_LETTERS = np.frombuffer(b"ACGTN", np.uint8)
_QUALS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "hcc1187c_quals.txt.gz")


@dataclasses.dataclass(frozen=True)
class GenomeSpec:
    contig_lengths: Tuple[int, ...] = (CHR1_LEN,)
    repeat_frac: float = 0.5
    gc: float = 0.41
    seed: int = 1


@dataclasses.dataclass(frozen=True)
class ReadSpec:
    read_len: int = 150
    insert: int = 500
    insert_sd: int = 50
    error_rate: float = 0.02
    mut_rate: float = 0.001
    indel_frac: float = 0.15
    indel_ext: float = 0.3


# repeat classes: (share of the repeat bases, kind, subfamilies)
_CLASSES = (
    (0.40, "l1", 3),
    (0.25, "alu", 3),
    (0.25, "other", 8),
    (0.10, "tandem", 0),
)


def _background(rng, n: int, gc: float) -> np.ndarray:
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return rng.choice(4, size=n, p=p).astype(np.uint8)


def _diverge(rng, seq: np.ndarray, rate: float) -> np.ndarray:
    """Substitute each base with probability rate (to another base)."""
    hit = rng.random(len(seq)) < rate
    out = seq.copy()
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()))) & 3
    return out


def _segments(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenated index ranges [starts[i], starts[i] + lens[i])."""
    off = np.cumsum(lens) - lens
    return np.repeat(starts - off, lens) + np.arange(int(lens.sum()))


def _place(rng, genome: np.ndarray, src: np.ndarray, cstart: np.ndarray,
           clen: np.ndarray, div_lo: float, div_hi: float) -> None:
    """Copy src[cstart:cstart+clen] to uniform positions of genome, on a
    random strand, with per-copy divergence in [div_lo, div_hi)."""
    L = len(genome)
    ok = clen < L
    cstart, clen = cstart[ok], clen[ok]
    n = len(clen)
    if n == 0:
        return
    dst = rng.integers(0, L - clen + 1)
    rev = rng.random(n) < 0.5
    div = rng.uniform(div_lo, div_hi, n)
    # bounded memory: place in batches of ~16 M bases
    i = 0
    while i < n:
        j = i + 1
        tot = int(clen[i])
        while j < n and tot + clen[j] <= (1 << 24):
            tot += int(clen[j])
            j += 1
        cl = clen[i:j]
        k = _segments(np.zeros(j - i, np.int64), cl)  # offset in copy
        cid = np.repeat(np.arange(i, j), cl)
        fwd_pos = cstart[cid] + k
        rev_pos = cstart[cid] + clen[cid] - 1 - k
        b = np.where(rev[cid], 3 - src[rev_pos], src[fwd_pos])
        hit = rng.random(len(b)) < div[cid]
        b[hit] = (b[hit] + rng.integers(1, 4, int(hit.sum()))) & 3
        genome[dst[cid] + k] = b
        i = j


def _add_repeats(rng, genome: np.ndarray, frac: float) -> None:
    if frac <= 0:
        return
    L = len(genome)
    # coverage that leaves a share `frac` covered under uniform overwrites
    cover = -math.log(1.0 - min(frac, 0.95)) * L
    for share, kind, n_sub in _CLASSES:
        want = share * cover
        if kind == "tandem":
            mean = 150.0
            n = max(int(want / mean), 1)
            unit = np.where(rng.random(n) < 0.6, rng.integers(1, 7, n),
                            rng.integers(10, 61, n))
            alen = np.clip(rng.exponential(mean, n).astype(np.int64),
                           30, 2000)
            units = rng.integers(0, 4, int(unit.sum())).astype(np.uint8)
            uoff = np.cumsum(unit) - unit
            # expand each array as its unit repeated: one source buffer
            k = _segments(np.zeros(n, np.int64), alen)
            aid = np.repeat(np.arange(n), alen)
            src = units[uoff[aid] + k % unit[aid]]
            cstart = np.cumsum(alen) - alen
            _place(rng, genome, src, cstart, alen, 0.02, 0.10)
            continue
        if kind == "l1":
            clen_c, mean = 6000, 1000.0
        elif kind == "alu":
            clen_c, mean = 300, 270.0
        else:
            clen_c, mean = None, 500.0
        master = _background(rng, clen_c or 3000, 0.41)
        cons = []
        for s in range(n_sub):
            if kind == "other":
                ln = int(rng.integers(400, 3001))
                cons.append(_background(rng, ln, 0.41))
            else:
                cons.append(_diverge(rng, master, 0.03 + 0.02 * s))
        src = np.concatenate(cons)
        coff = np.cumsum([len(c) for c in cons]) - [len(c) for c in cons]
        clens = np.array([len(c) for c in cons], np.int64)
        n = max(int(want / mean), 1)
        sub = rng.integers(0, n_sub, n)
        if kind == "l1":  # 5'-truncated: keep a 3' suffix
            ln = np.clip(rng.exponential(mean, n).astype(np.int64), 100,
                         clen_c)
            st = coff[sub] + clens[sub] - ln
        elif kind == "alu":
            ln = np.where(rng.random(n) < 0.8, clens[sub],
                          rng.integers(150, 301, n))
            ln = np.minimum(ln, clens[sub])
            st = coff[sub] + clens[sub] - ln
        else:
            ln = np.minimum(np.clip(rng.exponential(mean, n)
                                    .astype(np.int64), 100, None),
                            clens[sub])
            st = coff[sub] + (rng.random(n) * (clens[sub] - ln + 1)
                              ).astype(np.int64)
        _place(rng, genome, src, st.astype(np.int64), ln.astype(np.int64),
               0.05, 0.20)


def _add_gaps(rng, genome: np.ndarray) -> None:
    """N runs (code 4): telomeres, one centromere-like run, short gaps."""
    L = len(genome)
    tel = min(10_000, L // 200)
    genome[:tel] = 4
    genome[L - tel:] = 4
    cen = L // 100
    c0 = int(L * 0.49) - cen // 2
    genome[c0 : c0 + cen] = 4
    for _ in range(L // 20_000_000):
        ln = int(rng.integers(1_000, 50_001))
        p = int(rng.integers(0, L - ln))
        genome[p : p + ln] = 4


def simulate_genome(spec: GenomeSpec = GenomeSpec()
                    ) -> List[Tuple[str, np.ndarray]]:
    """[(name, uint8 codes 0-3, 4 = N)] for every contig of spec."""
    rng = np.random.default_rng([spec.seed, 0x6E6F6D65])
    out = []
    for ci, L in enumerate(spec.contig_lengths):
        g = _background(rng, int(L), spec.gc)
        _add_repeats(rng, g, spec.repeat_frac)
        _add_gaps(rng, g)
        out.append((f"chr{ci + 1}", g))
    return out


def write_fasta(path: str, contigs, width: int = 60) -> None:
    with open(path, "wb") as f:
        for name, g in contigs:
            f.write(b">" + name.encode() + b"\n")
            txt = _LETTERS[g]
            n_full = len(txt) // width
            body = np.empty((n_full, width + 1), np.uint8)
            body[:, :width] = txt[: n_full * width].reshape(n_full, width)
            body[:, width] = 10
            f.write(body.tobytes())
            if len(txt) % width:
                f.write(txt[n_full * width :].tobytes() + b"\n")


def _quality_pool():
    r1, r2 = [], []
    with gzip.open(_QUALS, "rt") as f:
        for line in f:
            mate, q = line.rstrip("\n").split("\t")
            (r1 if mate == "1" else r2).append(q.encode())
    return (np.frombuffer(b"".join(r1), np.uint8).reshape(len(r1), -1),
            np.frombuffer(b"".join(r2), np.uint8).reshape(len(r2), -1))


def _qualities(rng, pool: np.ndarray, n: int, read_len: int) -> np.ndarray:
    W = pool.shape[1]
    a = pool[rng.integers(0, len(pool), n)]
    if read_len <= W:
        return a[:, :read_len]
    b = pool[rng.integers(0, len(pool), n)]
    tail = read_len - W
    if tail > W:
        raise ValueError(f"read length above {2 * W} unsupported")
    return np.concatenate([a, b[:, W - tail :]], axis=1)


def _indel_read(rng, ref: np.ndarray, start: int, n: int, spec: ReadSpec,
                rev: bool) -> np.ndarray:
    """n bases of ref from start (forward) or ending at start (reverse,
    walking left) with one wgsim-style indel in the read."""
    ln = 1
    while rng.random() < spec.indel_ext:
        ln += 1
    at = int(rng.integers(1, n - 1))
    if rng.random() < 0.5:  # deletion from the reference
        span = n + ln
        seg = (ref[start : start + span] if not rev
               else ref[max(start - span, 0) : start][::-1])
        seg = np.concatenate([seg[:at], seg[at + ln :]])
    else:  # insertion of random bases
        seg = (ref[start : start + n] if not rev
               else ref[max(start - n, 0) : start][::-1])
        seg = np.concatenate([seg[:at], rng.integers(0, 4, ln)
                              .astype(np.uint8), seg[at:]])
    seg = seg[:n]
    if len(seg) < n or (seg > 3).any():
        return None
    return seg


def simulate_pairs(contigs, n_pairs: int, spec: ReadSpec = ReadSpec(),
                   seed: int = 1):
    """Returns (names, r1 codes (n, L), r2 codes (n, L), q1, q2) with the
    truth in the names (see the module docstring)."""
    rng = np.random.default_rng([seed, 0x72656164])
    L = spec.read_len
    lens = np.array([len(g) for _, g in contigs], np.int64)
    cum = np.concatenate([[0], np.cumsum(lens)])
    allg = np.concatenate([g for _, g in contigs])
    # N prefix counts: a fragment is clean iff it covers no N
    npref = np.concatenate([[0], np.cumsum(allg > 3)])
    starts, isz, cid = [], [], []
    need = n_pairs
    while need > 0:
        m = int(need * 1.3) + 64
        iz = np.maximum(np.rint(rng.normal(spec.insert, spec.insert_sd, m))
                        .astype(np.int64), L)
        c = np.searchsorted(cum, rng.integers(0, cum[-1], m), "right") - 1
        room = lens[c] - iz
        ok = room > 0
        s = cum[c] + (rng.random(m) * np.maximum(room, 1)).astype(np.int64)
        ok &= (npref[np.minimum(s + iz, cum[-1])] - npref[s]) == 0
        s, iz, c = s[ok][:need], iz[ok][:need], c[ok][:need]
        starts.append(s)
        isz.append(iz)
        cid.append(c)
        need -= len(s)
    s = np.concatenate(starts)
    iz = np.concatenate(isz)
    c = np.concatenate(cid)
    k = np.arange(L)
    fwd = allg[s[:, None] + k[None, :]]  # read at the fragment start
    end = s + iz
    rvs = 3 - allg[end[:, None] - 1 - k[None, :]]  # rc read at its end
    # per-read mutations (SNPs vectorized, indels one by one)
    p_snp = spec.mut_rate * (1 - spec.indel_frac)
    p_ind = spec.mut_rate * spec.indel_frac
    for arr, rev in ((fwd, False), (rvs, True)):
        hit = rng.random(arr.shape) < p_snp
        arr[hit] = (arr[hit] + rng.integers(1, 4, int(hit.sum()))) & 3
        has_ind = rng.random(len(arr)) < 1 - (1 - p_ind) ** L
        for r in np.nonzero(has_ind)[0]:
            if rev:
                seg = _indel_read(rng, allg, int(end[r]), L, spec, True)
                if seg is not None:
                    arr[r] = 3 - seg
            else:
                seg = _indel_read(rng, allg, int(s[r]), L, spec, False)
                if seg is not None:
                    arr[r] = seg
    for arr in (fwd, rvs):
        err = rng.random(arr.shape) < spec.error_rate
        arr[err] = (arr[err] + rng.integers(1, 4, int(err.sum()))) & 3
    flip = rng.random(n_pairs) < 0.5  # read 1 from the reverse strand
    r1 = np.where(flip[:, None], rvs, fwd).astype(np.uint8)
    r2 = np.where(flip[:, None], fwd, rvs).astype(np.uint8)
    p_fwd = s - cum[c] + 1
    p_rev = end - L - cum[c] + 1
    p1 = np.where(flip, p_rev, p_fwd)
    p2 = np.where(flip, p_fwd, p_rev)
    cnames = [n for n, _ in contigs]
    names = [f"{cnames[ci]}_{a}_{b}_{'r' if fl else 'f'}_{i}"
             for i, (ci, a, b, fl) in enumerate(zip(c.tolist(), p1.tolist(),
                                                    p2.tolist(),
                                                    flip.tolist()))]
    pool1, pool2 = _quality_pool()
    q1 = _qualities(rng, pool1, n_pairs, L)
    q2 = _qualities(rng, pool2, n_pairs, L)
    return names, r1, r2, q1, q2


def write_fastq(path: str, names: Sequence[str], seqs: np.ndarray,
                quals: np.ndarray, mate: int) -> None:
    txt = _LETTERS[seqs]
    with open(path, "wb") as f:
        for i, name in enumerate(names):
            f.write(b"@%s/%d\n%s\n+\n%s\n" % (name.encode(), mate,
                                              txt[i].tobytes(),
                                              quals[i].tobytes()))


def parse_truth(name: str):
    """(contig, pos1, pos2, read1_forward) from a simulated read name."""
    contig, p1, p2, strand, _ = name.rsplit("_", 4)
    return contig, int(p1), int(p2), strand == "f"


def truth_share(sam_path: str, tol: int = 30) -> Tuple[int, int]:
    """(reads whose primary record lies at their simulated origin, reads):
    same contig and strand, POS within tol of the true leftmost base."""
    hits = total = 0
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fl = line.split("\t", 4)
            flag = int(fl[1])
            if flag & 0x900:
                continue
            total += 1
            if flag & 4:
                continue
            contig, p1, p2, fwd1 = parse_truth(fl[0])
            second = bool(flag & 0x80)
            pos, fwd = (p2, not fwd1) if second else (p1, fwd1)
            if (fl[2] == contig and bool(flag & 0x10) != fwd
                    and abs(int(fl[3]) - pos) <= tol):
                hits += 1
    return hits, total


def make_dataset(workdir: str, genome: GenomeSpec, n_pairs: int,
                 reads: ReadSpec = ReadSpec(), read_seed: int = 1):
    """Write genome.fa, r1.fq and r2.fq under workdir; returns the paths."""
    os.makedirs(workdir, exist_ok=True)
    contigs = simulate_genome(genome)
    fa = os.path.join(workdir, "genome.fa")
    write_fasta(fa, contigs)
    names, r1, r2, q1, q2 = simulate_pairs(contigs, n_pairs, reads,
                                           read_seed)
    p1 = os.path.join(workdir, "r1.fq")
    p2 = os.path.join(workdir, "r2.fq")
    write_fastq(p1, names, r1, q1, 1)
    write_fastq(p2, names, r2, q2, 2)
    return fa, p1, p2


def main(argv=None) -> int:
    """python -m mpibwa_tpu.io.simulate OUTDIR [--genome-bp N] [--pairs N]
    [--seed S]: write OUTDIR/{genome.fa,r1.fq,r2.fq}."""
    import argparse

    p = argparse.ArgumentParser(description="seeded genome + 2x150 reads")
    p.add_argument("outdir")
    p.add_argument("--genome-bp", type=int, default=CHR1_LEN)
    p.add_argument("--pairs", type=int, default=200_000)
    p.add_argument("--seed", type=int, default=1)
    a = p.parse_args(argv)
    paths = make_dataset(a.outdir, GenomeSpec(contig_lengths=(a.genome_bp,),
                                              seed=a.seed),
                         a.pairs, read_seed=a.seed)
    print("\n".join(paths))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
