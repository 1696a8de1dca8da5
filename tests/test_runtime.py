"""Runtime layer tests: chunker, BGZF, headers, fixmate, CLI, by-chr."""

import gzip
import io as _io
import os
import subprocess

import numpy as np
import pytest

from mpibwa_tpu.io.bgzf import BGZF_EOF, BGZFWriter, bgzf_block
from mpibwa_tpu.io.headers import bwa_set_rg, make_pg_line, sam_header
from mpibwa_tpu.parallel.chunker import chunk_pe, chunk_se



def test_chunker_boundaries():
    sizes = np.full(10, 100)
    chunks = chunk_se(sizes, 250)
    # close when acc > 250: after 3 reads (300 > 250)
    assert [(c.start, c.count) for c in chunks] == [(0, 3), (3, 3), (6, 3), (9, 1)]
    pe = chunk_pe(np.full(6, 100), np.full(6, 100), 1000, trimmed=False)
    # maxsiz 500; pairs of 200: closes after 3 pairs (600 > 500)
    assert [(c.start, c.count) for c in pe] == [(0, 3), (3, 3)]


def test_bgzf_roundtrip(tmp_path):
    buf = _io.BytesIO()
    w = BGZFWriter(buf, level=3)
    recs = [f"line{i}\t{'x' * (i % 977)}\n".encode() for i in range(2000)]
    for r in recs:
        w.write_record(r)
    w.close(write_eof=True)
    data = buf.getvalue()
    assert data.endswith(BGZF_EOF)
    # gzip handles multi-member streams
    assert gzip.decompress(data) == b"".join(recs)
    # single block structure
    blk = bgzf_block(b"hello world")
    assert gzip.decompress(blk) == b"hello world"
    assert blk[0:4] == b"\x1f\x8b\x08\x04"


def test_bgzf_reader(tmp_path):
    from mpibwa_tpu.io.bgzf import BGZFReader, is_bgzf

    buf = _io.BytesIO()
    w = BGZFWriter(buf, level=3)
    recs = [f"rec{i}\t{'y' * (i % 511)}\n".encode() for i in range(4000)]
    for r in recs:
        w.write_record(r)
    w.close(write_eof=True)
    raw = buf.getvalue()

    # sequential read + line iteration
    r = BGZFReader(_io.BytesIO(raw))
    assert r.read() == b"".join(recs)
    r = BGZFReader(_io.BytesIO(raw))
    assert list(r) == recs

    # virtual-offset tell/seek round trip: remember offsets of every 500th
    # record, then seek back in arbitrary order and re-read each line
    r = BGZFReader(_io.BytesIO(raw))
    marks = {}
    for i, _ in enumerate(recs):
        if i % 500 == 0:
            marks[i] = r.tell()
        r.readline()
    for i in sorted(marks, reverse=True):
        r.seek(marks[i])
        assert r.readline() == recs[i]

    # bounded read sizes cross block boundaries correctly
    r = BGZFReader(_io.BytesIO(raw))
    got = bytearray()
    while True:
        piece = r.read(7777)
        if not piece:
            break
        got += piece
    assert bytes(got) == b"".join(recs)

    p = tmp_path / "t.gz"
    p.write_bytes(raw)
    assert is_bgzf(p)
    p2 = tmp_path / "plain.gz"
    p2.write_bytes(gzip.compress(b"hello"))
    assert not is_bgzf(p2)


def test_headers():
    class A:
        name, length = "chr1", 1000

    h = sam_header([A], hdr_line="@CO\tx", rg_line="@RG\tID:g1",
                   pg_line=make_pg_line(["prog", "mem"]))
    lines = h.splitlines()
    assert lines[0] == "@SQ\tSN:chr1\tLN:1000"
    assert lines[1] == "@CO\tx"
    assert lines[2] == "@RG\tID:g1"
    assert lines[3].startswith("@PG\tID:bwa\tPN:bwa\tVN:")
    line, rid = bwa_set_rg(r"@RG\tID:grp\tSM:s")
    assert rid == "grp" and "\tID:grp\t" in line
    with pytest.raises(ValueError):
        bwa_set_rg("ID:missing-at-rg")


def test_fixmate_vs_oracle(golden_index, golden_dir, golden_fastq):
    """Our fixmate over our PE output must equal the oracle's fixmate over
    the reference engine's PE output (both engines already byte-identical)."""
    from mpibwa_tpu.core.fm import FMIndex
    from mpibwa_tpu.core.opts import MEM_F_PE, mem_opt_init
    from mpibwa_tpu.core.pipeline import process_seqs
    from mpibwa_tpu.core.refseq import RefSeq
    from mpibwa_tpu.io.fastq import interleave, read_fastq
    from mpibwa_tpu.io.fixmate import apply_fixmate

    golden = golden_dir / "pe_1k_fixmate.sam"
    if not golden.exists():
        pytest.skip("fixmate golden not generated")
    fm, refs = FMIndex.from_index(golden_index), RefSeq(golden_index)
    opt = mem_opt_init()
    opt.flag |= MEM_F_PE
    n = 1000
    seqs = interleave(
        read_fastq(golden_fastq("HCC1187C_R1_10K.fastq"), limit=n),
        read_fastq(golden_fastq("HCC1187C_R2_10K.fastq"), limit=n))
    process_seqs(opt, fm, refs, seqs)
    apply_fixmate(seqs, golden_index.anns)
    got = "".join(s.sam for s in seqs)
    want = golden.read_text()
    if got != want:
        for g, w in zip(got.splitlines(), want.splitlines()):
            assert g == w, f"\n got: {g[:220]}\nwant: {w[:220]}"
        assert False, "line count mismatch"


def test_bychr_routing(index):
    from mpibwa_tpu.io.bychr import ByChrRouter

    r = ByChrRouter(index.anns, dofixmate=False)
    names = [a.name for a in index.anns]
    assert r.files == names + ["discordant", "unmapped"]
    text = ("r1\t0\tchr1\t10\t60\t5M\t=\t20\t15\tACGTA\tIIIII\n"
            "r2\t4\t*\t0\t0\t*\t*\t0\t0\tACGTA\tIIIII\n")
    routed = r.route_text(text)
    assert [l.split("\t")[0] for l in routed[0]] == ["r1"]
    assert [l.split("\t")[0] for l in routed[len(names) + 1]] == ["r2"]
    # a mate on another contig is discordant
    class A:
        def __init__(self, n):
            self.name = n

    r2 = ByChrRouter([A("c1"), A("c2")], dofixmate=False)
    t = "x\t0\tc1\t1\t60\t5M\tc2\t9\t0\tACGTA\tIIIII\n"
    routed = r2.route_text(t)
    assert 0 in routed and r2.disc_idx in routed


def test_cli_se_subset(idx_prefix, tmp_path, r1_path):
    """Full CLI run (the device path, on the CPU backend here) on a subset
    equals the exact Python engine's output."""
    from mpibwa_tpu import cli
    from mpibwa_tpu.core.opts import mem_opt_init
    from mpibwa_tpu.index.format import load_index
    from mpibwa_tpu.parallel.runtime import Runtime

    sub = tmp_path / "sub.fq"
    with open(r1_path) as f:
        lines = [next(f) for _ in range(300 * 4)]
    sub.write_text("".join(lines))
    out = tmp_path / "out"
    rc = cli.main(["mem", "-o", str(out), idx_prefix, str(sub)])
    assert rc == 0
    ref = Runtime(load_index(idx_prefix), mem_opt_init(), use_device=False,
                  verbose=False).run(str(sub), None, str(tmp_path / "ref"))
    body = lambda p: [l for l in open(p) if not l.startswith("@")]
    assert body(tmp_path / "out.sam") == body(ref)


def test_shard_count_invariance(idx_prefix, tmp_path, r1_path):
    """Chunk boundaries and merged output are invariant to shard count
    (the reference's rank-count reproducibility, CHANGELOG:180-182)."""
    from mpibwa_tpu.core.opts import mem_opt_init
    from mpibwa_tpu.index.format import load_index
    from mpibwa_tpu.parallel.runtime import Runtime, merge_shard_outputs

    sub = tmp_path / "sub.fq"
    with open(r1_path) as f:
        sub.write_text("".join(next(f) for _ in range(300 * 4)))
    idx = load_index(idx_prefix)
    K = 5000  # ~49 reads per chunk -> several chunks

    rt1 = Runtime(idx, mem_opt_init(), use_device=True, fixed_chunk_size=K)
    one = rt1.run(str(sub), None, str(tmp_path / "one"), 2)

    outs, mans = [], []
    hlen = None
    for shard in range(2):
        rt = Runtime(idx, mem_opt_init(), use_device=True,
                     fixed_chunk_size=K, shard=shard, n_shards=2)
        outs.append(rt.run(str(sub), None, str(tmp_path / f"p{shard}"), 2))
        mans.append(rt.last_manifest)
        hlen = rt.header_len
    merged = merge_shard_outputs(outs, mans, str(tmp_path / "merged.sam"), hlen)
    assert open(merged, "rb").read() == open(one, "rb").read()


def test_multidevice_identity(idx_prefix, tmp_path, r1_path):
    """Fanning chunks out over several devices (one aligner per device,
    round-robin chunks — the mesh analog of the reference's rank-per-chunk
    scatter, mainParallel.c:1200-1260) must produce byte-identical output
    to the single-device run."""
    import jax

    from mpibwa_tpu.core.opts import mem_opt_init
    from mpibwa_tpu.index.format import load_index
    from mpibwa_tpu.parallel.runtime import Runtime

    sub = tmp_path / "sub.fq"
    with open(r1_path) as f:
        sub.write_text("".join(next(f) for _ in range(200 * 4)))
    idx = load_index(idx_prefix)
    K = 5000  # several chunks

    rt1 = Runtime(idx, mem_opt_init(), use_device=True, fixed_chunk_size=K,
                  verbose=False)
    one = rt1.run(str(sub), None, str(tmp_path / "one"), 2)

    devs = jax.devices()[:2]
    rtm = Runtime(idx, mem_opt_init(), use_device=True, fixed_chunk_size=K,
                  verbose=False, devices=devs)
    many = rtm.run(str(sub), None, str(tmp_path / "many"), 2)
    assert open(many, "rb").read() == open(one, "rb").read()


def test_cli_shard_merge(idx_prefix, tmp_path, monkeypatch, r1_path):
    """The mpirun analog: per-shard CLI runs (MPIBWA_SHARD/NSHARDS) plus
    `cli merge` reproduce the single-process output byte-for-byte (modulo
    the @PG CL, which records each process's own argv)."""
    from mpibwa_tpu.cli import main

    sub = tmp_path / "sub.fq"
    with open(r1_path) as f:
        sub.write_text("".join(next(f) for _ in range(120 * 4)))

    out1 = tmp_path / "one"
    assert main(["mem", "-K", "2000", "-o", str(out1), idx_prefix,
                 str(sub)]) == 0
    shard_outs = []
    for sh in range(2):
        monkeypatch.setenv("MPIBWA_SHARD", str(sh))
        monkeypatch.setenv("MPIBWA_NSHARDS", "2")
        o = tmp_path / f"sh{sh}"
        assert main(["mem", "-K", "2000", "-o", str(o), idx_prefix,
                     str(sub)]) == 0
        shard_outs.append(str(o) + ".sam")
    monkeypatch.delenv("MPIBWA_SHARD")
    monkeypatch.delenv("MPIBWA_NSHARDS")
    merged = tmp_path / "merged.sam"
    assert main(["merge", str(merged)] + shard_outs) == 0

    strip = lambda p: [l for l in open(p) if not l.startswith("@PG")]
    assert strip(merged) == strip(str(out1) + ".sam")


def test_cli_smart_pairing(idx_prefix, tmp_path, r1_path, r2_path):
    """-p with one interleaved file pairs consecutive reads: output matches
    the two-file PE run of the same pairs."""
    from mpibwa_tpu.cli import main

    n = 300
    inter = tmp_path / "inter.fq"
    p1, p2 = tmp_path / "p1.fq", tmp_path / "p2.fq"
    with open(r1_path) as f1, open(r2_path) as f2, open(inter, "w") as out, \
            open(p1, "w") as o1, open(p2, "w") as o2:
        for _ in range(n):
            a = [next(f1) for _ in range(4)]
            b = [next(f2) for _ in range(4)]
            out.writelines(a + b)
            o1.writelines(a)
            o2.writelines(b)
    out1 = tmp_path / "sp"
    assert main(["mem", "-p", "-o", str(out1), idx_prefix, str(inter)]) == 0
    out2 = tmp_path / "two"
    assert main(["mem", "-o", str(out2), idx_prefix, str(p1), str(p2)]) == 0
    body = lambda p: [l for l in open(p) if not l.startswith("@")]
    got = body(str(out1) + ".sam")
    assert len(got) >= 2 * n and got == body(str(out2) + ".sam")


def test_native_fixmate_matches_python(index, idx_prefix, tmp_path,
                                       r1_path, r2_path):
    """The C fixmate (mpibwa_tpu/native/fixmate.c) must be byte-identical
    to the Python port (the oracle-tested reference) on a PE batch."""
    import itertools

    from mpibwa_tpu.cli import main
    from mpibwa_tpu.io.fixmate import fixmate_pair
    from mpibwa_tpu.native import fixmate_pair_native, get_lib

    if get_lib() is None:
        import pytest

        pytest.skip("no C compiler available")
    n_pairs = 400
    p1, p2 = tmp_path / "p1.fq", tmp_path / "p2.fq"
    for src, dst in ((r1_path, p1), (r2_path, p2)):
        with open(src) as f:
            dst.write_text("".join(next(f) for _ in range(n_pairs * 4)))
    assert main(["mem", "-o", str(tmp_path / "pe"), idx_prefix, str(p1),
                 str(p2)]) == 0
    names = [a.name for a in index.anns]
    lines = [l for l in open(tmp_path / "pe.sam") if not l.startswith("@")]
    n = 0
    for qname, grp in itertools.groupby(lines,
                                        key=lambda l: l.split("\t", 1)[0]):
        grp = list(grp)
        g1 = "".join(l for l in grp if int(l.split("\t")[1]) & 64)
        g2 = "".join(l for l in grp if int(l.split("\t")[1]) & 128)

        class S:
            pass

        a, b = S(), S()
        a.sam, b.sam = g1, g2
        a.name = b.name = qname
        fixmate_pair(a, b, index.anns)
        res = fixmate_pair_native(g1, g2, names)
        assert res == (a.sam, b.sam), f"native fixmate differs for {qname}"
        n += 1
    assert n == n_pairs


def test_cli_launch(idx_prefix, tmp_path, r1_path):
    """One-command distribution: `launch -n 2 mem` (spawn, align, merge)
    equals the single-process run (the mpirun -n analog,
    mainParallel.c:517-519 + 1109-1123)."""
    from mpibwa_tpu.cli import main

    sub = tmp_path / "sub.fq"
    with open(r1_path) as f:
        sub.write_text("".join(next(f) for _ in range(120 * 4)))
    out1 = tmp_path / "one"
    assert main(["mem", "-K", "2000", "-o", str(out1), idx_prefix,
                 str(sub)]) == 0
    out2 = tmp_path / "launched"
    assert main(["launch", "-n", "2", "mem", "-K", "2000", "-o", str(out2),
                 idx_prefix, str(sub)]) == 0
    strip = lambda p: [l for l in open(p) if not l.startswith("@PG")]
    assert strip(str(out2) + ".sam") == strip(str(out1) + ".sam")
    # shard intermediates are cleaned up
    assert not (tmp_path / "launched.shard0.sam").exists()


def test_cli_shard_merge_bgzf(idx_prefix, tmp_path, monkeypatch, r1_path):
    """Sharded -g runs merge into a valid BGZF whose decompressed text
    equals the single-process run (chunk extents are compressed sizes;
    parallel_aux.c:2941-3073 analog)."""
    import gzip

    from mpibwa_tpu.cli import main
    from mpibwa_tpu.io.bgzf import BGZF_EOF

    sub = tmp_path / "sub.fq"
    with open(r1_path) as f:
        sub.write_text("".join(next(f) for _ in range(120 * 4)))
    out1 = tmp_path / "one"
    assert main(["mem", "-g", "-K", "2000", "-o", str(out1), idx_prefix,
                 str(sub)]) == 0
    shard_outs = []
    for sh in range(2):
        monkeypatch.setenv("MPIBWA_SHARD", str(sh))
        monkeypatch.setenv("MPIBWA_NSHARDS", "2")
        o = tmp_path / f"sh{sh}"
        assert main(["mem", "-g", "-K", "2000", "-o", str(o), idx_prefix,
                     str(sub)]) == 0
        shard_outs.append(str(o) + ".gz")
    monkeypatch.delenv("MPIBWA_SHARD")
    monkeypatch.delenv("MPIBWA_NSHARDS")
    merged = tmp_path / "merged.gz"
    assert main(["merge", str(merged)] + shard_outs) == 0
    data = merged.read_bytes()
    assert data.endswith(BGZF_EOF)
    strip = lambda t: [l for l in t.splitlines() if not l.startswith("@PG")]
    assert strip(gzip.decompress(data).decode()) == \
        strip(gzip.decompress((tmp_path / "one.gz").read_bytes()).decode())


def test_cli_bychr_shard_merge(idx_prefix, tmp_path, monkeypatch, r1_path,
                               r2_path):
    """Sharded membychr + mergebychr equals the single-process by-chr run
    (the mpiBWAByChr write stage, mainParallelByChromosome.c:1462-1563)."""
    import os

    from mpibwa_tpu.cli import main

    inter = tmp_path / "inter.fq"
    with open(r1_path) as f1, \
            open(r2_path) as f2, \
            open(inter, "w") as out:
        for _ in range(150):
            for _ in range(4):
                out.write(next(f1))
            for _ in range(4):
                out.write(next(f2))
    one = tmp_path / "bychr1"
    assert main(["membychr", "-p", "-K", "20000", "-o", str(one),
                 idx_prefix, str(inter)]) == 0
    two = tmp_path / "bychr2"
    assert main(["launch", "-n", "2", "membychr", "-p", "-K", "20000",
                 "-o", str(two), idx_prefix, str(inter)]) == 0
    files1 = sorted(os.listdir(one))
    assert sorted(os.listdir(two)) == files1 and files1
    strip = lambda p: [l for l in open(p) if not l.startswith("@PG")]
    for name in files1:
        assert strip(two / name) == strip(one / name), name


def test_cli_preflight(idx_prefix, tmp_path, capsys):
    """Missing index/input/output dir exit(2) with a message
    (mainParallel.c:604-633)."""
    from mpibwa_tpu.cli import main

    sub = tmp_path / "x.fq"
    sub.write_text("@r\nACGT\n+\nIIII\n")
    assert main(["mem", "-o", str(tmp_path / "o"), "/nonexistent/ref",
                 str(sub)]) == 2
    assert main(["mem", "-o", str(tmp_path / "o"), idx_prefix,
                 str(tmp_path / "missing.fq")]) == 2
    assert main(["mem", "-o", "/no/such/dir/out", idx_prefix,
                 str(sub)]) == 2


def test_cli_bgzf_output(idx_prefix, tmp_path, r1_path):
    """-g writes BGZF (.gz) output that gunzips to the SAM text, ending
    with the 28-byte BGZF EOF magic (mainParallel.c:1509-1516)."""
    import gzip

    from mpibwa_tpu.cli import main
    from mpibwa_tpu.io.bgzf import BGZF_EOF

    sub = tmp_path / "sub.fq"
    with open(r1_path) as f:
        sub.write_text("".join(next(f) for _ in range(50 * 4)))
    out = tmp_path / "zz"
    assert main(["mem", "-g", "-o", str(out), idx_prefix, str(sub)]) == 0
    sam_out = tmp_path / "ss"
    assert main(["mem", "-o", str(sam_out), idx_prefix, str(sub)]) == 0
    data = open(str(out) + ".gz", "rb").read()
    assert data.endswith(BGZF_EOF)
    text = gzip.decompress(data).decode()
    want = open(str(sam_out) + ".sam").read()
    # @PG CL differs (-g and -o paths are part of argv); compare the rest
    strip = lambda t: [l for l in t.splitlines() if not l.startswith("@PG")]
    assert strip(text) == strip(want)


def test_cli_bam_output(idx_prefix, tmp_path, r1_path):
    """-b writes .bam output — the reference's BAM is BGZF-compressed SAM
    text: compressed header block(s), per-chunk body block runs, and the
    28-byte BGZF EOF magic (mainParallel.c:1509-1516,
    parallel_aux.c:1920-2026). Decoded back through BGZFReader it must
    byte-match the plain SAM run."""
    from mpibwa_tpu.cli import main
    from mpibwa_tpu.io.bgzf import BGZF_EOF, BGZFReader, is_bgzf

    sub = tmp_path / "sub.fq"
    with open(r1_path) as f:
        sub.write_text("".join(next(f) for _ in range(50 * 4)))
    out = tmp_path / "bb"
    assert main(["mem", "-b", "-o", str(out), idx_prefix, str(sub)]) == 0
    sam_out = tmp_path / "ss"
    assert main(["mem", "-o", str(sam_out), idx_prefix, str(sub)]) == 0
    bam_path = str(out) + ".bam"
    data = open(bam_path, "rb").read()
    assert is_bgzf(bam_path)
    assert data.endswith(BGZF_EOF)
    with open(bam_path, "rb") as f:
        text = BGZFReader(f).read().decode()
    want = open(str(sam_out) + ".sam").read()
    # @PG CL differs (-b and -o paths are part of argv); compare the rest
    strip = lambda t: [l for l in t.splitlines() if not l.startswith("@PG")]
    assert strip(text) == strip(want)


def test_cli_bychr_bam_output(idx_prefix, tmp_path, r1_path, r2_path):
    """membychr -b: every per-chromosome file (incl. discordant/unmapped)
    is BGZF-of-SAM with its own EOF magic (mainParallelByChromosome.c
    :1514-1563, :1591-1599) and decodes to the per-chr SAM run."""
    import os

    from mpibwa_tpu.cli import main
    from mpibwa_tpu.io.bgzf import BGZF_EOF, BGZFReader

    inter = tmp_path / "inter.fq"
    with open(r1_path) as f1, \
            open(r2_path) as f2, \
            open(inter, "w") as out:
        for _ in range(60):
            for _ in range(4):
                out.write(next(f1))
            for _ in range(4):
                out.write(next(f2))
    sdir = tmp_path / "bychr_sam"
    assert main(["membychr", "-p", "-o", str(sdir), idx_prefix,
                 str(inter)]) == 0
    bdir = tmp_path / "bychr_bam"
    assert main(["membychr", "-p", "-b", "-o", str(bdir), idx_prefix,
                 str(inter)]) == 0
    sam_files = sorted(os.listdir(sdir))
    bam_files = sorted(os.listdir(bdir))
    assert [f.replace(".bam", ".sam") for f in bam_files] == sam_files
    strip = lambda t: [l for l in t.splitlines() if not l.startswith("@PG")]
    for name in bam_files:
        data = (bdir / name).read_bytes()
        assert data.endswith(BGZF_EOF), name
        with open(bdir / name, "rb") as f:
            text = BGZFReader(f).read().decode()
        want = (sdir / name.replace(".bam", ".sam")).read_text()
        assert strip(text) == strip(want), name


def test_sharded_scan_matches_full_scan(tmp_path, r1_path):
    """Cooperative striped scanning (scan_fastq_sharded) must reproduce the
    full-scan offset index bit for bit, for any shard/N (chunk boundaries
    depend on it; shard-invariance of output depends on this)."""
    import glob
    import os
    import shutil
    import tempfile

    import numpy as np

    from mpibwa_tpu.io.fastq import scan_fastq, scan_fastq_sharded

    path = str(r1_path)
    rendezvous = os.path.join(tempfile.gettempdir(), "mpibwa_fqidx_*")
    full = scan_fastq(path)
    for n in (2, 5):
        for d in glob.glob(rendezvous):
            shutil.rmtree(d, ignore_errors=True)
        for s in range(n):
            ix = scan_fastq_sharded(path, s, n)
            assert np.array_equal(ix.offsets, full.offsets), (n, s)
            assert np.array_equal(ix.l_seq, full.l_seq), (n, s)
    for d in glob.glob(rendezvous):
        shutil.rmtree(d, ignore_errors=True)


def test_find_record_start_heuristic(tmp_path):
    """@-line boundary discovery: quality lines starting with '@' must not
    be mistaken for headers (parallel_aux.c:307-318 heuristic)."""
    from mpibwa_tpu.io.fastq import find_record_start

    recs = []
    for i in range(50):
        # qual deliberately starts with '@'
        recs.append(f"@r{i} x\nACGTACGTACGT\n+\n@IIIIIIIIIII\n".encode())
    data = b"".join(recs)
    p = tmp_path / "t.fq"
    p.write_bytes(data)
    starts = [0]
    for r in recs[:-1]:
        starts.append(starts[-1] + len(r))
    with open(p, "rb") as f:
        fsize = len(data)
        for pos in range(0, fsize, 7):
            got = find_record_start(f, pos, fsize)
            want = min(s for s in starts + [fsize] if s >= pos)
            assert got == want, (pos, got, want)


def test_cli_launch_multihost_local_groups(idx_prefix, tmp_path, r1_path):
    """--hosts with two "localhost" entries: the multi-host code path
    (host round-robin, per-host process groups, merge) with local spawns;
    output equals the single-process run."""
    from mpibwa_tpu.cli import main

    sub = tmp_path / "sub.fq"
    with open(r1_path) as f:
        sub.write_text("".join(next(f) for _ in range(120 * 4)))
    out1 = tmp_path / "one"
    assert main(["mem", "-K", "2000", "-o", str(out1), idx_prefix,
                 str(sub)]) == 0
    out2 = tmp_path / "mh"
    assert main(["launch", "--hosts", "localhost,localhost", "mem",
                 "-K", "2000", "-o", str(out2), idx_prefix, str(sub)]) == 0
    strip = lambda p: [l for l in open(p) if not l.startswith("@PG")]
    assert strip(str(out2) + ".sam") == strip(str(out1) + ".sam")


def test_bgzf_line_boundary_packing():
    """pack_records must follow the reference writer's packing rules
    (parallel_aux.c:3000-3057): greedy whole-record blocks bounded by the
    64 KiB uncompressed payload; the overflowing record starts the next
    block; concatenation reproduces the input exactly."""
    import struct
    import zlib

    from mpibwa_tpu.io.bgzf import MAX_BLOCK_SIZE, pack_records

    rng = __import__("numpy").random.default_rng(3)
    records = []
    for i in range(3000):
        ln = int(rng.integers(40, 400))
        records.append((f"r{i}\t" + "A" * ln + "\n").encode())
    blob = pack_records(records, level=3)

    # walk the BGZF blocks, decompress payloads
    payloads = []
    off = 0
    while off < len(blob):
        assert blob[off : off + 4] == b"\x1f\x8b\x08\x04"
        bsize = struct.unpack("<H", blob[off + 16 : off + 18])[0] + 1
        comp = blob[off + 18 : off + bsize - 8]
        payloads.append(zlib.decompress(comp, -15))
        off += bsize
    assert b"".join(payloads) == b"".join(records)

    # block boundaries fall on record boundaries, greedily filled
    bounds = set()
    acc = 0
    for r in records:
        acc += len(r)
        bounds.add(acc)
    pos = 0
    for k, p in enumerate(payloads):
        assert len(p) <= MAX_BLOCK_SIZE
        pos += len(p)
        assert pos in bounds, f"block {k} does not end on a record boundary"
        if k + 1 < len(payloads):  # greedy: next record would overflow
            nxt = len(payloads[k + 1])
            first_next = None
            # find length of the first record of the next block
            acc2 = 0
            for r in records:
                acc2 += len(r)
                if acc2 > pos:
                    first_next = len(r)
                    break
            assert len(p) + first_next > MAX_BLOCK_SIZE
            del nxt


def test_cli_launch_remote_rsh_branch(idx_prefix, tmp_path, monkeypatch,
                                      r1_path):
    """The remote (rsh) branch of `launch --hosts`: a non-local hostname
    routes each shard through the remote shell with the environment ON THE
    COMMAND LINE (cd-to-cwd pinning, shlex quoting, MPIBWA_* +
    JAX_PLATFORMS/XLA_FLAGS propagation). No sshd exists in this image, so
    the remote shell is a shim with the `ssh host cmd` calling convention
    that drops the hostname and runs the command under a CLEAN environment
    (env -i: fresh $HOME, no inherited variables — only PATH survives,
    which a real remote login shell would provide). The shard therefore
    sees ONLY what the quoted command line carried; the merged output must
    equal the single-process run (mpirun -hostfile parity)."""
    import pathlib
    import stat

    from mpibwa_tpu.cli import main

    repo = pathlib.Path(__file__).resolve().parent.parent
    monkeypatch.chdir(repo)
    home = tmp_path / "remote_home"
    home.mkdir()
    shim = tmp_path / "fake_rsh.sh"
    shim.write_text(
        "#!/bin/sh\n"
        "# ssh calling convention: $1 = host, $2 = command string\n"
        "shift\n"
        f'exec /usr/bin/env -i HOME={home} '
        'PATH=/opt/venv/bin:/usr/local/bin:/usr/bin:/bin sh -c "$1"\n')
    shim.chmod(shim.stat().st_mode | stat.S_IXUSR)

    sub = tmp_path / "sub.fq"
    with open(r1_path) as f:
        sub.write_text("".join(next(f) for _ in range(120 * 4)))
    out1 = tmp_path / "one"
    assert main(["mem", "-K", "2000", "-o", str(out1), idx_prefix,
                 str(sub)]) == 0
    out2 = tmp_path / "rsh"
    assert main(["launch", "-n", "2", "--hosts", "remotehost",
                 "--rsh", str(shim), "mem", "-K", "2000", "-o", str(out2),
                 idx_prefix, str(sub)]) == 0
    strip = lambda p: [l for l in open(p) if not l.startswith("@PG")]
    assert strip(str(out2) + ".sam") == strip(str(out1) + ".sam")


def test_tpumap_page_sharing(idx_prefix, tmp_path):
    """N co-located processes loading the same .tpumap share ONE physical
    copy: load_image mmaps the flat image read-only, so the page cache
    deduplicates it exactly like map_indexes' per-domain shared window
    (MPI_Win_allocate_shared, parallel_aux.c:1745-1838; zero-copy fixup
    bwa_mem2idx, bwa.c:310-345). Four concurrent processes each touch
    every index array, then report /proc/self/smaps for the mapping:
    pages must be resident AND overwhelmingly Shared_, not Private_."""
    import json
    import subprocess
    import sys
    import time

    from mpibwa_tpu.index.format import load_index, save_image

    img = tmp_path / "idx.tpumap"
    save_image(load_index(idx_prefix), str(img))
    size = img.stat().st_size

    child = tmp_path / "child.py"
    child.write_text(f"""
import json, os, sys, time
sys.path.insert(0, {str(os.getcwd())!r})
from mpibwa_tpu.index.format import load_image
idx = load_image({str(img)!r})
# touch every array so its pages are resident
tot = int(idx.bwt.sum()) + int(idx.sa.sum()) + int(idx.pac.sum())
tot += int(idx.ref_fwd.sum())
me = sys.argv[1]
open(me + '.ready', 'w').write('1')
while not os.path.exists({str(tmp_path / 'go')!r}):
    time.sleep(0.05)
rss = shared = private = 0
take = False
for line in open('/proc/self/smaps'):
    if '-' in line.split(' ')[0] and '/' in line:
        take = line.rstrip().endswith('idx.tpumap')
    elif take:
        f = line.split()
        if f[0] == 'Rss:':
            rss += int(f[1])
        elif f[0] in ('Shared_Clean:', 'Shared_Dirty:'):
            shared += int(f[1])
        elif f[0] in ('Private_Clean:', 'Private_Dirty:'):
            private += int(f[1])
print(json.dumps({{'rss_kb': rss, 'shared_kb': shared,
                   'private_kb': private, 'touched': tot}}))
""")
    def one_round(rd):
        procs = []
        for k in range(4):
            tag = str(tmp_path / f"r{rd}c{k}")
            procs.append((tag, subprocess.Popen(
                [sys.executable, str(child), tag], stdout=subprocess.PIPE)))
        deadline = time.time() + 120
        while time.time() < deadline:
            if all(os.path.exists(t + ".ready") for t, _ in procs):
                break
            time.sleep(0.05)
        (tmp_path / "go").write_text("1")
        stats = []
        for _, p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0
            stats.append(json.loads(out))
        for st in stats:
            # the arrays (not the json meta tail) must be resident...
            if not st["rss_kb"] * 1024 > 0.5 * size:
                return st
            # ...and deduplicated across the 4 processes: private pages
            # are a sliver (copy-per-process would make ALL private)
            if not st["private_kb"] <= 0.1 * st["rss_kb"] + 64:
                return st
        return None

    # under memory pressure the kernel may reclaim another process's
    # page-table entries, making genuinely shared pages COUNT as private
    # for a moment — retry before declaring the mapping unshared
    last = None
    for rd in range(3):
        (tmp_path / "go").unlink(missing_ok=True)
        last = one_round(rd)
        if last is None:
            break
    assert last is None, last
