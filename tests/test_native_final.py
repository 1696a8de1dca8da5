"""Differential tests: native finalization runtime (native/finalize.c) vs the
exact Python spec (core/{extend,region,sam,pair,cigar}.py).

The DP hooks are fuzzed directly; the batch path is validated by running the
device pipeline twice (native vs Python finalization) and requiring identical
SAM text. Golden identity of the native path is additionally covered by the
runtime tests, which exercise it by default.
"""

import ctypes

import numpy as np
import pytest

from mpibwa_tpu.core.extend import (KSW_XBYTE, KSW_XSTART, KSW_XSUBO,
                                    ksw_align2, ksw_global2)
from mpibwa_tpu.core.opts import MEM_F_PE, fill_scmat, mem_opt_init
from mpibwa_tpu.io.fastq import interleave, read_fastq
from mpibwa_tpu.native import get_lib


P = ctypes.c_void_p


def _vp(a):
    return a.ctypes.data_as(P)


@pytest.fixture(scope="module")
def lib():
    lib = get_lib()
    if lib is None:
        pytest.skip("native library unavailable")
    return lib


def test_global_matches_python(lib):
    mat = fill_scmat(1, 4)
    rng = np.random.default_rng(7)
    for trial in range(120):
        qlen = int(rng.integers(1, 160))
        tlen = int(rng.integers(1, 200))
        q = rng.integers(0, 5, qlen).astype(np.uint8)
        if trial % 2 == 0 and tlen >= qlen:
            t = np.concatenate(
                [q, rng.integers(0, 4, tlen - qlen).astype(np.uint8)])
            m = rng.random(tlen) < 0.1
            t = np.where(m, rng.integers(0, 4, tlen).astype(np.uint8),
                         t).astype(np.uint8)
        else:
            t = rng.integers(0, 5, tlen).astype(np.uint8)
        # real callers (gen_cigar) guarantee w >= |rlen - qlen| + 3
        w = max(int(rng.integers(1, 120)), abs(tlen - qlen) + 3)
        ps, pc = ksw_global2(q, t, mat, 6, 1, 6, 1, w, True)
        score = np.zeros(1, np.int32)
        cig = np.zeros(qlen + tlen + 4, np.uint32)
        ncig = np.array([len(cig)], np.int32)
        rc = lib.fin_test_global(_vp(q), qlen, _vp(t), tlen, _vp(mat),
                                 6, 1, 6, 1, w, 1, _vp(score), _vp(cig),
                                 _vp(ncig))
        assert rc == 0
        ccig = [(int(c >> 4), int(c & 0xF)) for c in cig[: ncig[0]]]
        assert ps == score[0] and (pc or []) == ccig, trial


def test_align2_matches_python(lib):
    mat = fill_scmat(1, 4)
    rng = np.random.default_rng(11)
    for trial in range(120):
        qlen = int(rng.integers(5, 120))
        tlen = int(rng.integers(5, 400))
        q = rng.integers(0, 4, qlen).astype(np.uint8)
        if trial % 2 == 0 and tlen > qlen:
            ins = int(rng.integers(0, tlen - qlen))
            t = rng.integers(0, 4, tlen).astype(np.uint8)
            t[ins : ins + qlen] = q
            m = rng.random(tlen) < 0.08
            t = np.where(m, rng.integers(0, 4, tlen).astype(np.uint8),
                         t).astype(np.uint8)
        else:
            t = rng.integers(0, 4, tlen).astype(np.uint8)
        for size_mode in (KSW_XBYTE, 0):  # u8 and i16 kernels
            xtra = KSW_XSUBO | KSW_XSTART | size_mode | 19
            r = ksw_align2(q, t, mat, 6, 1, 6, 1, xtra)
            out = np.zeros(7, np.int32)
            rc = lib.fin_test_align2(_vp(q), qlen, _vp(t), tlen, _vp(mat),
                                     6, 1, 6, 1, xtra, _vp(out))
            assert rc == 0
            assert (r.score, r.te, r.qe, r.qb, r.tb, r.score2,
                    r.te2) == tuple(int(x) for x in out), (trial, size_mode)


def _run_both(al, seqs_native, seqs_python, **kw):
    al.process_seqs(seqs_native, **kw)
    assert al._finalizer is not None and al._finalizer.available
    lib_save = al._finalizer.lib
    al._finalizer.lib = None  # force the Python path
    try:
        al.process_seqs(seqs_python, **kw)
    finally:
        al._finalizer.lib = lib_save
    for a, b in zip(seqs_native, seqs_python):
        assert a.sam == b.sam, (a.name, a.sam, b.sam)


def test_batch_se_native_vs_python(lib, index, r1_path):
    from mpibwa_tpu.pipeline.device_align import DeviceAligner

    opt = mem_opt_init()
    al = DeviceAligner(index, opt)
    n1 = read_fastq(r1_path, limit=300)
    n2 = read_fastq(r1_path, limit=300)
    _run_both(al, n1, n2, n_processed=17)


def test_batch_pe_native_vs_python(lib, index, r1_path, r2_path):
    from mpibwa_tpu.pipeline.device_align import DeviceAligner

    opt = mem_opt_init()
    opt.flag |= MEM_F_PE
    al = DeviceAligner(index, opt)

    def load():
        r1 = read_fastq(r1_path, limit=300)
        r2 = read_fastq(r2_path, limit=300)
        return interleave(r1, r2)

    _run_both(al, load(), load(), n_processed=0)


def test_batch_native_chain_vs_python_chain(lib, index, r1_path, r2_path):
    """The all-C record path (fin_chain_* session + fin_batch) must equal
    the Python chain + native-final path byte for byte, SE and PE."""
    from mpibwa_tpu.pipeline.device_align import DeviceAligner

    for pe in (False, True):
        opt = mem_opt_init()
        if pe:
            opt.flag |= MEM_F_PE
        al = DeviceAligner(index, opt)

        def load():
            r1 = read_fastq(r1_path, limit=240)
            if not pe:
                return r1
            r2 = read_fastq(r2_path, limit=240)
            return interleave(r1, r2)

        a = load()
        assert al._process_seqs_native(a, 6 if not pe else 0, None, "")
        b = load()
        ch = al._native_chainer()
        import os as _os

        _os.environ["MPIBWA_CHAIN"] = "python"
        try:
            assert not ch.available
            al.process_seqs(b, n_processed=6 if not pe else 0)
        finally:
            _os.environ.pop("MPIBWA_CHAIN")
        for x, y in zip(a, b):
            assert x.sam == y.sam, (pe, x.name, x.sam, y.sam)


def test_native_ext_matches_device_ext(lib, index, r1_path):
    """MPIBWA_EXT=native (every extension DP scalar in C) must equal the
    device-extension path byte for byte."""
    import os as _os

    from mpibwa_tpu.pipeline.device_align import DeviceAligner

    opt = mem_opt_init()
    al = DeviceAligner(index, opt)
    a = read_fastq(r1_path, limit=200)
    b = read_fastq(r1_path, limit=200)
    _os.environ["MPIBWA_EXT"] = "device"  # batched device kernels
    try:
        al.process_seqs(a, n_processed=3)
    finally:
        _os.environ.pop("MPIBWA_EXT")
    al.process_seqs(b, n_processed=3)  # default: scalar DPs in C
    for x, y in zip(a, b):
        assert x.sam == y.sam, (x.name,)


def test_parallel_chain_finalize_identity(lib, index, monkeypatch, r1_path,
                                          r2_path):
    """Splitting a batch across concurrent C chain sessions and
    pair-aligned C finalize ranges (native_final._core_share fan-out)
    must be byte-identical to the single-session path."""
    import mpibwa_tpu.pipeline.native_final as NF
    from mpibwa_tpu.pipeline.device_align import DeviceAligner

    opt = mem_opt_init()
    opt.flag |= MEM_F_PE
    r1 = read_fastq(r1_path, limit=600)
    r2 = read_fastq(r2_path, limit=600)
    seqs = interleave(r1, r2)
    al = DeviceAligner(index, opt)
    al.process_seqs(seqs, n_processed=0)  # 1200 < _MIN_SPLIT: single path
    want = [s.sam for s in seqs]
    assert all(want)

    monkeypatch.setattr(NF, "_MIN_SPLIT", 64)
    for s in seqs:
        s.sam = None
    DeviceAligner(index, opt).process_seqs(seqs, n_processed=0)
    assert [s.sam for s in seqs] == want


def test_collect_flat_v8_raw_speculative(lib, index, monkeypatch, r1_path):
    """The v8 raw row path (the GPU engine) must produce the same
    pre-sort stream as the flat engine, through BOTH speculative-pull
    branches: the single-pull hit (generous est_rows) and the
    underestimate that pays a second full pull (est_rows forced to 1).
    v8 does not maintain x[1] (consumed by nothing downstream, see
    ops/backward8.py), so streams are compared on (x0, x2, info)."""
    from mpibwa_tpu.ops import backward8 as B8
    from mpibwa_tpu.pipeline.device_align import DeviceAligner

    opt = mem_opt_init()
    al = DeviceAligner(index, opt)
    qs = [s.seq for s in
          read_fastq(r1_path, limit=96)]
    ref = al.seeder.collect_flat(qs)  # default engine on CPU: flat
    assert ref is not None
    key = [0, 2, 3]

    monkeypatch.setenv("MPIBWA_BWD", "v8")
    got = al.seeder.collect_flat(qs)
    assert got is not None
    assert np.array_equal(got[0][:, key], ref[0][:, key])
    assert (got[1] == ref[1]).all()

    orig = B8.run_backward8
    monkeypatch.setattr(
        B8, "run_backward8",
        lambda *a, **k: orig(*a, **{**k, "est_rows": 1}))
    got2 = al.seeder.collect_flat(qs)
    assert got2 is not None
    assert np.array_equal(got2[0][:, key], ref[0][:, key])
    assert (got2[1] == ref[1]).all()


def test_collect_flat_matches_list_path(lib, index, r1_path):
    """The arrays-end-to-end seeder (collect_flat) must produce row-for-row
    the same pre-sort interval stream as the per-read list path."""
    from mpibwa_tpu.pipeline.device_align import DeviceAligner

    opt = mem_opt_init()
    al = DeviceAligner(index, opt)
    qs = [s.seq for s in
          read_fastq(r1_path, limit=500)]
    got = al.seeder.collect_flat(qs)
    assert got is not None
    flat, mem_off, fb = got
    mems, fb2 = al.seeder.collect_batch(qs, sort=False)
    assert (fb == fb2).all()
    ref_flat, ref_off = al._pack_mems(mems)
    assert (mem_off == ref_off).all()
    assert np.array_equal(flat, ref_flat)
