"""Flag-matrix differential: the native (C) record path must match the
Python path byte for byte under every finalization-affecting CLI flag
(-a, -Y, -M, -5, -q, -V, -C comments, -R read groups, -S no-rescue),
on both SE and PE batches."""

import os

import pytest

from mpibwa_tpu.core import opts as O
from mpibwa_tpu.core.opts import mem_opt_init
from mpibwa_tpu.io.fastq import interleave, read_fastq
from mpibwa_tpu.native import get_lib


CASES = [
    ("all", O.MEM_F_ALL, ""),
    ("softclip", O.MEM_F_SOFTCLIP, ""),
    ("no_multi", O.MEM_F_NO_MULTI, ""),
    ("primary5", O.MEM_F_PRIMARY5 | O.MEM_F_KEEP_SUPP_MAPQ, ""),
    ("keep_supp", O.MEM_F_KEEP_SUPP_MAPQ, ""),
    ("ref_hdr", O.MEM_F_REF_HDR, ""),
    ("no_rescue", O.MEM_F_NO_RESCUE, ""),
    ("rg", 0, "rg1"),
]


@pytest.fixture(scope="module")
def lib():
    lib = get_lib()
    if lib is None:
        pytest.skip("native library unavailable")
    return lib


@pytest.fixture(scope="module")
def _load(r1_path, r2_path):
    def load(pe, n=120, comments=False):
        r1 = read_fastq(r1_path, limit=n, copy_comment=comments)
        if not pe:
            return r1
        r2 = read_fastq(r2_path, limit=n, copy_comment=comments)
        return interleave(r1, r2)

    return load


@pytest.mark.parametrize("pe", [False, True])
@pytest.mark.parametrize("name,flag,rg", CASES, ids=[c[0] for c in CASES])
def test_flag_native_vs_python(lib, index, _load, pe, name, flag, rg):
    from mpibwa_tpu.pipeline.device_align import DeviceAligner

    opt = mem_opt_init()
    opt.flag |= flag
    if pe:
        opt.flag |= O.MEM_F_PE
    al = DeviceAligner(index, opt)
    comments = name == "rg"  # exercise comment passthrough alongside RG
    a = _load(pe, comments=comments)
    b = _load(pe, comments=comments)
    assert al._process_seqs_native(a, 0, None, rg), name
    os.environ["MPIBWA_CHAIN"] = "python"
    os.environ["MPIBWA_FINAL"] = "python"
    try:
        al._finalizer = None  # rebuild with the env knobs applied
        al._chainer = None
        al.process_seqs(b, n_processed=0, rg_id=rg)
    finally:
        os.environ.pop("MPIBWA_CHAIN")
        os.environ.pop("MPIBWA_FINAL")
        al._finalizer = None
        al._chainer = None
    for x, y in zip(a, b):
        assert x.sam == y.sam, (name, pe, x.name, x.sam, y.sam)


def test_pes0_override_native_vs_python(lib, index, _load):
    """-I explicit insert stats (pes0) must flow through the native path
    identically (skips pestat entirely, like mainParallel.c's -I)."""
    from mpibwa_tpu.core.pair import PEStat
    from mpibwa_tpu.pipeline.device_align import DeviceAligner

    def mkpes():
        pes = [PEStat(failed=1) for _ in range(4)]
        p = pes[1]
        p.failed = 0
        p.avg = 200.0
        p.std = 20.0
        p.high = int(p.avg + 4.0 * p.std + 0.499)
        p.low = max(int(p.avg - 4.0 * p.std + 0.499), 1)
        return pes

    opt = mem_opt_init()
    opt.flag |= O.MEM_F_PE
    al = DeviceAligner(index, opt)
    a = _load(True)
    b = _load(True)
    assert al._process_seqs_native(a, 0, mkpes(), "")
    os.environ["MPIBWA_CHAIN"] = "python"
    os.environ["MPIBWA_FINAL"] = "python"
    try:
        al._finalizer = None
        al._chainer = None
        al.process_seqs(b, n_processed=0, pes0=mkpes())
    finally:
        os.environ.pop("MPIBWA_CHAIN")
        os.environ.pop("MPIBWA_FINAL")
        al._finalizer = None
        al._chainer = None
    for x, y in zip(a, b):
        assert x.sam == y.sam, (x.name,)
