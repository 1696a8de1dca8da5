"""FM-index engine vs oracle golden fixtures (occ/sa/smem, on the
hg19.small index they were made from) and device vs host rank paths."""

import numpy as np
import pytest

from mpibwa_tpu.core.fm import FMIndex
from mpibwa_tpu.core.sortutil import ks_introsort
from mpibwa_tpu.index.format import NT4_TABLE


@pytest.fixture(scope="module")
def fm(golden_index):
    return FMIndex.from_index(golden_index)


def read_fastq_names_seqs(path, limit=None):
    out = []
    with open(path) as f:
        lines = f.read().splitlines()
    for i in range(0, len(lines), 4):
        name = lines[i].split()[0][1:]
        if name.endswith("/1") or name.endswith("/2"):
            name = name[:-2]
        out.append((name, lines[i + 1]))
        if limit and len(out) >= limit:
            break
    return out


def test_occ4_vs_golden(fm, golden_dir):
    rows = np.loadtxt(golden_dir / "occ_97.txt", dtype=np.int64)
    ks = rows[:, 0] - 1  # oracle dumps occ4(k-1)
    got = fm.occ4_batch(ks)
    np.testing.assert_array_equal(got, rows[:, 1:])
    # scalar path spot-check
    for k in ks[::97]:
        np.testing.assert_array_equal(fm.occ4(int(k)), fm.occ4_batch([k])[0])


def test_sa_vs_golden(fm, golden_dir):
    rows = np.loadtxt(golden_dir / "sa_101.txt", dtype=np.uint64)
    for k, want in rows[::7]:
        assert fm.sa_lookup(int(k)) == int(want), f"sa({k})"


def collect_seeds(fm, q, opt_min_seed_len=19, split_factor=1.5, split_width=10,
                  max_mem_intv=20):
    """mem_collect_intv 3-pass logic (bwamem.c:114-162)."""
    mem = []
    split_len = int(opt_min_seed_len * split_factor + 0.499)
    x = 0
    n = len(q)
    while x < n:
        if q[x] < 4:
            x, m1 = fm.smem1(q, x, 1)
            for iv in m1:
                slen = (iv[3] & 0xFFFFFFFF) - (iv[3] >> 32)
                if slen >= opt_min_seed_len:
                    mem.append(iv)
        else:
            x += 1
    old_n = len(mem)
    for k in range(old_n):
        iv = mem[k]
        start, end = iv[3] >> 32, iv[3] & 0xFFFFFFFF
        if end - start < split_len or iv[2] > split_width:
            continue
        _, m1 = fm.smem1(q, (start + end) >> 1, iv[2] + 1)
        for jv in m1:
            if (jv[3] & 0xFFFFFFFF) - (jv[3] >> 32) >= opt_min_seed_len:
                mem.append(jv)
    if max_mem_intv > 0:
        x = 0
        while x < n:
            if q[x] < 4:
                x, m = fm.seed_strategy1(q, x, opt_min_seed_len, max_mem_intv)
                if m is not None and m[2] > 0:
                    mem.append(m)
            else:
                x += 1
    ks_introsort(mem, lambda a, b: a[3] < b[3])
    return mem


def test_smem_vs_golden(fm, golden_dir, golden_fastq):
    reads = read_fastq_names_seqs(golden_fastq("HCC1187C_R1_10K.fastq"),
                                  limit=1000)
    golden = {}
    with open(golden_dir / "smem_1k.txt") as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        name, cnt = lines[i][1:].rsplit(" ", 1)
        cnt = int(cnt)
        golden[name] = [tuple(int(v) for v in lines[i + 1 + j].split()) for j in range(cnt)]
        i += 1 + cnt
    checked = 0
    for name, seq in reads[:200]:
        q = NT4_TABLE[np.frombuffer(seq.encode(), dtype=np.uint8)]
        got = collect_seeds(fm, q)
        assert got == golden[name], f"smem mismatch for {name}"
        checked += 1
    assert checked == 200


def test_occ4_16_matches_occ4(index):
    """The OCC16 rank path (multiply-free, one sub-block) must equal occ4
    bit for bit, incl. sentinels, the primary skip and block edges."""
    import jax.numpy as jnp
    import numpy as np

    from mpibwa_tpu.ops.fmd import DeviceFMIndex

    fm = DeviceFMIndex(index)
    rng = np.random.default_rng(0)
    ks = np.concatenate([
        rng.integers(-1, fm.seq_len, 4000),
        [-1, 0, 1, 15, 16, 17, 127, 128, fm.seq_len - 1, fm.seq_len,
         fm.primary, fm.primary - 1, fm.primary + 1]])
    a = np.asarray(fm.occ4(jnp.asarray(ks)))
    b = np.asarray(fm.occ4_16(jnp.asarray(ks)))
    assert np.array_equal(a, b)
    ks2 = rng.integers(-1, fm.seq_len, (8, 256))
    assert np.array_equal(np.asarray(fm.occ4(jnp.asarray(ks2))),
                          np.asarray(fm.occ4_16(jnp.asarray(ks2))))
