"""Device (JAX) kernels vs the exact scalar engine."""

import numpy as np
import pytest

from mpibwa_tpu.core.chain import collect_intv
from mpibwa_tpu.core.fm import FMIndex
from mpibwa_tpu.core.opts import mem_opt_init
from mpibwa_tpu.io.fastq import read_fastq


@pytest.fixture(scope="module")
def dfm(index):
    from mpibwa_tpu.ops.fmd import DeviceFMIndex

    return DeviceFMIndex(index)


@pytest.fixture(scope="module")
def fm(index):
    return FMIndex.from_index(index)


def test_device_occ4(dfm, fm):
    import jax.numpy as jnp

    ks = np.arange(-1, fm.seq_len + 1, 2311, dtype=np.int64)
    got = np.asarray(dfm.occ4(jnp.asarray(ks)))
    want = fm.occ4_batch(ks)
    np.testing.assert_array_equal(got, want)


def test_device_sa(dfm, fm):
    import jax.numpy as jnp

    ks = np.arange(0, fm.seq_len + 1, 3307, dtype=np.int64)
    got = np.asarray(dfm.sa_lookup(jnp.asarray(ks))).astype(np.uint64)
    want = np.array([np.uint64(fm.sa_lookup(int(k))) for k in ks], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


def test_device_extend_matches_scalar(dfm, fm):
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    iks = []
    for _ in range(50):
        c = int(rng.integers(4))
        ik = fm.set_intv(c)
        iks.append(ik)
    ik_arr = jnp.asarray(np.array(iks, dtype=np.int64))
    for is_back in (0, 1):
        got = np.asarray(dfm.extend(ik_arr, is_back))
        for i, ik in enumerate(iks):
            want = fm.extend(ik, is_back)
            np.testing.assert_array_equal(got[i], np.array(want))


def test_device_collect_intv(dfm, fm, index, r1_path):
    from mpibwa_tpu.pipeline.device_seed import DeviceSeeder

    opt = mem_opt_init()
    seeder = DeviceSeeder(dfm, opt)
    reads = read_fastq(r1_path, limit=48)
    got, fallback = seeder.collect_batch([s.seq for s in reads])
    n_checked = 0
    for i, s in enumerate(reads):
        if got[i] is None:
            continue
        want = collect_intv(opt, fm, s.seq)
        assert got[i] == want, f"device collect mismatch for {s.name}"
        n_checked += 1
    assert n_checked >= 40  # nearly all reads must take the device path


@pytest.mark.parametrize("mode", ["contig", "flat", "v8"])
def test_backward_engines_match_scalar(dfm, fm, mode, monkeypatch, r1_path):
    """Every backward-SMEM engine (XLA contig, exact flat, v8
    minimal-gather) must reproduce the scalar bwt_smem1a emission
    exactly (bwt.c:289-351). v8 does not maintain x[1] (consumed by
    nothing downstream — see ops/backward8.py) so it is compared on
    (x0, x2, info)."""
    from mpibwa_tpu.pipeline.device_seed import DeviceSeeder

    monkeypatch.setenv("MPIBWA_BWD", mode)
    opt = mem_opt_init()
    seeder = DeviceSeeder(dfm, opt)
    reads = read_fastq(r1_path, limit=32)
    got, fallback = seeder.collect_batch([s.seq for s in reads])

    def key(ivs):
        if mode == "v8":
            return [(iv[0], iv[2], iv[3]) for iv in ivs]
        return ivs

    n_checked = 0
    for i, s in enumerate(reads):
        if got[i] is None:
            continue
        want = collect_intv(opt, fm, s.seq)
        assert key(got[i]) == key(want), f"{mode} mismatch for {s.name}"
        n_checked += 1
    assert n_checked >= 28


def test_v8_shrink_schedule_exact(dfm, fm, monkeypatch, r1_path):
    """The v8 static shrink schedule (compact + halve, overflow flags) must
    not change results; force it to run by shrinking the tail threshold."""
    from mpibwa_tpu.ops import backward8 as B8
    from mpibwa_tpu.pipeline.device_seed import DeviceSeeder

    monkeypatch.setenv("MPIBWA_BWD", "v8")
    monkeypatch.setattr(B8, "MIN_CAP", 256)
    monkeypatch.setattr(B8, "SEG_ROUNDS", 2)
    opt = mem_opt_init()
    seeder = DeviceSeeder(dfm, opt)
    reads = read_fastq(r1_path, limit=24)
    got, _ = seeder.collect_batch([s.seq for s in reads])
    for i, s in enumerate(reads):
        if got[i] is None:
            continue
        want = collect_intv(opt, fm, s.seq)
        assert [(iv[0], iv[2], iv[3]) for iv in got[i]] == \
            [(iv[0], iv[2], iv[3]) for iv in want], s.name


def test_microbatch_boundary_identity(dfm, index, r1_path):
    """Batches crossing the internal microbatch size must not change output
    (regression: the cigar precompute once used stale device rows)."""
    from mpibwa_tpu.core.opts import mem_opt_init
    from mpibwa_tpu.pipeline.device_align import DeviceAligner

    al = DeviceAligner(index, mem_opt_init())
    al.MICROBATCH = 64  # force several microbatches on a small read count
    reads = read_fastq(r1_path, limit=150)
    al.process_seqs(reads, n_processed=0)
    got = "".join(s.sam for s in reads)
    whole = read_fastq(r1_path, limit=150)
    DeviceAligner(index, mem_opt_init()).process_seqs(whole, n_processed=0)
    assert got == "".join(s.sam for s in whole)


# -- int64 (GRCh38-scale) position path, forced on the small index ----------


@pytest.fixture(scope="module")
def dfm_wide(index):
    """The same index through the int64 position path (force_wide): the
    engines a doubled genome >= 2^31 takes (full human = 6.2e9
    positions). Counts/gathers stay int32; only
    position arithmetic widens, so every result must be bit-identical to
    the int32 path / scalar engine."""
    from mpibwa_tpu.ops.fmd import DeviceFMIndex

    return DeviceFMIndex(index, force_wide=True)


def test_wide_occ4_and_sa(dfm_wide, fm):
    import jax.numpy as jnp

    assert dfm_wide.idt == jnp.int64
    ks = np.arange(-1, fm.seq_len + 1, 2311, dtype=np.int64)
    got = np.asarray(dfm_wide.occ4_16(jnp.asarray(ks)))
    np.testing.assert_array_equal(got, fm.occ4_batch(ks))
    ks = np.arange(0, fm.seq_len + 1, 3307, dtype=np.int64)
    got = np.asarray(dfm_wide.sa_lookup(jnp.asarray(ks))).astype(np.uint64)
    want = np.array([np.uint64(fm.sa_lookup(int(k))) for k in ks],
                    dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


def test_wide_v8_backward_matches_scalar(dfm_wide, fm, monkeypatch, r1_path):
    """v8 with int64 positions (the GRCh38-scale engine) reproduces scalar
    bwt_smem1a emission on (x0, x2, info) exactly (bwt.c:289-351)."""
    from mpibwa_tpu.pipeline.device_seed import DeviceSeeder

    monkeypatch.setenv("MPIBWA_BWD", "v8")
    opt = mem_opt_init()
    seeder = DeviceSeeder(dfm_wide, opt)
    reads = read_fastq(r1_path, limit=32)
    got, fallback = seeder.collect_batch([s.seq for s in reads])
    n_checked = 0
    for i, s in enumerate(reads):
        if got[i] is None:
            continue
        want = collect_intv(opt, fm, s.seq)
        assert [(iv[0], iv[2], iv[3]) for iv in got[i]] == \
            [(iv[0], iv[2], iv[3]) for iv in want], s.name
        n_checked += 1
    assert n_checked >= 28


def test_wide_collect_flat_rows(dfm_wide, dfm, monkeypatch, r1_path):
    """The arrays-end-to-end seeder through the wide engines returns the
    same flat interval rows as the int32 path (row-for-row)."""
    from mpibwa_tpu.pipeline.device_seed import DeviceSeeder

    monkeypatch.setenv("MPIBWA_BWD", "v8")
    opt = mem_opt_init()
    reads = read_fastq(r1_path, limit=48)
    qs = [s.seq for s in reads]
    out32 = DeviceSeeder(dfm, opt).collect_flat(qs)
    out64 = DeviceSeeder(dfm_wide, opt).collect_flat(qs)
    assert out32 is not None and out64 is not None
    np.testing.assert_array_equal(out32[0], out64[0])
    np.testing.assert_array_equal(out32[1], out64[1])
    np.testing.assert_array_equal(out32[2], out64[2])


def test_v8_schedule_replay_and_retry(dfm, fm, monkeypatch, r1_path):
    """The learned-schedule replay (second run of a shape: no live-count
    syncs) must emit exactly what the adaptive first run did; a poisoned
    (too-small) schedule must be invalidated and redone adaptively, not
    produce wrong output."""
    from mpibwa_tpu.ops import backward8 as B8
    from mpibwa_tpu.pipeline.device_seed import DeviceSeeder

    monkeypatch.setenv("MPIBWA_BWD", "v8")
    monkeypatch.setattr(B8, "MIN_CAP", 256)
    monkeypatch.setattr(B8, "SEG_ROUNDS", 2)
    B8.SCHED_CACHE.clear()
    opt = mem_opt_init()
    seeder = DeviceSeeder(dfm, opt)
    reads = read_fastq(r1_path, limit=24)
    qs = [s.seq for s in reads]
    first, _ = seeder.collect_batch(qs)   # adaptive (records schedules)
    assert B8.SCHED_CACHE, "adaptive run should record schedules"
    replay, _ = seeder.collect_batch(qs)  # static replay (no syncs)
    assert first == replay
    want = [collect_intv(opt, fm, s.seq) for s in reads]
    for i in range(len(reads)):
        if replay[i] is None:
            continue
        assert [(iv[0], iv[2], iv[3]) for iv in replay[i]] == \
            [(iv[0], iv[2], iv[3]) for iv in want[i]]
    # poison every schedule to the floor: replays must overflow, retry
    # adaptively, and still match
    for k in list(B8.SCHED_CACHE):
        B8.SCHED_CACHE[k] = (256,)
    retried, _ = seeder.collect_batch(qs)
    assert retried == first
    # the overflowing shapes re-recorded sane schedules (a poisoned
    # schedule that happens to FIT a small group legitimately survives)
    assert any(v != (256,) for v in B8.SCHED_CACHE.values())


def test_p2_speculative_matches_sync(dfm, monkeypatch, r1_path):
    """The sync-free pass-2 route (device-built lane tables, speculative
    entry capacity — activates once the seeder has an estimate, i.e. from
    the second batch) must return exactly the synchronous route's rows,
    including when the speculative capacity is poisoned too small (the
    overflow flag must force the synchronous redo, not truncate)."""
    from mpibwa_tpu.pipeline.device_seed import DeviceSeeder

    monkeypatch.setenv("MPIBWA_BWD", "v8")
    opt = mem_opt_init()
    reads = read_fastq(r1_path, limit=64)
    qs = [s.seq for s in reads]
    base = DeviceSeeder(dfm, opt)
    want = base.collect_flat(qs)  # first batch: synchronous route
    assert want is not None and "e" in base._p2_est
    got = base.collect_flat(qs)  # second batch: speculative route
    assert got is not None
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[1], got[1])
    np.testing.assert_array_equal(want[2], got[2])
    # genuine capacity miss: shrink the bucket floor so the speculative
    # cap lands below the real entry count -> device overflow flag ->
    # synchronous redo (not a truncated result)
    from mpibwa_tpu.ops import backward8 as B8

    real_e = int(base._p2_est["e"])
    assert real_e > 8
    orig_bucket = B8.cap_bucket
    calls = {"n": 0}

    spec_n = max(real_e * 5 // 4, 1024)  # the speculative-cap request

    def tiny_bucket(n, floor=B8.MIN_CAP):
        # poison ONLY the speculative-cap call (pass 1's exact pad uses
        # the same floor, with its own entry count); shrinking an EXACT
        # pad would violate a production invariant (cap_bucket always
        # returns >= n there)
        if floor == 1024 and n == spec_n and calls["n"] == 0:
            calls["n"] += 1
            return 8
        return orig_bucket(n, floor)

    monkeypatch.setattr(B8, "cap_bucket", tiny_bucket)
    got2 = base.collect_flat(qs)
    assert got2 is not None
    np.testing.assert_array_equal(want[0], got2[0])
    assert calls["n"] == 1  # the speculative cap was actually poisoned
