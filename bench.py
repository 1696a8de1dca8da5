"""Benchmark: reads aligned/sec/chip on the bundled example data.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
The headline metric is PE (the north-star per BASELINE.json); the SE number
and the identity-gate results ride along as extra fields.
Baseline: mpiBWA 1 rank x 1 thread = 40224 reads / 25.84 s = 1556.7 reads/s
(/root/reference/docs/README.md:216-218).

Numbers only count if the output is right: each configuration is verified
byte-identical to the golden (reference engine) SAM, including the
trimmed-PE variant (mainParallel.c:1520-2556 branch). Throughput is the
MEDIAN of BENCH_PASSES steady passes with the min-max spread reported
alongside.

Runs on an NVIDIA GPU only: with no GPU it exits non-zero before
measuring anything. The output names the device (platform, device_kind,
count), the card's name and power limit, and the host CPU count.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_READS_PER_SEC = 40224 / 25.84  # mpiBWA -n 1 -t 1

DATA = "/root/reference/examples/data"
IDX_TGZ = f"{DATA}/hg19.small.tar.gz"
IDX_DIR = "/tmp/ref"
IDX_PREFIX = f"{IDX_DIR}/hg19.small.fa"


def ensure_index():
    if not os.path.exists(IDX_PREFIX + ".bwt"):
        os.makedirs(IDX_DIR, exist_ok=True)
        subprocess.run(["tar", "xzf", IDX_TGZ, "-C", IDX_DIR], check=True)


def bench_config(idx, dfm, seqs, pe, workers, batch, passes, golden,
                 repeat=1):
    """Warm + timed passes over one configuration; returns
    (per-pass reads/s list, identity ok, steady stage seconds).

    repeat=N feeds the read set N times as N consecutive -K chunks: the
    bundled 10K-pair file is a single chunk, and a one-chunk pass cannot
    exercise the streaming overlap (emit of chunk j over seed of chunk
    j+1) that every real multi-chunk run has. Chunks are pestat-scoped
    and identical, so the golden check is the golden repeated N times —
    identity stays byte-exact."""
    if repeat > 1:
        seqs = [type(s)(name=s.name, seq=s.seq.copy(), qual=s.qual,
                        comment=s.comment) for _ in range(repeat)
                for s in seqs]
    import concurrent.futures

    from mpibwa_tpu.core.opts import MEM_F_PE, mem_opt_init
    from mpibwa_tpu.pipeline.device_align import DeviceAligner

    from mpibwa_tpu.core.fm import FMIndex
    from mpibwa_tpu.core.refseq import RefSeq

    opt = mem_opt_init()
    if pe:
        opt.flag |= MEM_F_PE
    fm, refs = FMIndex.from_index(idx), RefSeq(idx)
    als = [DeviceAligner(idx, opt, dfm=dfm, fm=fm, refs=refs)
           for _ in range(workers)]
    bounds = []
    off = 0
    while off < len(seqs):
        cnt = min(batch, len(seqs) - off)
        bounds.append((off, cnt))
        off += cnt

    def run_pass():
        # pipelined workers share the chip: host finalization of one batch
        # overlaps device compute of another (the kt_pipeline analog).
        # PE chunks are pestat-scoped exactly like the reference's -K
        # chunks (mem_pestat per mem_process_seqs batch, bwamem.c:1226,
        # with n_processed = 0 per untrimmed-PE chunk, mainParallel.c:1314);
        # the PE golden is oracle output with the same ORACLE_BATCH
        def run_worker(wi):
            for bi in range(wi, len(bounds), workers):
                o, cnt = bounds[bi]
                als[wi].process_seqs(seqs[o : o + cnt],
                                     n_processed=0 if pe else o)

        with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
            for fu in [ex.submit(run_worker, wi) for wi in range(workers)]:
                fu.result()

    run_pass()  # warm: compiles every shape the data produces
    # stage timers restart here so stages_s reflects STEADY state (the
    # warm pass buries compile time in whichever stage hit a new shape
    # first)
    for al in als:
        al.stats.pop("t", None)
        getattr(al.seeder, "times", {}).clear()
    if os.environ.get("MPIBWA_BWD_STATS") == "1":
        from mpibwa_tpu.ops import backward8 as B8

        B8.TIMES.clear()
    from mpibwa_tpu import native as _native

    _native.pe_emit_stats(reset=True)  # steady-state PE emit phase split
    n = sum(c for _, c in bounds)
    rates = []
    for _ in range(passes):
        t0 = time.time()
        run_pass()
        rates.append(n / (time.time() - t0))

    ok = True
    if os.path.exists(golden):
        got = "".join(s.sam for s in seqs)
        ok = got == open(golden).read() * repeat
    agg = {}
    for al in als:
        for k, v in al.stats.get("t", {}).items():
            agg[k] = agg.get(k, 0.0) + v
        for k, v in getattr(al.seeder, "times", {}).items():
            agg["seed." + k] = agg.get("seed." + k, 0.0) + v
    pe_ph = _native.pe_emit_stats(reset=True)
    if pe and pe_ph and pe_ph.get("total_s", 0.0) > 0:
        for k, v in pe_ph.items():
            agg["emit." + k] = agg.get("emit." + k, 0.0) + v
    agg = {k: round(v, 2) for k, v in sorted(agg.items())}
    print(f"[bench] stage seconds (sum over workers, warm+timed): {agg}",
          file=sys.stderr)
    if os.environ.get("MPIBWA_BWD_STATS") == "1":
        from mpibwa_tpu.ops import backward8 as B8

        print(f"[bench] v8 driver phases: "
              f"{ {k: (round(v, 2) if isinstance(v, float) else v) for k, v in sorted(B8.TIMES.items())} }",
              file=sys.stderr)
        B8.TIMES.clear()
    return rates, ok, agg


def _median(xs):
    if not xs:
        return 0.0
    xs = sorted(xs)
    m = len(xs) >> 1
    return xs[m] if len(xs) & 1 else 0.5 * (xs[m - 1] + xs[m])


def roofline(idx, dfm):
    """Kernel microbenches: rank queries/s for the O2 backward primitive
    (bwt_occ, bwt.c:98-130) and the extension DP on the device and in the
    native C runtime (ext_dp_timings)."""
    import jax
    import jax.numpy as jnp

    from mpibwa_tpu.ops import backward8 as B8

    out = {}
    o2 = dfm.o2_tables()
    seq_len = dfm.np_idt(dfm.seq_len)
    primary = dfm.np_idt(dfm.primary)

    # -- rank queries/s: chained rounds, each round's positions derived
    # from the previous counts (the dependency chain matches the backward
    # engine's latency-bound structure and prevents elision)
    W = 2048
    R = 64

    @jax.jit
    def rank_rounds(o2, ks):
        def body(i, ks):
            c = (ks & 3).astype(jnp.int32)
            t = B8._occ_c2(o2, primary, ks, c)
            return (ks * 5 + t.astype(ks.dtype) + 1) % seq_len

        return jax.lax.fori_loop(0, R, body, ks)

    rng = np.random.default_rng(3)
    ks0 = jnp.asarray(
        rng.integers(0, int(seq_len), (8, W)).astype(dfm.np_idt))
    rank_rounds(o2, ks0).block_until_ready()  # compile
    t0 = time.time()
    reps = 3
    for _ in range(reps):
        rank_rounds(o2, ks0).block_until_ready()
    dt = (time.time() - t0) / reps
    out["rank_queries_per_sec"] = round(8 * W * R / dt, 0)
    out["rank_round_us"] = round(dt / R * 1e6, 1)

    out.update(ext_dp_timings())
    return out


def ext_dp_timings(reps: int = 5) -> dict:
    """The extension DP (ksw_extend2, ksw.c:380-479) as the plain XLA
    while-loop kernel on the device (inputs staged on the device first)
    against the native C runtime's fin_test_extend_batch on the SAME
    problems: median seconds over `reps` timed runs each after one warm
    run, cells/s with cells = B * Q * min(T, 2w + 1), and whether the two
    agree on every output column."""
    import ctypes

    import jax

    from mpibwa_tpu.core.opts import mem_opt_init
    from mpibwa_tpu.native import get_lib
    from mpibwa_tpu.ops.extend_batch import extend_batch

    rng = np.random.default_rng(3)
    opt = mem_opt_init()
    B, Q, T = 2048, 101, 152
    qs = rng.integers(0, 4, (B, Q)).astype(np.uint8)
    ts = np.empty((B, T), np.uint8)
    ts[:, :Q] = qs
    ts[:, Q:] = rng.integers(0, 4, (B, T - Q)).astype(np.uint8)
    mut = rng.random((B, T)) < 0.02
    ts[mut] = (ts[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    qlens = np.full(B, Q, np.int32)
    tlens = np.full(B, T, np.int32)
    params = np.tile(
        np.asarray([opt.w, opt.pen_clip5, opt.zdrop, 30], np.int32), (B, 1))
    mat = np.asarray(opt.mat, np.int8).reshape(5, 5)
    cells = B * Q * min(T, 2 * opt.w + 1)
    out = {"ext_dp_problems": [B, Q, T], "ext_dp_reps": reps}

    staged = [jax.device_put(x) for x in
              (qs, ts, qlens, tlens, params,
               opt.mat.reshape(5, 5).astype(np.int32))]

    def run():
        return jax.block_until_ready(
            extend_batch(*staged, opt.o_del, opt.e_del, opt.o_ins,
                         opt.e_ins))

    dev = run()  # compile + warm
    dts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        dts.append(time.perf_counter() - t0)
    out["ext_dp_xla_s"] = _median(dts)
    out["ext_dp_xla_cells_per_sec"] = cells / out["ext_dp_xla_s"]

    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    outs = np.zeros((B, 6), np.int32)
    args = (qs.ctypes.data_as(ctypes.c_void_p),
            ts.ctypes.data_as(ctypes.c_void_p),
            qlens.ctypes.data_as(ctypes.c_void_p),
            tlens.ctypes.data_as(ctypes.c_void_p),
            B, Q, T, mat.ctypes.data_as(ctypes.c_void_p),
            opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
            params.ctypes.data_as(ctypes.c_void_p),
            outs.ctypes.data_as(ctypes.c_void_p))
    if lib.fin_test_extend_batch(*args) != 0:  # warm
        raise RuntimeError("fin_test_extend_batch failed")
    dts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        lib.fin_test_extend_batch(*args)
        dts.append(time.perf_counter() - t0)
    out["ext_dp_native_s"] = _median(dts)
    out["ext_dp_native_cells_per_sec"] = cells / out["ext_dp_native_s"]
    got = np.stack([np.asarray(x) for x in dev], axis=1)
    out["ext_dp_identical"] = bool(np.array_equal(
        got.astype(np.int64), outs.astype(np.int64)))
    return out


def card_info() -> str:
    """`name, power.limit` of the first card as nvidia-smi reports them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else \
        "nvidia-smi gave no card"


def device_record(want: int = 1) -> dict:
    """The device as JAX reports it, plus the card and the host; exits
    with status 2 unless JAX's first device is a GPU and at least `want`
    of them are visible."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < want:
        print(f"[E::device] need {want} GPU device(s); JAX reports "
              f"{len(devs)} x {devs[0].platform} ({devs[0].device_kind})",
              file=sys.stderr)
        sys.exit(2)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card_info(),
            "host_cpus": os.cpu_count(), "jax": jax.__version__}


def main():
    from mpibwa_tpu.devices import enable_compile_cache

    enable_compile_cache()
    device = device_record()
    print(f"[bench] device: {device}", file=sys.stderr)
    ensure_index()
    from mpibwa_tpu.index.format import load_index
    from mpibwa_tpu.io.fastq import interleave, read_fastq
    from mpibwa_tpu.ops.fmd import DeviceFMIndex

    idx = load_index(IDX_PREFIX)
    dfm = DeviceFMIndex(idx)
    golden_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "golden")
    batch = int(os.environ.get("BENCH_BATCH", "4096"))
    workers = int(os.environ.get("BENCH_WORKERS", "3"))
    passes = int(os.environ.get("BENCH_PASSES", "5"))
    only = os.environ.get("BENCH_ONLY", "")  # "se"|"pe" to skip the rest

    r1 = read_fastq(f"{DATA}/HCC1187C_R1_10K.fastq")
    r2 = read_fastq(f"{DATA}/HCC1187C_R2_10K.fastq")

    se_rates, pe_rates = [], []
    identity = {}
    stages = {}
    if only in ("", "se"):
        se_rates, identity["se"], stages["se"] = bench_config(
            idx, dfm, list(r1), False, workers, batch, passes,
            os.path.join(golden_dir, "se_10k.sam"))
    if only in ("", "pe"):
        # PE runs as ONE whole-file chunk: mpiBWA's default -K (10M bases x
        # n_threads) covers this 20K-read file in a single chunk, so the
        # faithful configuration is one mem_process_seqs call (pestat is
        # chunk-scoped); golden = whole-batch oracle output. Set
        # BENCH_PE_K=4096 to measure the worker-pipelined -K variant
        # against its own golden instead.
        pe_k = int(os.environ.get("BENCH_PE_K", "0"))
        if pe_k:
            pe_rates, identity["pe"], stages["pe"] = bench_config(
                idx, dfm, interleave(r1, r2), True, workers, pe_k, passes,
                os.path.join(golden_dir, f"pe_10k_k{pe_k}.sam"))
        else:
            pe_rates, identity["pe"], stages["pe"] = bench_config(
                idx, dfm, interleave(r1, r2), True, workers, len(r1) * 2,
                passes, os.path.join(golden_dir, "pe_10k.sam"),
                repeat=int(os.environ.get("BENCH_PE_REPEAT", "2")))
    se_rps, pe_rps = _median(se_rates), _median(pe_rates)
    series = None
    series_pe = None
    if os.environ.get("BENCH_SERIES"):
        # measured worker-scaling series (fewer passes): how much the
        # pipelined-worker overlap actually buys on this host, recorded so
        # scaling claims are data, not design intent — SE and PE both
        # (the PE emit path loads the host cores very differently)
        series = {}
        series_pe = {}
        for w in range(1, workers + 1):
            rs, _, _ = bench_config(idx, dfm, list(r1), False, w, batch,
                                 max(2, passes - 2),
                                 os.path.join(golden_dir, "se_10k.sam"))
            series[str(w)] = round(_median(rs), 1)
            rp, _, _ = bench_config(
                idx, dfm, interleave(r1, r2), True, w, len(r1) * 2,
                max(2, passes - 2),
                os.path.join(golden_dir, "pe_10k.sam"), repeat=2)
            series_pe[str(w)] = round(_median(rp), 1)
    if only == "" and os.environ.get("BENCH_TRIM", "1") == "1":
        # trimmed-PE identity gate (variable read lengths; not timed;
        # whole-file batch like the committed golden)
        t1 = read_fastq(f"{DATA}/HCC1187C_R1_10K_TRIM.fastq")
        t2 = read_fastq(f"{DATA}/HCC1187C_R2_10K_TRIM.fastq")
        _, identity["pe_trim"], _ = bench_config(
            idx, dfm, interleave(t1, t2), True, workers, len(t1) * 2, 0,
            os.path.join(golden_dir, "pe_10k_trim.sam"))

    rf = {}
    if os.environ.get("BENCH_ROOFLINE", "1") == "1":
        try:
            rf = roofline(idx, dfm)
        except Exception as e:
            rf = {"error": repr(e)[:200]}
        print(f"[bench] roofline: {rf}", file=sys.stderr)

    import jax

    mem = jax.devices()[0].memory_stats() or {}
    peak = mem.get("peak_bytes_in_use")
    print(f"[bench] peak_bytes_in_use: {peak}", file=sys.stderr)

    ok = all(identity.values())
    headline = pe_rps if only != "se" else se_rps
    print(json.dumps({
        "metric": "reads_aligned_per_sec_per_chip_"
                  + ("se" if only == "se" else "pe")
                  + ("" if ok else "_WRONG_OUTPUT"),
        "value": round(headline, 1),
        "unit": "reads/s",
        "vs_baseline": round(headline / BASELINE_READS_PER_SEC, 3),
        "se_reads_per_sec": round(se_rps, 1),
        "se_vs_baseline": round(se_rps / BASELINE_READS_PER_SEC, 3),
        "pe_spread": [round(min(pe_rates), 1), round(max(pe_rates), 1)]
                     if pe_rates else None,
        "se_spread": [round(min(se_rates), 1), round(max(se_rates), 1)]
                     if se_rates else None,
        "passes": passes,
        "workers": workers,
        "worker_series_se": series,
        "worker_series_pe": series_pe,
        "identity": identity,
        "stages_s": stages,
        "roofline": rf,
        "peak_bytes_in_use": peak,
        "device": device,
    }))


if __name__ == "__main__":
    main()
