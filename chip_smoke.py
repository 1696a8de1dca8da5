#!/usr/bin/env python3
"""Smoke test of the served alignment path on NVIDIA GPUs.

    python chip_smoke.py                 # one card
    python chip_smoke.py --cards 4       # the multi-card paths only

One card, in one process (never a second JAX process on the card):

1. device: JAX's first device must be a GPU; prints the card's name and
   power limit (nvidia-smi), device_kind, host CPU count, JAX version;
2. native runtime: compiles native/_libmpibwa.so from the sources and
   fails unless it loads (no silent Python fallback);
3. data: a seeded genome of GRCh38 chr1's length (one contig instead of
   the 3.1 Gbp genome, so that the index builds inside one run), its
   index (`cli index`, SA-IS), 200,000 2x150 read pairs under wgsim's
   model (mpibwa_tpu/io/simulate.py), all under smoke_work/;
4. main path: `cli mem -t 8` on the pairs (PE), then on the first 50,000
   read-1 records (SE), through mpibwa_tpu.cli.main; prints compile and
   steady seconds, reads/s, peak device bytes, the backward engine, the
   host-fallback share and the share of reads aligned at their simulated
   origin, and fails when a share crosses its bound;
5. reference: 2,000 SE reads and 1,000 pairs through `cli mem` on the GPU
   and through Runtime(use_device=False), the exact Python engine in
   core/; the SAM bodies must be byte-identical (all device arithmetic is
   integer, so the tolerance is equality);
6. plain-version timings (findings, not claims): the XLA extension DP
   against the native C kernel on identical problems, and the v8 backward
   per 16,384-read microbatch;
7. last line: {"ok": true, "device": {"platform", "kind", "count"}}.

--cards 4 runs only `cli launch -n 4` (one shard process per card, started
before this process opens any card) and MPIBWA_DEVICES=all over the four
cards, and compares both with the one-card output byte for byte.

Exits non-zero, printing no result line, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from bench import _median, card_info, device_record, ext_dp_timings  # noqa: E402
from mpibwa_tpu.io import simulate as S  # noqa: E402

WORK = os.path.join(REPO, "smoke_work")

# Bounds on the PE run, set from the CPU rehearsal of the same generator
# settings (CHANGES.md): truth share 1.0000 at 20 Mbp and 0.9997 at 3 Mbp,
# no read on the host fallback.
TRUTH_MIN = 0.99
FALLBACK_MAX = 0.001


class _Tee(io.TextIOBase):
    """stderr that is also kept, to read the runtime's own summary."""

    def __init__(self, under):
        self.under, self.buf = under, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.under.write(s)

    def flush(self):
        self.under.flush()


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling (monitoring
    events), so a timed run can report compile and steady time apart."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax.monitoring

        self.seconds = 0.0
        self.compiles = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration
            self.compiles += event == self.EVENTS[-1]


def build_native() -> str:
    from mpibwa_tpu import native

    path = native.rebuild()
    if native.get_lib() is None:
        raise RuntimeError(f"native library {path} does not load")
    return path


def make_data(work: str, genome_bp: int, n_pairs: int, seed: int) -> dict:
    """Genome + index + reads under work; returns paths and seconds."""
    from mpibwa_tpu import cli

    t0 = time.time()
    spec = S.GenomeSpec(contig_lengths=(genome_bp,), seed=seed)
    fa, r1, r2 = S.make_dataset(work, spec, n_pairs, read_seed=seed)
    t1 = time.time()
    if cli.main(["index", fa]) != 0:
        raise RuntimeError("cli index failed")
    return {"ref": fa, "r1": r1, "r2": r2, "generate_s": t1 - t0,
            "index_s": time.time() - t1}


def head_fastq(src: str, dst: str, n: int) -> str:
    with open(src) as f, open(dst, "w") as g:
        for i, line in enumerate(f):
            if i >= 4 * n:
                break
            g.write(line)
    return dst


def run_mem(args, clock=None) -> dict:
    """cli.main(["mem", *args]) in this process: rc, wall and compile
    seconds, and the runtime's summary line."""
    from mpibwa_tpu import cli

    tee = _Tee(sys.stderr)
    c0 = (clock.seconds, clock.compiles) if clock else (0.0, 0)
    t0 = time.time()
    with contextlib.redirect_stderr(tee):
        rc = cli.main(["mem"] + list(args))
    wall = time.time() - t0
    gc.collect()  # drop the run's device index before the next one
    out = {"rc": rc, "wall_s": wall}
    if clock:
        out["compile_s"] = clock.seconds - c0[0]
        out["compiles"] = clock.compiles - c0[1]
    m = re.search(r"\[M::main_mem\] (\d+) reads; (\d+) took the host "
                  r"fallback; backward engine (\w+)", tee.buf.getvalue())
    if m:
        out.update(reads=int(m.group(1)), fallback=int(m.group(2)),
                   engine=m.group(3))
    # the runtime's own clock around its chunk loop (no index load)
    m = re.search(r"processed \d+ reads, \d+/\d+ chunks in ([\d.]+)s",
                  tee.buf.getvalue())
    if m:
        out["execute_s"] = float(m.group(1))
    if rc != 0:
        raise RuntimeError(f"cli mem {args} exited with {rc}")
    return out


def sam_body(path: str) -> bytes:
    with open(path, "rb") as f:
        return b"".join(ln for ln in f if not ln.startswith(b"@"))


def reference_sam(idx, r1: str, r2, out: str, n_threads: int = 8):
    """The same reads through the exact Python engine (core/), with the
    options `cli mem -t n_threads` uses."""
    from mpibwa_tpu.core import opts as O
    from mpibwa_tpu.parallel.runtime import Runtime

    opt = O.mem_opt_init()
    opt.n_threads = n_threads
    O.rescale_by_a(opt, set(), preset=None)
    opt.mat = O.fill_scmat(opt.a, opt.b)
    opt.round_float_fields()
    rt = Runtime(idx, opt, use_device=False,
                 fixed_chunk_size=opt.chunk_size * n_threads, verbose=False)
    return rt.run(r1, r2, out)


def compare_reference(data: dict, work: str, n_se: int = 2000,
                      n_pairs: int = 1000) -> dict:
    """GPU `cli mem` vs the core/ engine on their own small inputs."""
    from mpibwa_tpu.index.format import load_index

    idx = load_index(data["ref"])
    se = head_fastq(data["r1"], os.path.join(work, "ref_se.fq"), n_se)
    p1 = head_fastq(data["r1"], os.path.join(work, "ref_r1.fq"), n_pairs)
    p2 = head_fastq(data["r2"], os.path.join(work, "ref_r2.fq"), n_pairs)
    out = {}
    for name, reads in (("se", [se]), ("pe", [p1, p2])):
        dev = os.path.join(work, f"ref_{name}_device")
        host = os.path.join(work, f"ref_{name}_core")
        run_mem(["-t", "8", "-o", dev, data["ref"]] + reads)
        t0 = time.time()
        reference_sam(idx, reads[0], reads[1] if len(reads) > 1 else None,
                      host)
        a, b = sam_body(dev + ".sam"), sam_body(host + ".sam")
        out[name] = {"identical": a == b, "records": a.count(b"\n"),
                     "core_s": time.time() - t0}
    return out


def backward_timing(ref: str, r1: str, reps: int = 5) -> dict:
    """Seconds the v8 backward takes per 16,384-read microbatch: host
    clock around its synchronous calls (the result pull included), median
    of `reps` after one warm run."""
    from mpibwa_tpu.core.opts import mem_opt_init
    from mpibwa_tpu.index.format import load_index
    from mpibwa_tpu.io.fastq import read_fastq
    from mpibwa_tpu.ops import backward8 as B8
    from mpibwa_tpu.ops.fmd import DeviceFMIndex
    from mpibwa_tpu.pipeline.device_seed import DeviceSeeder

    seeder = DeviceSeeder(DeviceFMIndex(load_index(ref)), mem_opt_init())
    qs = [s.seq for s in read_fastq(r1, limit=16384)]
    orig = B8.run_backward8
    spent = []

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return orig(*a, **k)
        finally:
            spent[-1] += time.perf_counter() - t0

    B8.run_backward8 = timed
    try:
        per = []
        for _ in range(reps + 1):
            spent.append(0.0)
            seeder.collect_flat(qs)
            per.append(spent[-1])
    finally:
        B8.run_backward8 = orig
    return {"v8_backward_s_per_microbatch": _median(per[1:]),
            "microbatch_reads": len(qs), "reps": reps}


def one_card(a) -> dict:
    import jax

    device = device_record()
    card = device["card"]
    print(card, flush=True)
    print(f"[device] card: {card}; kind: {device['kind']}; host cpus: "
          f"{device['host_cpus']}; jax {device['jax']}", flush=True)
    clock = CompileClock()
    print(f"[native] built {build_native()}", flush=True)
    data = make_data(WORK, a.genome_bp, a.pairs, a.seed)
    print(f"[data] one contig of {a.genome_bp} bp (GRCh38 chr1's length "
          f"by default; cut from the 3.1 Gbp genome so the index builds in "
          f"one run), {a.pairs} 2x150 pairs; set-up: generate "
          f"{data['generate_s']:.1f} s, index {data['index_s']:.1f} s",
          flush=True)

    se = head_fastq(data["r1"], os.path.join(WORK, "se.fq"), a.se_reads)
    runs = {}
    for name, reads in (("pe", [data["r1"], data["r2"]]), ("se", [se])):
        # the first run compiles every shape the input produces; the second
        # one, on the same input, is the steady state
        for phase in ("compile", "steady"):
            runs[name, phase] = run_mem(
                ["-t", "8", "-o", os.path.join(WORK, f"{name}_{phase}"),
                 data["ref"]] + reads, clock)
        if name == "pe":
            peak = (jax.devices()[0].memory_stats() or {}).get(
                "peak_bytes_in_use")
    for name in ("pe", "se"):
        c, r = runs[name, "compile"], runs[name, "steady"]
        hits, total = S.truth_share(os.path.join(WORK, f"{name}_steady.sam"))
        r["truth"] = hits / total
        print(f"[{name}] {r['reads']} reads: first run {c['wall_s']:.2f} s "
              f"({c['compile_s']:.2f} s in {c['compiles']} compiles, "
              f"summed over threads); steady run {r['wall_s']:.2f} s "
              f"({r['compiles']} compiles), {r['reads'] / r['wall_s']:.1f} "
              f"reads/s with the index load, "
              f"{r['reads'] / r['execute_s']:.1f} reads/s over the "
              f"runtime's {r['execute_s']:.1f} s chunk loop, on {card}; "
              f"backward "
              f"engine {r['engine']}; host fallback "
              f"{r['fallback']}/{r['reads']}; truth share "
              f"{hits}/{total} = {r['truth']:.4f}", flush=True)
    pe = runs["pe", "steady"]
    print(f"[pe] peak_bytes_in_use {peak} on {card}", flush=True)
    fb_share = pe["fallback"] / pe["reads"]
    ok = pe["truth"] >= TRUTH_MIN and fb_share <= FALLBACK_MAX
    print(f"[bounds] truth share >= {TRUTH_MIN}, fallback share <= "
          f"{FALLBACK_MAX}: {'ok' if ok else 'FAILED'}", flush=True)

    ref = compare_reference(data, WORK)
    for name, r in ref.items():
        print(f"[reference] {name}: {r['records']} records, byte-identical "
              f"to core/: {r['identical']} (core/ took {r['core_s']:.1f} s)",
              flush=True)
    ok &= all(r["identical"] for r in ref.values())

    dp = ext_dp_timings(reps=5)
    print(f"[plain] extension DP {dp['ext_dp_problems']}: XLA "
          f"{dp['ext_dp_xla_s'] * 1e3:.3f} ms vs native C "
          f"{dp['ext_dp_native_s'] * 1e3:.3f} ms (median of 5; identical "
          f"{dp['ext_dp_identical']}) on {card}", flush=True)
    bt = backward_timing(data["ref"], data["r1"])
    print(f"[plain] v8 backward {bt['v8_backward_s_per_microbatch']:.4f} "
          f"s per {bt['microbatch_reads']}-read microbatch (median of "
          f"{bt['reps']}, host clock, result pull included) on {card}",
          flush=True)
    ok &= dp["ext_dp_identical"]
    if not ok:
        print("[smoke] FAILED", flush=True)
        sys.exit(1)
    return device


def four_cards(a) -> dict:
    """launch -n 4 first (this process holds no card), then the in-process
    one-card and MPIBWA_DEVICES=all runs; all three outputs must agree."""
    from mpibwa_tpu.devices import local_gpus

    if len(local_gpus()) < a.cards:
        print(f"[E::device] need {a.cards} cards, nvidia-smi shows "
              f"{len(local_gpus())}", file=sys.stderr)
        sys.exit(2)
    card = card_info()
    print(card, flush=True)
    print(f"[device] cards: {a.cards} x {card}; host cpus: "
          f"{os.cpu_count()}", flush=True)
    print(f"[native] built {build_native()}", flush=True)
    data = make_data(WORK, a.genome_bp, a.pairs, a.seed)
    print(f"[data] one contig of {a.genome_bp} bp, {a.pairs} 2x150 pairs; "
          f"set-up: generate {data['generate_s']:.1f} s, index "
          f"{data['index_s']:.1f} s", flush=True)
    common = ["-t", "8", "-K", str(a.chunk_bases)]
    reads = [data["ref"], data["r1"], data["r2"]]
    t0 = time.time()
    launch = os.path.join(WORK, "launch")
    rc = subprocess.call([sys.executable, "-m", "mpibwa_tpu.cli", "launch",
                          "-n", str(a.cards), "mem"] + common
                         + ["-o", launch] + reads, cwd=REPO)
    if rc != 0:
        raise RuntimeError(f"launch -n {a.cards} exited with {rc}")
    print(f"[launch] -n {a.cards}: {time.time() - t0:.1f} s on {card}",
          flush=True)
    device = device_record(want=a.cards)
    outs = {}
    for name, devs in (("one", "1"), ("all", "all")):
        os.environ["MPIBWA_DEVICES"] = devs
        r = run_mem(common + ["-o", os.path.join(WORK, name)] + reads)
        print(f"[{name}] MPIBWA_DEVICES={devs}: {r['wall_s']:.1f} s on "
              f"{card}", flush=True)
        outs[name] = sam_body(os.path.join(WORK, name + ".sam"))
    os.environ.pop("MPIBWA_DEVICES")
    outs["launch"] = sam_body(launch + ".sam")
    same_all = outs["all"] == outs["one"]
    same_launch = outs["launch"] == outs["one"]
    n_rec = outs["one"].count(b"\n")
    print(f"[compare] {n_rec} records; "
          f"MPIBWA_DEVICES=all == 1 card: {same_all}; launch -n "
          f"{a.cards} == 1 card: {same_launch}", flush=True)
    if not (same_all and same_launch):
        print("[smoke] FAILED", flush=True)
        sys.exit(1)
    return device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, default=1,
                   help="4: run only the multi-card paths")
    p.add_argument("--genome-bp", type=int, default=S.CHR1_LEN)
    p.add_argument("--pairs", type=int, default=200_000)
    p.add_argument("--se-reads", type=int, default=50_000)
    p.add_argument("--chunk-bases", type=int, default=6_000_000,
                   help="-K for the multi-card runs (several chunks)")
    p.add_argument("--seed", type=int, default=1)
    a = p.parse_args(argv)
    from mpibwa_tpu.devices import enable_compile_cache

    enable_compile_cache()
    device = one_card(a) if a.cards == 1 else four_cards(a)
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
