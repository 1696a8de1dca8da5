"""Device-accelerated alignment pipeline.

Flow per read batch (see DESIGN.md):
  1. device: SMEM seeding (ops.seeding automata)        — hot loop 1
  2. device: batched SA resolution (ops.fmd.sa_lookup)  — hot loop 2
  3. host:   chaining/filtering (exact, branchy, small)
  4. device: batched banded extension (ops.extend_batch) — hot loop 3,
     computed optimistically for every candidate seed; band-doubling retries
     resolved from the first round's max_off exactly like the scalar loop.
  5. host:   exact finalization (dedup/primary/mapQ/SAM or PE pairing),
     consuming cached device extension results; any cache miss falls back to
     the scalar kernel (bit-exactness is never at risk).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from mpibwa_tpu.core import opts as O
from mpibwa_tpu.core import region as R
from mpibwa_tpu.core.chain import mem_chain, mem_chain_flt, mem_flt_chained_seeds
from mpibwa_tpu.core.extend import ksw_extend2
from mpibwa_tpu.core.fm import FMIndex
from mpibwa_tpu.core.pipeline import BSeq, mem_align1_core
from mpibwa_tpu.core.refseq import RefSeq
from mpibwa_tpu.core.region import (MAX_BAND_TRY, cal_max_gap,
                                    mem_mark_primary_se, mem_reorder_primary5,
                                    mem_sort_dedup_patch)
from mpibwa_tpu.core.sam import mem_reg2sam


def _round_up(x: int, buckets) -> int:
    for b in buckets:
        if x <= b:
            return b
    return buckets[-1]


class _ExtCache:
    """Serves precomputed ksw_extend2 results; falls back to scalar."""

    def __init__(self, opt):
        self.opt = opt
        self.cache: Dict[tuple, tuple] = {}
        self.misses = 0
        self.hits = 0

    def key(self, qs, ts, w, eb, zd, h0):
        return (qs.tobytes(), ts.tobytes(), w, eb, zd, h0)

    def __call__(self, qs, ts, w, eb, zd, h0):
        k = self.key(qs, ts, w, eb, zd, h0)
        r = self.cache.get(k)
        if r is not None:
            self.hits += 1
            return r
        self.misses += 1
        opt = self.opt
        return ksw_extend2(qs, ts, opt.mat, opt.o_del, opt.e_del, opt.o_ins,
                           opt.e_ins, w, eb, zd, h0)


class DeviceAligner:
    """mem_process_seqs with the hot loops on device."""

    Q_BUCKETS = (64, 128, 192, 256, 512)
    T_BUCKETS = (128, 256, 384, 512, 768, 1024)
    MAX_SEEDS_PER_CHAIN = 8  # optimistic extension cap; rest -> scalar

    def __init__(self, idx, opt, device=None, dfm=None, fm=None, refs=None):
        """dfm: share an existing DeviceFMIndex (one HBM index replica can
        serve several aligner workers on the same device); fm/refs: share
        the host-side engines the same way (RefSeq holds the unpacked
        reference — one copy per process, not per worker)."""
        from mpibwa_tpu.ops.fmd import DeviceFMIndex
        from mpibwa_tpu.pipeline.device_seed import DeviceSeeder

        self.opt = opt
        self.device = device
        self.fm = fm if fm is not None else FMIndex.from_index(idx)
        self.refs = refs if refs is not None else RefSeq(idx)
        self.dfm = dfm if dfm is not None else DeviceFMIndex(idx, device)
        self.seeder = DeviceSeeder(self.dfm, opt)
        self.stats = {"fallback_reads": 0, "ext_problems": 0, "ext_misses": 0}
        import jax.numpy as jnp

        self.mat55d = jnp.asarray(opt.mat.reshape(5, 5).astype(np.int32))
        self._qd = None  # device read batch of the current align_regs call
        self._finalizer = None
        self._chainer = None
        self._skip_cigar_precompute = False

    def _on_device(self):
        """Context that places this thread's new device arrays on this
        aligner's device (jax default-device contexts are per thread)."""
        import contextlib

        import jax

        if self.device is None:
            return contextlib.nullcontext()
        return jax.default_device(self.device)

    def _native_finalizer(self):
        """Native (C) finalization runtime, or None -> exact Python path."""
        if self._finalizer is None:
            from mpibwa_tpu.pipeline.native_final import NativeFinalizer

            self._finalizer = NativeFinalizer(self.refs, self.opt)
        return self._finalizer if self._finalizer.available else None

    def _native_chainer(self):
        """Native (C) chain stage, or None -> exact Python chaining."""
        fin = self._native_finalizer()
        if fin is None:
            return None
        if self._chainer is None:
            from mpibwa_tpu.pipeline.native_final import NativeChainer

            self._chainer = NativeChainer(fin)
        return self._chainer if self._chainer.available else None

    # -- native-chain driver --------------------------------------------------

    def _pack_mems(self, mems):
        """Flatten per-read interval lists (pre-sort pass order; the C
        session sorts + enumerates SA positions itself)."""
        rows = []
        mem_off = np.zeros(len(mems) + 1, np.int64)
        for b, mem in enumerate(mems):
            if mem:
                rows.extend(mem)
            mem_off[b + 1] = len(rows)
        flat = (np.array(rows, np.int64).reshape(-1, 4)
                if rows else np.zeros((0, 4), np.int64))
        return flat, mem_off

    def _sa_flat(self, ks):
        import jax.numpy as jnp

        if len(ks) == 0:
            return np.zeros(0, np.int64)
        n = len(ks)
        cap = 1 << max(8, (n - 1).bit_length())
        arr = np.zeros(cap, dtype=np.int64)
        arr[:n] = ks
        return np.ascontiguousarray(
            np.asarray(self.dfm.sa_lookup_jit(jnp.asarray(arr)))[:n],
            dtype=np.int64)

    def _sa_prefetch(self, mems_flat):
        """Dispatch the SA walk for the whole batch BEFORE the C chain
        session starts, so the device resolves positions while C chains.

        fin_chain_begin's SA enumeration (native/finalize.c) is the
        deterministic per-interval sampling k = j*step (bwamem.c
        mem_chain semantics), which depends only on the interval rows —
        not on the ksort order — so the superset over the unsorted rows
        equals the set C will ask for. Returns a resolve(ks) closure
        serving from the prefetched table; any position outside it
        (impossible in the current flow, kept for safety) falls back to
        a direct synchronous walk."""
        import jax.numpy as jnp

        if len(mems_flat) == 0:
            return self._sa_flat
        x0 = mems_flat[:, 0]
        x2 = mems_flat[:, 2]
        mo = int(self.opt.max_occ)
        step = np.where(x2 > mo, x2 // mo, 1)
        cnt = np.minimum((x2 + step - 1) // step, mo)
        off = np.zeros(len(cnt) + 1, np.int64)
        np.cumsum(cnt, out=off[1:])
        total = int(off[-1])
        j = np.arange(total, dtype=np.int64) - np.repeat(off[:-1], cnt)
        upos = np.unique(np.repeat(x0, cnt) + np.repeat(step, cnt) * j)
        n = len(upos)
        cap = 1 << max(8, (n - 1).bit_length())
        arr = np.zeros(cap, dtype=np.int64)
        arr[:n] = upos
        vals_dev = self.dfm.sa_lookup_jit(jnp.asarray(arr))  # async
        state = {}
        lock = __import__("threading").Lock()

        def resolve(ks):
            ks = np.asarray(ks, dtype=np.int64)
            if len(ks) == 0:
                return np.zeros(0, np.int64)
            with lock:  # concurrent chain ranges share one table
                if "vals" not in state:
                    state["vals"] = np.ascontiguousarray(
                        np.asarray(vals_dev)[:n], dtype=np.int64)
            idx = np.minimum(np.searchsorted(upos, ks), n - 1)
            out = state["vals"][idx]
            miss = upos[idx] != ks
            if miss.any():
                out[miss] = self._sa_flat(ks[miss])
            return out

        return resolve

    def _ext_rows_run(self, c, p, maxq, maxt):
        """Device extension DP of coordinate rows (see extend_from_coords):
        (n,6),(n,4) -> (n,6) int32 (score, qle, tle, gtle, gscore,
        max_off), padded to a pow2 batch and bucketed shapes."""
        import jax.numpy as jnp

        from mpibwa_tpu.ops.extend_batch import extend_from_coords

        opt = self.opt
        B = len(c)
        Q = _round_up(maxq, self.Q_BUCKETS)
        T = _round_up(maxt, self.T_BUCKETS)
        Bp = 1 << max(4, (B - 1).bit_length())
        cc = np.zeros((Bp, 6), np.int64)  # int64: r_start is a doubled coord
        pp = np.zeros((Bp, 4), np.int32)
        pp[:, 3] = 1  # dummy h0 > 0
        cc[:, 2] = 1  # dummy qlen
        cc[:B] = c
        pp[:B] = p
        out = extend_from_coords(self.dfm, self._qd, jnp.asarray(cc), Q, T,
                                 jnp.asarray(pp), opt.o_del, opt.e_del,
                                 opt.o_ins, opt.e_ins, self.mat55d)
        return np.stack([np.asarray(x) for x in out],
                        axis=1)[:B].astype(np.int32)

    def _ext_rows(self, coords, params):
        """Device extension rounds for the C chain session: returns
        ((B,12) int32 [r0|r1] rows, (B,) uint8 has-bits). Oversize problems
        (beyond the bucket ladder) get no bits — the C side runs the exact
        scalar kernel for them."""
        import os

        B = len(coords)
        out_r = np.zeros((B, 12), np.int32)
        has = np.zeros(B, np.uint8)
        if B == 0:
            return out_r, has
        # Default: with the C record runtime active, the banded extensions
        # run scalar in C (no bits -> C computes every DP) on the host
        # cores while the device seeds. MPIBWA_EXT=device runs them as the
        # batched XLA DP instead (byte-identical, diff-tested). Which one
        # wins on the H100 is not measured yet.
        if os.environ.get("MPIBWA_EXT", "native") != "device":
            return out_r, has
        qcap, tcap = self.Q_BUCKETS[-1], self.T_BUCKETS[-1]
        small = np.nonzero((coords[:, 2] <= qcap)
                           & (coords[:, 5] <= tcap))[0]
        if len(small) == 0:
            return out_r, has
        self.stats["ext_problems"] += int(len(small))
        c = coords[small]
        p = params[small]
        maxq = int(c[:, 2].max())
        maxt = max(int(c[:, 5].max()), 1)
        # both band tries (w and w<<1) ride ONE device call: lane width is
        # nearly free (rounds are latency-bound) and it saves a full
        # device->host round trip vs a conditional retry pass
        p1 = p.copy()
        p1[:, 0] = self.opt.w << 1
        both = self._ext_rows_run(np.concatenate([c, c]),
                                  np.concatenate([p, p1]), maxq, maxt)
        n = len(small)
        out_r[small, :6] = both[:n]
        out_r[small, 6:] = both[n:]
        has[small] = 3
        return out_r, has

    def _seed_stage(self, seqs):
        """Device phase of one microbatch: seeding rows + the async SA
        prefetch dispatch. Runs on a helper thread in align_arrays so the
        NEXT microbatch's device work overlaps the CURRENT microbatch's C
        chain session (which releases the GIL). Returns
        (rows, qd, resolve) or None on backward overflow."""
        import time as _time

        t = self.stats.setdefault("t", {})
        t0 = _time.time()
        with self._on_device():
            got = self.seeder.collect_flat([s.seq for s in seqs])
        qd = self.seeder.last_qd
        if got is None:  # backward overflow: the exact list path handles it
            return None
        with self._on_device():
            resolve = self._sa_prefetch(got[0])
        t["seed"] = t.get("seed", 0) + _time.time() - t0
        return got, qd, resolve

    def _align_arrays_inner(self, seqs, chainer, staged=None):
        """Native-chain variant of _align_regs_inner: returns
        (regs packed array, reg_off) or None -> Python path."""
        import time as _time

        t = self.stats.setdefault("t", {})
        if staged is None:
            staged = self._seed_stage(seqs)
            if staged is None:
                return None
        got, self._qd, resolve = staged
        mems_flat, mem_off, fallback = got
        self.stats["fallback_reads"] += int(fallback.sum())
        t0 = _time.time()
        res = chainer.run(seqs, (mems_flat, mem_off), resolve,
                          self._ext_rows, self.MAX_SEEDS_PER_CHAIN)
        if res is None:
            return None
        regs, reg_off = res
        fb = list(np.nonzero(fallback)[0])
        if fb:
            from mpibwa_tpu.pipeline.native_final import regs_to_array

            lists = {b: mem_align1_core(self.opt, self.fm, self.refs,
                                        seqs[b].seq) for b in fb}
            counts = np.diff(reg_off)
            for b in fb:
                counts[b] = len(lists[b])
            new_off = np.zeros(len(seqs) + 1, np.int64)
            np.cumsum(counts, out=new_off[1:])
            new_regs = np.zeros(int(new_off[-1]), regs.dtype)
            for b in range(len(seqs)):
                if b in lists:
                    arr, _ = regs_to_array([lists[b]])
                    new_regs[new_off[b]:new_off[b + 1]] = arr
                else:
                    new_regs[new_off[b]:new_off[b + 1]] = \
                        regs[reg_off[b]:reg_off[b + 1]]
            regs, reg_off = new_regs, new_off
        t["chain"] = t.get("chain", 0) + _time.time() - t0
        return regs, reg_off

    def align_arrays(self, seqs):
        """Microbatched native-chain alignment: packed regions for the
        whole batch, or None -> caller uses the Python path. Microbatches
        run as a two-stage pipeline: while the C chain session of
        microbatch i holds the cores (GIL released), a helper thread
        drives microbatch i+1's device seeding, so single-chunk calls
        (the reference's default whole-file -K) keep both resources
        busy."""
        import concurrent.futures

        chainer = self._native_chainer()
        if chainer is None or not seqs:
            return None
        MB = self.MICROBATCH
        subs = []
        for off in range(0, len(seqs), MB):
            sub = seqs[off : off + MB]
            if 0 < len(sub) < MB and len(sub) >= 256:
                cap = 256
                while cap < len(sub):
                    cap <<= 1
                pad_n = min(cap, MB) - len(sub)
                dummy = BSeq(name="__pad__", seq=np.zeros(8, np.uint8),
                             qual="IIIIIIII")
                subs.append((sub, list(sub) + [dummy] * pad_n))
            else:
                subs.append((sub, sub))
        parts = []
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            fut = ex.submit(self._seed_stage, subs[0][1])
            for i, (sub, padded) in enumerate(subs):
                staged = fut.result()
                if i + 1 < len(subs):
                    fut = ex.submit(self._seed_stage, subs[i + 1][1])
                if staged is None:
                    return None
                res = self._align_arrays_inner(padded, chainer, staged)
                if res is None:
                    return None
                if len(padded) != len(sub):
                    regs, reg_off = res
                    regs = regs[: reg_off[len(sub)]]
                    reg_off = reg_off[: len(sub) + 1]
                    res = (regs, reg_off)
                parts.append(res)
        if len(parts) == 1:
            return parts[0]
        regs = np.concatenate([p[0] for p in parts])
        offs = [parts[0][1]]
        base = parts[0][1][-1]
        for p in parts[1:]:
            offs.append(p[1][1:] + base)
            base += p[1][-1]
        return regs, np.concatenate(offs)

    # -- phase 2: SA resolution ---------------------------------------------

    def _resolve_sa(self, mems_per_read) -> List[Dict[int, int]]:
        import jax.numpy as jnp

        opt = self.opt
        ks: List[int] = []
        owners: List[int] = []
        for b, mem in enumerate(mems_per_read):
            if mem is None:
                continue
            for iv in mem:
                step = iv[2] // opt.max_occ if iv[2] > opt.max_occ else 1
                k, count = 0, 0
                while k < iv[2] and count < opt.max_occ:
                    ks.append(iv[0] + k)
                    owners.append(b)
                    k += step
                    count += 1
        caches: List[Dict[int, int]] = [dict() for _ in mems_per_read]
        if not ks:
            return caches
        n = len(ks)
        cap = 1 << max(8, (n - 1).bit_length())
        arr = np.zeros(cap, dtype=np.int64)
        arr[:n] = ks
        got = np.asarray(self.dfm.sa_lookup_jit(jnp.asarray(arr)))[:n]
        for b, k, pos in zip(owners, ks, got):
            caches[b][k] = int(pos)
        return caches

    # -- phase 4: optimistic batched extension ------------------------------

    def _ext_coords_run(self, coords, params, maxq, maxt):
        """coords: (B,6) rows; params: (B,4). Returns list of tuples."""
        if not len(coords):
            return []
        res = self._ext_rows_run(np.asarray(coords, np.int64),
                                 np.asarray(params, np.int32), maxq, maxt)
        return [tuple(int(v) for v in r) for r in res]

    def _precompute_extensions(self, chains_per_read, qs_per_read, cache: _ExtCache):
        opt = self.opt
        refs = self.refs
        left_jobs = []  # (key_q, key_t, h0, coords-row)
        chain_ctx = []
        for b, chains in enumerate(chains_per_read):
            if chains is None:
                continue
            query = qs_per_read[b]
            l_query = len(query)
            for c in chains:
                if c.n == 0:
                    continue
                l_pac = refs.l_pac
                rmax0, rmax1 = l_pac << 1, 0
                for t in c.seeds:
                    lo = t.rbeg - (t.qbeg + cal_max_gap(opt, t.qbeg))
                    hi = (t.rbeg + t.len + (l_query - t.qbeg - t.len)
                          + cal_max_gap(opt, l_query - t.qbeg - t.len))
                    rmax0 = min(rmax0, lo)
                    rmax1 = max(rmax1, hi)
                rmax0 = max(rmax0, 0)
                rmax1 = min(rmax1, l_pac << 1)
                if rmax0 < l_pac < rmax1:
                    if c.seeds[0].rbeg < l_pac:
                        rmax1 = l_pac
                    else:
                        rmax0 = l_pac
                rseq, rid, rmax0, rmax1 = refs.fetch_seq(rmax0, c.seeds[0].rbeg,
                                                         rmax1)
                order = sorted(range(c.n),
                               key=lambda i: (c.seeds[i].score, i), reverse=True)
                subset = order[: self.MAX_SEEDS_PER_CHAIN]
                chain_ctx.append((b, query, rseq, rmax0, rmax1, c, subset))
                for si in subset:
                    s = c.seeds[si]
                    if s.qbeg:
                        tmp = s.rbeg - rmax0
                        qkey = np.ascontiguousarray(query[s.qbeg - 1 :: -1]).tobytes()
                        tkey = np.ascontiguousarray(
                            rseq[tmp - 1 :: -1] if tmp > 0 else rseq[:0]).tobytes()
                        left_jobs.append(
                            (qkey, tkey, s.len * opt.a,
                             (b, 0, s.qbeg, 1, s.rbeg, tmp)))

        def run_band_tries(jobs, eb):
            """jobs: (key_q, key_t, h0, coords). Exact MAX_BAND_TRY loop.

            Problems beyond the bucket ladder (qlen > Q cap or tlen > T cap,
            e.g. long reads under -x ont2d) run the exact scalar kernel
            instead of a truncated device DP — never a silently clipped
            shape (the cigar precompute guards the same way)."""
            if not jobs:
                return [], {}
            qcap, tcap = self.Q_BUCKETS[-1], self.T_BUCKETS[-1]
            small = [i for i, j in enumerate(jobs)
                     if j[3][2] <= qcap and j[3][5] <= tcap]
            r0_all = [None] * len(jobs)
            r1map = {}
            if small:
                coords = [jobs[i][3] for i in small]
                maxq = max(c[2] for c in coords)
                maxt = max(max(c[5] for c in coords), 1)
                params = [(opt.w, eb, opt.zdrop, jobs[i][2]) for i in small]
                r0 = self._ext_coords_run(coords, params, maxq, maxt)
                for i, r in zip(small, r0):
                    r0_all[i] = r
                retry_idx = [i for i, r in zip(small, r0)
                             if not (r[5] < (opt.w >> 1) + (opt.w >> 2))]
                if retry_idx:
                    params1 = [(opt.w << 1, eb, opt.zdrop, jobs[i][2])
                               for i in retry_idx]
                    r1 = self._ext_coords_run(
                        [jobs[i][3] for i in retry_idx], params1, maxq, maxt)
                    r1map = dict(zip(retry_idx, r1))
            for i, j in enumerate(jobs):
                if r0_all[i] is not None:
                    continue
                qs = np.frombuffer(j[0], np.uint8)
                ts = np.frombuffer(j[1], np.uint8)
                r0_all[i] = ksw_extend2(qs, ts, opt.mat, opt.o_del,
                                        opt.e_del, opt.o_ins, opt.e_ins,
                                        opt.w, eb, opt.zdrop, j[2])
                if not (r0_all[i][5] < (opt.w >> 1) + (opt.w >> 2)):
                    r1map[i] = ksw_extend2(qs, ts, opt.mat, opt.o_del,
                                           opt.e_del, opt.o_ins, opt.e_ins,
                                           opt.w << 1, eb, opt.zdrop, j[2])
            return r0_all, r1map

        left_r0, left_r1 = run_band_tries(left_jobs, opt.pen_clip5)
        li = 0
        right_jobs = []
        for (b, query, rseq, rmax0, rmax1, c, subset) in chain_ctx:
            l_query = len(query)
            for si in subset:
                s = c.seeds[si]
                sc0 = s.len * opt.a
                if s.qbeg:
                    qk, tk, h0, _ = left_jobs[li]
                    r0 = left_r0[li]
                    cache.cache[(qk, tk, opt.w, opt.pen_clip5, opt.zdrop, h0)] = r0
                    score = r0[0]
                    if li in left_r1:
                        r1 = left_r1[li]
                        cache.cache[(qk, tk, opt.w << 1, opt.pen_clip5,
                                     opt.zdrop, h0)] = r1
                        score = r1[0]
                    sc0 = score
                    li += 1
                if s.qbeg + s.len != l_query:
                    qe = s.qbeg + s.len
                    re = s.rbeg + s.len - rmax0
                    qkey = np.ascontiguousarray(query[qe:]).tobytes()
                    tkey = np.ascontiguousarray(rseq[re:]).tobytes()
                    right_jobs.append(
                        (qkey, tkey, sc0,
                         (b, qe, l_query - qe, 0, s.rbeg + s.len,
                          rmax1 - (s.rbeg + s.len))))
        right_r0, right_r1 = run_band_tries(right_jobs, opt.pen_clip3)
        for i, (qk, tk, h0, _) in enumerate(right_jobs):
            cache.cache[(qk, tk, opt.w, opt.pen_clip3, opt.zdrop, h0)] =                 right_r0[i]
            if i in right_r1:
                cache.cache[(qk, tk, opt.w << 1, opt.pen_clip3, opt.zdrop,
                             h0)] = right_r1[i]
        self.stats["ext_problems"] += len(left_jobs) + len(right_jobs)

    # -- the public entry ----------------------------------------------------

    # output-invariant (see align_regs); untuned on the H100
    MICROBATCH = int(__import__("os").environ.get("MPIBWA_MICROBATCH", "16384"))

    def align_regs(self, seqs: List[BSeq]) -> List[List[R.AlnReg]]:
        """Compute alignment regions for a batch.

        Internally processes fixed-size microbatches (padded with dummy
        reads) so device shapes stay stable across chunks — shape-driven
        recompilation otherwise dominates wall time. Exactness is
        unaffected: per-read region lists don't depend on batch grouping
        (only PE insert stats do, and those are computed by the caller over
        the full chunk)."""
        MB = self.MICROBATCH
        if not hasattr(self, "_pending_cigar_cache"):
            self._pending_cigar_cache = {}
        if len(seqs) > MB:
            out = []
            for off in range(0, len(seqs), MB):
                out.extend(self.align_regs(seqs[off : off + MB]))
            return out
        if 0 < len(seqs) < MB and len(seqs) >= 256:
            import numpy as _np

            # pad the remainder to the next power-of-2 bucket, not all the
            # way to MB (a 1.8K tail padded to 16K wastes most of the batch)
            cap = 256
            while cap < len(seqs):
                cap <<= 1
            pad_n = min(cap, MB) - len(seqs)
            dummy = BSeq(name="__pad__", seq=_np.zeros(8, _np.uint8),
                         qual="IIIIIIII")
            padded = list(seqs) + [dummy] * pad_n
            return self._align_regs_inner(padded)[: len(seqs)]
        return self._align_regs_inner(seqs)

    def _align_regs_inner(self, seqs: List[BSeq]) -> List[List[R.AlnReg]]:
        import time as _time

        t = self.stats.setdefault("t", {})
        opt, fm, refs = self.opt, self.fm, self.refs
        t0 = _time.time()
        mems, fallback = self.seeder.collect_batch([s.seq for s in seqs])
        self._qd = self.seeder.last_qd
        t["seed"] = t.get("seed", 0) + _time.time() - t0
        self.stats["fallback_reads"] += int(fallback.sum())
        t0 = _time.time()
        sa_caches = self._resolve_sa(mems)
        t["sa"] = t.get("sa", 0) + _time.time() - t0
        t0 = _time.time()
        # host chains
        chains_per_read = []
        for b, s in enumerate(seqs):
            if mems[b] is None:
                chains_per_read.append(None)
                continue
            chn = mem_chain(opt, fm, refs, s.seq, s.l_seq, mem=mems[b],
                            sa=lambda k: sa_caches[b][k])
            chn = mem_chain_flt(opt, chn)
            mem_flt_chained_seeds(opt, refs, s.l_seq, s.seq, chn)
            chains_per_read.append(chn)
        t["chain"] = t.get("chain", 0) + _time.time() - t0
        t0 = _time.time()
        cache = _ExtCache(opt)
        self._precompute_extensions(chains_per_read,
                                    [s.seq for s in seqs], cache)
        t["ext"] = t.get("ext", 0) + _time.time() - t0
        t0 = _time.time()
        # finalization per read
        regs_all = []
        for b, s in enumerate(seqs):
            if chains_per_read[b] is None:
                regs = mem_align1_core(opt, fm, refs, s.seq)
            else:
                regs: List[R.AlnReg] = []
                for c in chains_per_read[b]:
                    R.mem_chain2aln(opt, refs, s.l_seq, s.seq, c, regs,
                                    extender=cache)
                regs = mem_sort_dedup_patch(opt, refs, s.seq, regs)
                for p in regs:
                    if p.rid >= 0 and refs.anns[p.rid].is_alt:
                        p.is_alt = 1
            regs_all.append(regs)
        t["final"] = t.get("final", 0) + _time.time() - t0
        self.stats["ext_misses"] += cache.misses
        # cigar precompute must use THIS microbatch's device rows (self._qd);
        # skipped when the native finalization runtime computes CIGARs itself
        if not self._skip_cigar_precompute:
            t0 = _time.time()
            cc = precompute_cigars(self.opt, self.refs, [s.seq for s in seqs],
                                   regs_all, self.dfm, self._qd, self.mat55d)
            self._pending_cigar_cache.update(cc)
            t["cigar"] = t.get("cigar", 0) + _time.time() - t0
        return regs_all

    def _process_seqs_native(self, seqs, n_processed, pes0, rg_id) -> bool:
        """All-native record path: device seeding/SA/extension arrays in,
        SAM text out, with chaining + finalization in C. Returns False ->
        caller runs the Python record path."""
        import time as _time

        opt = self.opt
        chainer = self._native_chainer()
        if chainer is None or not seqs:
            return False
        t = self.stats.setdefault("t", {})
        arrays = self.align_arrays(seqs)
        if arrays is None:
            return False
        regs, reg_off = arrays
        t0 = _time.time()
        if opt.flag & O.MEM_F_PE:
            from mpibwa_tpu.core.pair import pestat_from_isize

            if pes0 is not None:
                pes = pes0
            else:
                iso = chainer.pestat_isizes(regs, reg_off, opt.max_ins)
                if iso is None:
                    return False
                pes = pestat_from_isize(iso)
            ok = chainer.finalize_packed(seqs, regs, reg_off, True,
                                         n_processed >> 1, rg_id, pes)
        else:
            ok = chainer.finalize_packed(seqs, regs, reg_off, False,
                                         n_processed, rg_id)
        t["emit"] = t.get("emit", 0) + _time.time() - t0
        return ok

    def process_seqs(self, seqs: List[BSeq], n_processed: int = 0,
                     pes0=None, rg_id: str = "") -> None:
        with self._on_device():
            self._process_seqs(seqs, n_processed, pes0, rg_id)

    def _process_seqs(self, seqs, n_processed, pes0, rg_id) -> None:
        from mpibwa_tpu.core.cigar import set_cigar_cache

        opt, refs = self.opt, self.refs
        import time as _time

        if self._process_seqs_native(seqs, n_processed, pes0, rg_id):
            return
        fin = self._native_finalizer()
        self._pending_cigar_cache = {}
        self._skip_cigar_precompute = fin is not None
        try:
            regs_all = self.align_regs(seqs)
        finally:
            self._skip_cigar_precompute = False
        t = self.stats.setdefault("t", {})
        set_cigar_cache(self._pending_cigar_cache)
        t0 = _time.time()
        n = len(seqs)
        if opt.flag & O.MEM_F_PE:
            from mpibwa_tpu.core.pair import (mem_pestat, mem_sam_pe,
                                              set_sw_cache)

            pes = pes0 if pes0 is not None else mem_pestat(opt, refs.l_pac,
                                                           regs_all)
            if not (fin is not None
                    and fin.finalize(seqs, regs_all, True, n_processed >> 1,
                                     rg_id, pes)):
                t0 = _time.time()
                sw_cache = precompute_rescue(opt, refs, self.dfm, seqs,
                                             regs_all, pes)
                t["rescue"] = t.get("rescue", 0) + _time.time() - t0
                set_sw_cache(sw_cache)
                for i in range(n >> 1):
                    mem_sam_pe(opt, refs, pes, (n_processed >> 1) + i,
                               seqs[i << 1 : (i << 1) + 2],
                               regs_all[i << 1 : (i << 1) + 2], rg_id)
                set_sw_cache(None)
        else:
            if not (fin is not None
                    and fin.finalize(seqs, regs_all, False, n_processed,
                                     rg_id)):
                for i, s in enumerate(seqs):
                    regs = regs_all[i]
                    mem_mark_primary_se(opt, regs, n_processed + i)
                    if opt.flag & O.MEM_F_PRIMARY5:
                        mem_reorder_primary5(opt.T, regs)
                    s.sam = mem_reg2sam(opt, refs, s, regs, 0, None, rg_id)
        set_cigar_cache(None)
        t["emit"] = t.get("emit", 0) + _time.time() - t0


def prep_global_problem(opt, refs, query_full, ar):
    """Replicate mem_reg2aln's first gen_cigar call inputs (bwa.c:120-170):
    returns (qseq, rseq, w, rev) post-reversal, or None when the scalar
    path's shortcut/reject branches apply."""
    from mpibwa_tpu.core.sam import infer_bw

    qb, qe, rb, re = ar.qb, ar.qe, ar.rb, ar.re
    if ar.rb < 0 or ar.re < 0:
        return None
    tmp = infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_del, opt.e_del)
    w2 = max(infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_ins,
                      opt.e_ins), tmp)
    if w2 > opt.w:
        w2 = min(w2, ar.w)
    w2 = min(w2, opt.w << 2)
    l_query = qe - qb
    l_pac = refs.l_pac
    if l_query <= 0 or rb >= re or (rb < l_pac and re > l_pac):
        return None
    rseq = refs.get_seq(rb, re)
    rlen = len(rseq)
    if re - rb != rlen:
        return None
    query = np.ascontiguousarray(query_full[qb:qe])
    if rb >= l_pac:
        query = query[::-1].copy()
        rseq = rseq[::-1].copy()
    if l_query == rlen and w2 == 0:
        return None  # no-DP shortcut; scalar path is trivial
    max_ins = int((((l_query + 1) >> 1) * int(opt.mat[0]) - opt.o_ins)
                  / opt.e_ins + 1.0)
    max_del = int((((l_query + 1) >> 1) * int(opt.mat[0]) - opt.o_del)
                  / opt.e_del + 1.0)
    max_gap = max(max_ins, max_del, 1)
    w = (max_gap + abs(rlen - l_query) + 1) >> 1
    w = min(w, w2)
    w = max(w, abs(rlen - l_query) + 3)
    return query, rseq, w, rb >= l_pac


_PACK3 = []


def _pack3(a, b, c):
    import jax
    import jax.numpy as jnp

    if not _PACK3:
        @jax.jit
        def pack(a, b, c):
            return jnp.stack([a.astype(jnp.int64), b.astype(jnp.int64),
                              c.astype(jnp.int64)], axis=0)

        _PACK3.append(pack)
    return _PACK3[0](a, b, c)


def precompute_cigars(opt, refs, qs_per_read, regs_per_read, dfm=None,
                      qd=None, mat55d=None,
                      q_buckets=(64, 128, 192, 256, 512),
                      t_buckets=(64, 128, 192, 256, 512, 768)):
    """Batch the first-round global alignments for every region on device;
    returns the cigar cache dict consumed by core.cigar.gen_cigar."""
    import jax.numpy as jnp

    from mpibwa_tpu.ops.extend_batch import standard_mat_ab
    from mpibwa_tpu.ops.global_batch import (cigar_from_ops,
                                              global_from_coords,
                                              traceback_batch)

    probs = []
    for b, (query_full, regs) in enumerate(zip(qs_per_read, regs_per_read)):
        for ar in regs:
            prep = prep_global_problem(opt, refs, query_full, ar)
            if prep is not None:
                q, t, w, rev = prep
                coords = ((b, ar.qb, ar.qe - ar.qb, 1, ar.re, ar.re - ar.rb)
                          if rev else
                          (b, ar.qb, ar.qe - ar.qb, 0, ar.rb, ar.re - ar.rb))
                probs.append((q, t, w, coords))
    cache = {}
    if not probs:
        return cache
    # dedupe identical problems
    uniq = {}
    for q, t, w, coords in probs:
        uniq.setdefault((q.tobytes(), t.tobytes(), w), (q, t, w, coords))
    probs = list(uniq.values())
    groups = {}
    for q, t, w, coords in probs:
        Q = _round_up(len(q), q_buckets)
        T = _round_up(len(t), t_buckets)
        groups.setdefault((Q, T), []).append((q, t, w, coords))
    for (Q, T), items in groups.items():
        B = len(items)
        Bp = 1 << max(4, (B - 1).bit_length())
        cds = np.zeros((Bp, 6), np.int64)  # int64 r_start (doubled coords)
        cds[:, 2] = 1  # dummy qlen
        ws = np.full(Bp, 3, np.int32)
        skip = set()
        for i, (q, t, w, coords) in enumerate(items):
            if len(q) > Q or len(t) > T:
                skip.add(i)
                continue
            cds[i] = coords
            ws[i] = w
        qlens = cds[:, 2].copy()
        tlens = cds[:, 5].copy()
        out = global_from_coords(dfm, qd, jnp.asarray(cds), Q, T,
                                 jnp.asarray(ws), opt.o_del, opt.e_del,
                                 opt.o_ins, opt.e_ins,
                                 standard_mat_ab(opt.mat), mat55d)
        # traceback on device: pull (B, T+Q) op rows, not (B, T, Q)
        # matrices; the three small outputs ride ONE pull
        ops_d, irem_d, krem_d = traceback_batch(out.z, jnp.asarray(qlens),
                                                jnp.asarray(tlens),
                                                jnp.asarray(ws))
        small = np.asarray(_pack3(out.score, irem_d, krem_d))
        scores, irem_np, krem_np = small[0], small[1], small[2]
        ops_np = np.asarray(ops_d)
        for i, (q, t, w, coords) in enumerate(items):
            if i in skip:
                continue
            cig = cigar_from_ops(ops_np[i], int(irem_np[i]), int(krem_np[i]))
            cache[(q.tobytes(), t.tobytes(), w)] = (int(scores[i]), cig)
    return cache


def precompute_rescue(opt, refs, dfm, seqs, regs_all, pes):
    """Batch all candidate mate-rescue SW problems on device.

    Enumerates exactly the ksw_align2 calls mem_sam_pe can make
    (bwamem_pair.c:265-275 candidate lists x the four orientations whose
    insert stats didn't fail); results are served through core.pair's cache,
    with misses (i16 mode, clamped-window edge cases) falling back to the
    scalar kernel. Returns the cache dict."""
    import jax.numpy as jnp

    from mpibwa_tpu.core.extend import KSW_XBYTE, KSW_XSTART, KSW_XSUBO
    from mpibwa_tpu.ops.rescue import ksw_align2_batch
    from mpibwa_tpu.pipeline.device_seed import _pad_batch

    cache = {}
    q_all, _lens = _pad_batch([s.seq for s in seqs])
    qd = jnp.asarray(q_all)
    l_pac = refs.l_pac
    jobs = []  # (key, qcoords, tcoords)
    maxq = 1
    maxt = 1
    for pi in range(len(seqs) >> 1):
        for end in (0, 1):
            a_list = regs_all[(pi << 1) | end]
            if not a_list:
                continue
            mate_row = (pi << 1) | (1 - end)
            ms = seqs[mate_row].seq
            l_ms = len(ms)
            if l_ms * opt.a >= 250:
                continue  # i16 mode: scalar fallback
            xtra = (KSW_XSUBO | KSW_XSTART | KSW_XBYTE
                    | (opt.min_seed_len * opt.a))
            thr = a_list[0].score - opt.pen_unpaired
            nb = 0
            for reg in a_list:
                if reg.score < thr:
                    continue
                if nb >= opt.max_matesw:
                    break
                nb += 1
                for r in range(4):
                    if pes[r].failed:
                        continue
                    is_rev = (r >> 1) != (r & 1)
                    is_larger = not (r >> 1)
                    if not is_rev:
                        rb = reg.rb + pes[r].low if is_larger else reg.rb - pes[r].high
                        re = (reg.rb + pes[r].high if is_larger
                              else reg.rb - pes[r].low) + l_ms
                    else:
                        rb = (reg.rb + pes[r].low if is_larger
                              else reg.rb - pes[r].high) - l_ms
                        re = reg.rb + pes[r].high if is_larger else reg.rb - pes[r].low
                    rb = max(rb, 0)
                    re = min(re, l_pac << 1)
                    if rb >= re:
                        continue
                    ref, rid, rb2, re2 = refs.fetch_seq(rb, (rb + re) >> 1, re)
                    if not (reg.rid == rid and re2 - rb2 >= opt.min_seed_len):
                        continue
                    if is_rev:
                        seq = np.where(ms < 4, 3 - ms, 4)[::-1].astype(np.uint8)
                        qc = (mate_row, l_ms - 1, -1, 1, l_ms)
                    else:
                        seq = ms
                        qc = (mate_row, 0, 1, 0, l_ms)
                    key = (seq.tobytes(), ref.tobytes(), xtra)
                    if key in cache:
                        continue
                    cache[key] = None
                    jobs.append((key, qc, (rb2, 1, re2 - rb2)))
                    maxq = max(maxq, l_ms)
                    maxt = max(maxt, re2 - rb2)
    jobs = [(k, qc, tc) for (k, qc, tc) in jobs]
    if not jobs:
        return {}
    N = ((maxq + 15) >> 4) << 4
    Tcap = 256
    while Tcap < maxt:
        Tcap <<= 1
    plist = [{"qcoords": j[1], "tcoords": j[2]} for j in jobs]
    res = ksw_align2_batch(dfm, qd, plist, opt, N, Tcap)
    out = {}
    for (key, _, _), r in zip(jobs, res):
        out[key] = r
    return out
