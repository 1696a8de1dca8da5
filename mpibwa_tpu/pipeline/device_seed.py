"""Device-batched seed collection: exact mem_collect_intv on the device.

Drives the ops.seeding automata over a read batch and assembles, per read,
the same interval list (same order, pre-sort) that core.chain.collect_intv
produces, then applies the exact introsort. Reads that overflow any device
buffer fall back to the scalar host engine.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from mpibwa_tpu.core.sortutil import ks_introsort
from mpibwa_tpu.devices import backward_engine
from mpibwa_tpu.ops import seeding
from mpibwa_tpu.ops.pulls import pull_prefix
from mpibwa_tpu.ops.fmd import DeviceFMIndex


def _pad_batch(qs: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    B = len(qs)
    L = max((len(q) for q in qs), default=1)
    L = max(L, 8)
    if L >= (1 << 21):  # 21-bit call fields in the fused p1/p3 pull
        raise ValueError("reads >= 2 Mbp unsupported by the device seeder")
    out = np.full((B, L), 4, dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i, q in enumerate(qs):
        out[i, : len(q)] = q
        lens[i] = len(q)
    return out, lens


def _pack_fwd_jit():
    """Module-level memoized jit: a FRESH jax.jit per call would re-trace,
    re-lower and re-hit the compile cache on every microbatch, so all
    device_seed jits are created once and reused."""
    import jax
    import jax.numpy as jnp

    if "pack_fwd" not in _JITS:
        @jax.jit
        def pack(ov, nc, cx, cs, cl):
            return jnp.concatenate(
                [ov.astype(jnp.int32)[:, None], nc.astype(jnp.int32)[:, None],
                 cx.astype(jnp.int32), cs.astype(jnp.int32),
                 cl.astype(jnp.int32)], axis=1)

        _JITS["pack_fwd"] = pack
    return _JITS["pack_fwd"]


_JITS: dict = {}


def _pack_fwd(fwd):
    """Pack a forward pass's five host-bound outputs into one int32 array
    (B, 2 + 3*C): [overflow, n_calls, call_x, call_start, call_len]."""
    return _pack_fwd_jit()(fwd.overflow, fwd.n_calls, fwd.call_x,
                           fwd.call_start, fwd.call_len)


def _fused_p1_p3(fm, qd, lensd, min_seed_len, max_intv):
    """Pass-1 forward + pass-3 automata in ONE jitted call, with the
    host-bound outputs COMPACTED device-side so the pull bytes track the
    content instead of the dense (B, 244) int64 layout (1952 B/read).

    Returns (ivals, infos, ctl_d, bufs_d): ctl = counts (B, 4 flattened:
    [fwd_overflow, n_calls, p3_overflow, n_seeds]) ++ the compacted call
    words (b-major — lane order == the b_of/c_of enumeration downstream;
    int32 x<<16|start<<8|len for L < 64 Ki, else int64
    x<<42|start<<21|len); bufs = the compacted pass-3 seed quads
    [s0, s1, s2, info] int64. The caller pulls ONE speculative
    pow2-bucketed prefix of ctl (counts + estimated e1 = sum(min(n_calls,
    C_CAP)) call words) and an async prefix of bufs; capacities are the
    dense worst case, so no overflow path is needed. The 21-bit call
    fields of the wide form bound read length at 2 Mbp (checked in
    _pad_batch)."""
    return _fused_p1_p3_jit()(fm, qd, lensd, min_seed_len, max_intv)


def _fused_p1_p3_jit():
    import functools

    import jax
    import jax.numpy as jnp

    if "p1p3" in _JITS:
        return _JITS["p1p3"]

    @functools.partial(jax.jit, static_argnums=(3, 4))
    def run(fm, qd, lensd, msl, mmi):
        B = qd.shape[0]
        # merged automata: rounds = max(pass1, pass3) instead of the sum,
        # with the query/set_intv/extend1_fwd work shared (seeding.forward_p3)
        fwd, p3 = seeding.forward_p3(fm, qd, lensd,
                                     jnp.ones(B, jnp.int64), msl, mmi)
        counts = jnp.stack(
            [fwd.overflow.astype(jnp.int32), fwd.n_calls.astype(jnp.int32),
             p3.overflow.astype(jnp.int32), p3.n_seeds.astype(jnp.int32)],
            axis=1)
        C = fwd.call_x.shape[1]
        S = p3.infos.shape[1]
        L = qd.shape[1]

        # call word: int32 (x<<16 | start<<8 | len) when the read length
        # fits 16 bits (always, for short reads) — half the transfer bytes
        # of the int64 (x<<42 | start<<21 | len) form. start/len <= F_CAP=192
        # fit 8 bits on every non-overflow lane; overflow lanes are
        # clamped (their reads fall back to the scalar engine, values
        # unused downstream).
        narrow = L < (1 << 16)
        assert seeding.F_CAP <= 255, "call start/len need 8-bit fields"
        if narrow:
            cw = ((fwd.call_x << 16)
                  | (jnp.minimum(fwd.call_start, 255) << 8)
                  | jnp.minimum(fwd.call_len, 255)).ravel()
            cdt = jnp.int32
        else:
            cw = ((fwd.call_x.astype(jnp.int64) << 42)
                  | (fwd.call_start.astype(jnp.int64) << 21)
                  | fwd.call_len.astype(jnp.int64)).ravel()
            cdt = jnp.int64
        maskc = (jnp.arange(C, dtype=jnp.int32)[None, :]
                 < jnp.minimum(fwd.n_calls, C).astype(jnp.int32)[:, None]
                 ).ravel()
        posc = jnp.cumsum(maskc.astype(jnp.int32)) - 1

        quads = jnp.concatenate(
            [p3.seeds.astype(jnp.int64),
             p3.infos.astype(jnp.int64)[:, :, None]],
            axis=2).reshape(B * S, 4)
        masks = (jnp.arange(S, dtype=jnp.int32)[None, :]
                 < jnp.minimum(p3.n_seeds, S).astype(jnp.int32)[:, None]
                 ).ravel()
        poss = jnp.cumsum(masks.astype(jnp.int32)) - 1

        # control buffer = counts ++ compacted call words: the host reads
        # BOTH before it can assemble the backward, so they ride ONE
        # speculative prefix pull (one round trip, not two). The
        # seed quads still ride their own async pull — consumed only
        # after the backward, the copy overlaps its round compute.
        TOTC = B * C
        bufc = jnp.zeros(TOTC + 1, cdt).at[
            jnp.where(maskc, posc, TOTC)].set(cw, mode="drop")[:TOTC]
        ctl = jnp.concatenate([counts.ravel().astype(cdt), bufc])
        TOTS = 4 * B * S
        bufs = jnp.zeros(TOTS + 1, jnp.int64)
        base = 4 * poss
        for j in range(4):
            bufs = bufs.at[jnp.where(masks, base + j, TOTS)].set(
                quads[:, j], mode="drop")
        return fwd.ivals, fwd.infos, ctl, bufs[:TOTS]

    _JITS["p1p3"] = run
    return run


def _pull_p1p3(ctl_d, bufs_d, B, est_state=None):
    """Pull the fused pass-1/pass-3 results: ONE speculative prefix pull
    of the control buffer (counts ++ compacted call words — both needed
    before the backward can be assembled, so two separate pulls paid two
    round trips) and an ASYNC pull of the seed quads (consumed only
    after the backward — the copy overlaps its round compute). The
    speculative length adapts to the observed calls/read (est_state); an
    underestimate pays one extra pull for the full prefix. Returns
    (counts, fallback, ncl, calls_np (e1, 3) int64 [x, start, len],
    n3 (B,) clamped, seeds_thunk -> (e3, 4) int64)."""
    import os

    from mpibwa_tpu.ops.pulls import pull_prefix_async

    hdr = 4 * B
    est = (est_state or {}).get("e1", 12 * B)
    got = pull_prefix(ctl_d, hdr + est, min_cap=1024)
    counts = np.asarray(got[:hdr]).reshape(B, 4).astype(np.int32)
    fallback = counts[:, 0] != 0
    ncl = np.minimum(counts[:, 1].astype(np.int64), seeding.C_CAP)
    n3 = np.minimum(counts[:, 3].astype(np.int64), seeding.S3_CAP)
    e1, e3 = int(ncl.sum()), int(n3.sum())
    if est_state is not None:
        # bucket-aligned estimate: pull_prefix rounds the slice length up
        # to a power of two, so size the speculative length to EXACTLY the
        # bucket covering hdr + e1 — the pow2 headroom doubles as margin
        # (an overshooting margin would spill into the next bucket and
        # double the pulled bytes instead)
        est_state["e1"] = max(1024, (1 << (hdr + e1 - 1).bit_length()) - hdr)
    if os.environ.get("MPIBWA_ASYNC_PULL", "1") == "1":
        seeds_raw = pull_prefix_async(bufs_d, 4 * e3, min_cap=1024)
    else:
        got_s = pull_prefix(bufs_d, 4 * e3, min_cap=1024)
        seeds_raw = lambda: got_s
    if e1 > est:  # speculative prefix too short: one full re-pull
        got = pull_prefix(ctl_d, hdr + e1, min_cap=1024)
    w = got[hdr : hdr + e1]
    if w.dtype == np.int32:  # narrow packing (x<<16 | start<<8 | len)
        wu = w.view(np.uint32).astype(np.int64)
        calls_np = np.stack(
            [wu >> 16, (wu >> 8) & 0xFF, wu & 0xFF], axis=1)
    else:
        M21 = (1 << 21) - 1
        calls_np = np.stack([w >> 42, (w >> 21) & M21, w & M21], axis=1)
    seeds_thunk = lambda: seeds_raw().reshape(e3, 4)
    return counts, fallback, ncl, calls_np, n3, seeds_thunk


def _pack_fwd1(fwd):
    """Single-call variant: (B, 5) int32 = [overflow, n_calls, call_x[0],
    call_start[0], call_len[0]]."""
    import jax
    import jax.numpy as jnp

    if "pack_fwd1" not in _JITS:
        @jax.jit
        def pack(ov, nc, cx, cs, cl):
            return jnp.stack(
                [ov.astype(jnp.int32), nc.astype(jnp.int32),
                 cx[:, 0].astype(jnp.int32), cs[:, 0].astype(jnp.int32),
                 cl[:, 0].astype(jnp.int32)], axis=1)

        _JITS["pack_fwd1"] = pack
    return _JITS["pack_fwd1"](fwd.overflow, fwd.n_calls, fwd.call_x,
                              fwd.call_start, fwd.call_len)


def _p2_tables(fwd2, cap):
    """Device-side pass-2 backward lane tables (sync-free pass 2): from
    the single-call forward outputs build lane_tbl rows [push_start, len,
    entry_start(excl cumsum)], per-lane x0, a control vector
    [e2_total] ++ per-lane overflow flags (pulled ASYNC — consumed only
    after the backward result), and a device flag for "the speculative
    entry capacity cap was too small" (rides run_backward8's overflow
    path -> the caller redoes pass 2 with the synchronous route)."""
    import jax
    import jax.numpy as jnp

    if "p2tab" not in _JITS:
        @jax.jit
        def p2tab(nc, cx, cs, cl, ovf, cap_):
            live = nc > 0
            ln = jnp.where(live, cl[:, 0], 0).astype(jnp.int32)
            starts = jnp.cumsum(ln) - ln  # exclusive
            ltbl = jnp.stack(
                [cs[:, 0].astype(jnp.int32), ln, starts], axis=1)
            e2 = jnp.sum(ln)
            ctl = jnp.concatenate(
                [e2[None], ovf.astype(jnp.int32)])
            return ltbl, cx[:, 0].astype(jnp.int32), ctl, e2 > cap_

        _JITS["p2tab"] = p2tab
    import numpy as _np

    return _JITS["p2tab"](fwd2.n_calls, fwd2.call_x, fwd2.call_start,
                          fwd2.call_len, fwd2.overflow, _np.int32(cap))


class DeviceSeeder:
    """collect_intv over batches using the device automata."""

    def __init__(self, dfm: DeviceFMIndex, opt):
        self.dfm = dfm
        self.opt = opt

    def _run_backward_for_calls(self, qd, call_list, ivals_dev, infos_dev,
                                fallback, fb_map=None):
        """call_list: (row, push_start, push_len, x, min_intv) per lane; row
        indexes rows of qd/ivals_dev. All heavy arrays stay on device; only
        lane tables cross the host link. Returns per-lane mem lists."""
        import jax.numpy as jnp

        from mpibwa_tpu.ops import seeding_flat as SF

        N = len(call_list)
        if N == 0:
            return []

        def mark(row):
            fallback[fb_map[row] if fb_map is not None else row] = True

        mode = backward_engine()

        def build_tables(sub, NLp, pad2):
            # one-shot numpy conversion (the per-lane loop was ~0.3s/batch)
            arr = np.asarray(sub, dtype=np.int64)  # (n, 5)
            n = arr.shape[0]
            lrow = np.zeros(NLp, np.int32)
            ltbl = np.zeros((NLp, 3), np.int32)
            x0 = np.zeros(NLp, np.int32)
            minv = np.ones(NLp, np.int64)
            lrow[:n] = arr[:, 0]
            ltbl[:n, 0] = arr[:, 1]
            ltbl[:n, 1] = arr[:, 2]
            starts = np.zeros(n, np.int64)
            np.cumsum(arr[:-1, 2], out=starts[1:]) if n > 1 else None
            ltbl[:n, 2] = starts
            x0[:n] = arr[:, 3]
            minv[:n] = arr[:, 4]
            e = int(arr[:, 2].sum())
            ltbl[n:, 2] = e  # pad lanes: zero-length at the end
            E = pad2(e)
            return lrow, ltbl, x0, minv, E

        if mode == "v8":
            from mpibwa_tpu.ops import backward8 as B8

            def pad2(n):
                # {2^k, 1.5*2^k} ladder: tighter than pow2 (the first
                # segments at full width dominate the backward's cost)
                return B8.cap_bucket(n, 1024)

            NLp = max(16, 1 << (N - 1).bit_length())
            lane_row, lane_tbl, x0, minv, E = build_tables(call_list, NLp,
                                                           pad2)
            ik, info, lane, live = SF.assemble_entries(
                ivals_dev, infos_dev, jnp.asarray(lane_row),
                jnp.asarray(lane_tbl), E)
            qrows_dev = qd[jnp.asarray(lane_row)]
            mems, overflow = B8.run_backward8(
                self.dfm, qrows_dev, (ik, info, lane, live), NLp, x0, minv,
                min_len=self.opt.min_seed_len)
            if overflow.any():
                # static shrink didn't fit (rare): redo exactly
                mems, overflow = SF.run_backward_flat(
                    self.dfm, qrows_dev, (ik, info, lane, live), NLp, x0,
                    minv)
                for ln in np.nonzero(overflow[:N])[0]:
                    mark(call_list[ln][0])
            return mems[:N]

        def pad4(n):
            c = 256
            while c < n:
                c <<= 2
            return c

        NLp = pad4(N)
        lane_row, lane_tbl, x0, minv, E = build_tables(call_list, NLp, pad4)
        if mode == "contig":
            def pad2(n):
                c = 1024
                while c < n:
                    c <<= 1
                return c

            E = pad2(E)
            cols = SF.assemble_cols(ivals_dev, infos_dev,
                                    jnp.asarray(lane_row),
                                    jnp.asarray(lane_tbl), E)
            mems, overflow = SF.run_backward_contig(
                self.dfm, qd[jnp.asarray(lane_row)], cols, NLp, x0, minv)
            for ln in np.nonzero(overflow[:N])[0]:
                mark(call_list[ln][0])
            return mems[:N]
        ik, info, lane, live = SF.assemble_entries(
            ivals_dev, infos_dev, jnp.asarray(lane_row),
            jnp.asarray(lane_tbl), E)
        qrows_dev = qd[jnp.asarray(lane_row)]
        mems, overflow = SF.run_backward_flat(self.dfm, qrows_dev,
                                              (ik, info, lane, live),
                                              NLp, x0, minv)
        for ln in np.nonzero(overflow[:N])[0]:
            mark(call_list[ln][0])
        return mems[:N]

    def collect_batch(self, qs: List[np.ndarray], sort: bool = True
                      ) -> Tuple[List[Optional[List[tuple]]], np.ndarray]:
        """Returns (per-read interval lists, fallback_mask). Lists are None
        for reads needing host fallback. sort=False returns the pre-sort
        pass order (the native chain session applies the exact ksort
        itself; sorting here too would re-permute ties)."""
        import time as _time

        import jax.numpy as jnp

        tt = self.__dict__.setdefault("times", {})

        def _mark(name, t0):
            tt[name] = tt.get(name, 0.0) + _time.time() - t0
            return _time.time()

        t0 = _time.time()
        opt = self.opt
        B = len(qs)
        q, lens = _pad_batch(qs)
        qd = jnp.asarray(q)
        self.last_qd = qd  # reused by the extension/cigar coord kernels
        lensd = jnp.asarray(lens)

        # ---- pass 1 forward (+ pass 3, fused: one dispatch, sparse pull) ----
        p3_sparse = None
        if opt.max_mem_intv > 0:
            ivals1, infos1, ctl_d, bufs_d = _fused_p1_p3(
                self.dfm, qd, lensd, opt.min_seed_len, opt.max_mem_intv)
            est = self.__dict__.setdefault("_e1_est", {})
            counts, fallback, ncl, calls_np, n3_all, seeds_thunk = \
                _pull_p1p3(ctl_d, bufs_d, B, est)
            p3_sparse = (counts[:, 2], n3_all, seeds_thunk)
        else:
            min1 = jnp.ones(B, dtype=jnp.int64)
            fwd = seeding.forward_pass(self.dfm, qd, lensd, min1, True)
            packed = np.asarray(_pack_fwd(fwd))
            ivals1, infos1 = fwd.ivals, fwd.infos
            C = (packed.shape[1] - 2) // 3
            fallback = packed[:, 0] != 0
            n_calls = packed[:, 1].astype(np.int64)
            ncl = np.minimum(n_calls, C)
            b_ = np.repeat(np.arange(B, dtype=np.int64), ncl)
            base = np.zeros(B, np.int64)
            np.cumsum(ncl[:-1], out=base[1:])
            c_ = np.arange(len(b_), dtype=np.int64) - base[b_]
            calls_np = np.stack(
                [packed[b_, 2 + c_], packed[b_, 2 + C + c_],
                 packed[b_, 2 + 2 * C + c_]], axis=1).astype(np.int32)
        t0 = _mark("fwd1", t0)

        # vectorized lane table: (n_lanes, 5) rows
        # [read, call_start, call_len, call_x, min_intv]
        # calls_np is b-major compacted, so rows align with b_of order.
        b_of = np.repeat(np.arange(B, dtype=np.int64), ncl)
        lanes1 = np.stack(
            [b_of, calls_np[:, 1].astype(np.int64),
             calls_np[:, 2].astype(np.int64),
             calls_np[:, 0].astype(np.int64),
             np.ones(len(b_of), np.int64)], axis=1)
        t0 = _mark("tables1", t0)
        mems_l1 = self._run_backward_for_calls(qd, lanes1, ivals1,
                                               infos1, fallback)
        t0 = _mark("bwd1", t0)
        pass1 = [[] for _ in range(B)]
        for ln, lane in enumerate(lanes1):
            b = lane[0]
            # emission order is start-descending; reverse per call
            for iv in reversed(mems_l1[ln]):
                slen = (iv[3] & 0xFFFFFFFF) - (iv[3] >> 32)
                if slen >= opt.min_seed_len:
                    pass1[b].append(iv)

        # ---- pass 2: re-seed long low-occ SMEMs from their midpoint ----
        split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
        lanes2 = []  # (read, start_x, min_intv)
        for b in range(B):
            for iv in pass1[b]:
                start, end = iv[3] >> 32, iv[3] & 0xFFFFFFFF
                if end - start < split_len or iv[2] > opt.split_width:
                    continue
                lanes2.append((b, (start + end) >> 1, iv[2] + 1))
        pass2 = [[] for _ in range(B)]
        if lanes2:
            B2 = 1 << max(4, (len(lanes2) - 1).bit_length())
            q2 = np.full((B2, q.shape[1]), 4, dtype=np.uint8)
            starts2 = np.zeros(B2, dtype=np.int32)
            min2 = np.ones(B2, dtype=np.int64)
            lens2 = np.zeros(B2, dtype=np.int32)
            for ln, (b, x, mi) in enumerate(lanes2):
                q2[ln] = q[b]
                lens2[ln] = lens[b]
                starts2[ln] = x
                min2[ln] = mi
            q2d = jnp.asarray(q2)
            t2 = _time.time()
            fwd2 = seeding.forward_pass(self.dfm, q2d,
                                        jnp.asarray(lens2), jnp.asarray(min2),
                                        False, jnp.asarray(starts2))
            p2 = np.asarray(_pack_fwd1(fwd2))  # one pull (call 0 only)
            tt["p2_fwd"] = tt.get("p2_fwd", 0.0) + _time.time() - t2
            t2 = _time.time()
            for ln in np.nonzero(p2[:, 0])[0]:
                if ln < len(lanes2):
                    fallback[lanes2[ln][0]] = True
            f2_ncalls = p2[:, 1]
            f2_x = p2[:, 2]
            f2_start = p2[:, 3]
            f2_len = p2[:, 4]
            lanes2b = []
            lane2_src = []
            for ln in range(len(lanes2)):
                b = lanes2[ln][0]
                if f2_ncalls[ln] == 0:
                    continue  # ambiguous start: no mems
                lanes2b.append((ln, f2_start[ln], f2_len[ln],
                                f2_x[ln], lanes2[ln][2]))
                lane2_src.append(b)
            fb_map = {ln: lanes2[ln][0] for ln in range(len(lanes2))}
            tt["p2_tbl"] = tt.get("p2_tbl", 0.0) + _time.time() - t2
            t2 = _time.time()
            mems_l2 = self._run_backward_for_calls(q2d, lanes2b, fwd2.ivals,
                                                   fwd2.infos, fallback, fb_map)
            tt["p2_bwd"] = tt.get("p2_bwd", 0.0) + _time.time() - t2
            for k, b in enumerate(lane2_src):
                for iv in reversed(mems_l2[k]):
                    slen = (iv[3] & 0xFFFFFFFF) - (iv[3] >> 32)
                    if slen >= opt.min_seed_len:
                        pass2[b].append(iv)

        t0 = _mark("pass2", t0)
        # ---- pass 3 (already computed in the fused pass-1 dispatch) ----
        pass3_out = [[] for _ in range(B)]
        if p3_sparse is not None:
            ov3, n3, seeds_np = p3_sparse
            seeds_np = seeds_np()  # async pull (see _pull_p1p3)
            for b in np.nonzero(ov3)[0]:
                fallback[b] = True
            e3 = len(seeds_np)
            read3 = np.repeat(np.arange(B, dtype=np.int64), n3)
            for j in range(e3):
                b = read3[j]
                if fallback[b]:
                    continue  # overflowed rows (n3 > capacity) go scalar
                pass3_out[b].append((int(seeds_np[j, 0]),
                                     int(seeds_np[j, 1]),
                                     int(seeds_np[j, 2]),
                                     int(seeds_np[j, 3])))

        t0 = _mark("pass3", t0)
        out: List[Optional[List[tuple]]] = []
        for b in range(B):
            if fallback[b]:
                out.append(None)
                continue
            mem = pass1[b] + pass2[b] + pass3_out[b]
            if sort:
                ks_introsort(mem, lambda a, c: a[3] < c[3])
            out.append(mem)
        _mark("sortout", t0)
        return out, fallback

    # -- arrays-end-to-end fast path ------------------------------------------

    def _backward_rows(self, qd, call_list, ivals_dev, infos_dev):
        """Raw-rows backward: ((n, 6) int32 rows [x0,x1,x2,start,end,lane]
        min_len-filtered, chronological within lane; overflow bool). v8 runs
        natively; other engines go through a list shim (the CPU/test path),
        so the downstream array assembly is engine-independent."""
        import jax.numpy as jnp

        N = len(call_list)
        if N == 0:
            return np.zeros((0, 6), np.int32), False
        if backward_engine() == "v8":
            from mpibwa_tpu.ops import backward8 as B8
            from mpibwa_tpu.ops import seeding_flat as SF

            def pad2(n):
                # {2^k, 1.5*2^k} ladder (see _run_backward_for_calls)
                return B8.cap_bucket(n, 1024)

            NLp = max(16, 1 << (N - 1).bit_length())
            arr = np.asarray(call_list, dtype=np.int64)
            lrow = np.zeros(NLp, np.int32)
            ltbl = np.zeros((NLp, 3), np.int32)
            x0 = np.zeros(NLp, np.int32)
            minv = np.ones(NLp, np.int64)
            lrow[:N] = arr[:, 0]
            ltbl[:N, 0] = arr[:, 1]
            ltbl[:N, 1] = arr[:, 2]
            starts = np.zeros(N, np.int64)
            if N > 1:
                np.cumsum(arr[:-1, 2], out=starts[1:])
            ltbl[:N, 2] = starts
            x0[:N] = arr[:, 3]
            minv[:N] = arr[:, 4]
            e = int(arr[:, 2].sum())
            ltbl[N:, 2] = e
            ik, info, lane, live = SF.assemble_entries(
                ivals_dev, infos_dev, jnp.asarray(lrow),
                jnp.asarray(ltbl), pad2(e))
            rows, ov = B8.run_backward8(
                self.dfm, qd[jnp.asarray(lrow)], (ik, info, lane, live),
                NLp, x0, minv, min_len=self.opt.min_seed_len, raw=True,
                est_rows=N // 8 + 1024)
            return rows, bool(ov)
        # shim: per-lane lists -> rows with the same filter
        fb = np.zeros(1 + max(c[0] for c in call_list), bool)
        mems = self._run_backward_for_calls(qd, call_list, ivals_dev,
                                            infos_dev, fb)
        if fb.any():
            return np.zeros((0, 6), np.int32), True
        rows = []
        msl = self.opt.min_seed_len
        for ln, mem in enumerate(mems):
            for iv in mem:
                st, en = iv[3] >> 32, iv[3] & 0xFFFFFFFF
                if en - st >= msl:
                    rows.append((iv[0], iv[1], iv[2], st, en, ln))
        return (np.array(rows, self.dfm.np_idt).reshape(-1, 6)
                if rows else np.zeros((0, 6), np.int32)), False

    @staticmethod
    def _order_rows(rows):
        """(lane asc, chronological desc) — the per-lane 'reversed()' of the
        list path, vectorized. Returns the reordered rows."""
        if len(rows) == 0:
            return rows
        order = np.lexsort((-np.arange(len(rows)), rows[:, 5]))
        return rows[order]

    def collect_flat(self, qs: List[np.ndarray]):
        """Arrays-end-to-end collect_intv: returns (flat (M,4) int64 rows in
        pre-sort pass order, mem_off int64[B+1], fallback (B,) bool) with no
        per-interval Python, or None (backward overflow -> caller uses the
        exact list path). Row-for-row equal to
        _pack_mems(collect_batch(sort=False))."""
        import time as _time

        import jax.numpy as jnp

        tt = self.__dict__.setdefault("times", {})

        def _mark(name, t0):
            tt[name] = tt.get(name, 0.0) + _time.time() - t0
            return _time.time()

        t0 = _time.time()
        opt = self.opt
        B = len(qs)
        q, lens = _pad_batch(qs)
        qd = jnp.asarray(q)
        self.last_qd = qd
        lensd = jnp.asarray(lens)

        # ---- pass 1 forward (+ pass 3, fused, sparse pull) ----
        p3_sparse = None
        if opt.max_mem_intv > 0:
            ivals1, infos1, ctl_d, bufs_d = _fused_p1_p3(
                self.dfm, qd, lensd, opt.min_seed_len, opt.max_mem_intv)
            est = self.__dict__.setdefault("_e1_est", {})
            counts, fallback, ncl, calls_np, n3_all, seeds_thunk = \
                _pull_p1p3(ctl_d, bufs_d, B, est)
            p3_sparse = (counts[:, 2], n3_all, seeds_thunk)
        else:
            min1 = jnp.ones(B, dtype=jnp.int64)
            fwd = seeding.forward_pass(self.dfm, qd, lensd, min1, True)
            packed = np.asarray(_pack_fwd(fwd))
            ivals1, infos1 = fwd.ivals, fwd.infos
            C = (packed.shape[1] - 2) // 3
            fallback = packed[:, 0] != 0
            ncl = np.minimum(packed[:, 1].astype(np.int64), C)
            b_ = np.repeat(np.arange(B, dtype=np.int64), ncl)
            base = np.zeros(B, np.int64)
            np.cumsum(ncl[:-1], out=base[1:])
            c_ = np.arange(len(b_), dtype=np.int64) - base[b_]
            calls_np = np.stack(
                [packed[b_, 2 + c_], packed[b_, 2 + C + c_],
                 packed[b_, 2 + 2 * C + c_]], axis=1).astype(np.int32)
        t0 = _mark("fwd1", t0)

        b_of = np.repeat(np.arange(B, dtype=np.int64), ncl)
        lanes1 = np.stack(
            [b_of, calls_np[:, 1].astype(np.int64),
             calls_np[:, 2].astype(np.int64),
             calls_np[:, 0].astype(np.int64),
             np.ones(len(b_of), np.int64)], axis=1)
        t0 = _mark("tables1", t0)
        rows1, ov1 = self._backward_rows(qd, lanes1, ivals1, infos1)
        if ov1:
            return None
        t0 = _mark("bwd1", t0)
        rows1 = self._order_rows(rows1)
        read1 = (lanes1[:, 0][rows1[:, 5]] if len(rows1)
                 else np.zeros(0, np.int64))

        # ---- pass 2 (selection over pass-1 rows in iteration order) ----
        split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
        sel = ((rows1[:, 4] - rows1[:, 3] >= split_len)
               & (rows1[:, 2] <= opt.split_width)) if len(rows1) else \
            np.zeros(0, bool)
        rows2 = np.zeros((0, 6), np.int32)
        read2 = np.zeros(0, np.int64)
        if sel.any():
            srows = rows1[sel]
            sreads = read1[sel]
            n2 = len(srows)
            B2 = 1 << max(4, (n2 - 1).bit_length())
            # build the sub-batch ON DEVICE: the reads already live in qd,
            # so pass 2 uploads only the (B2,) row indices (~4 B/row)
            # instead of re-sending (B2, L) bases to the device
            row_idx = np.zeros(B2, np.int32)
            row_idx[:n2] = sreads
            valid2 = np.zeros(B2, bool)
            valid2[:n2] = True
            lens2 = np.zeros(B2, np.int32)
            lens2[:n2] = lens[sreads]
            starts2 = np.zeros(B2, np.int32)
            starts2[:n2] = (srows[:, 3] + srows[:, 4]) >> 1
            min2 = np.ones(B2, np.int64)
            min2[:n2] = srows[:, 2].astype(np.int64) + 1
            q2d = jnp.where(jnp.asarray(valid2)[:, None],
                            qd[jnp.asarray(row_idx)], jnp.uint8(4))
            t2 = _time.time()
            fwd2 = seeding.forward_pass(self.dfm, q2d, jnp.asarray(lens2),
                                        jnp.asarray(min2), False,
                                        jnp.asarray(starts2))
            v8 = backward_engine() == "v8"
            est2 = self.__dict__.setdefault("_p2_est", {})
            done2 = False
            if v8 and "e" in est2:
                # sync-free pass 2: lane tables built ON DEVICE from the
                # forward outputs with a SPECULATIVE entry capacity, so
                # nothing blocks between the forward and backward
                # dispatches; per-read overflow flags + the measured e2
                # ride an async pull consumed after the backward result.
                # A capacity miss flips the backward's overflow -> redo
                # via the synchronous route below (rare; estimate adapts).
                from mpibwa_tpu.ops import backward8 as B8
                from mpibwa_tpu.ops import seeding_flat as SF
                from mpibwa_tpu.ops.pulls import pull_prefix_async

                cap = B8.cap_bucket(max(int(est2["e"]) * 5 // 4, 1024),
                                    1024)
                ltbl_d, x0_d, ctl2_d, cap_ov = _p2_tables(fwd2, cap)
                ik2, info2, lane2_, live2_ = SF.assemble_entries(
                    fwd2.ivals, fwd2.infos,
                    jnp.arange(B2, dtype=jnp.int32), ltbl_d, cap)
                ctl2_thunk = pull_prefix_async(ctl2_d, 1 + n2)
                tt["p2_fwd"] = tt.get("p2_fwd", 0.0) + _time.time() - t2
                t2 = _time.time()
                rows2, ov2 = B8.run_backward8(
                    self.dfm, q2d, (ik2, info2, lane2_, live2_), B2,
                    x0_d, jnp.asarray(min2.astype(np.int32)),
                    min_len=self.opt.min_seed_len, raw=True,
                    est_rows=B2 // 8 + 1024, extra_ov=cap_ov)
                tt["p2_bwd"] = tt.get("p2_bwd", 0.0) + _time.time() - t2
                t2 = _time.time()  # a redo below times only its own pull
                ctl2 = ctl2_thunk()
                est2["e"] = max(int(ctl2[0]), 64)
                if not ov2:
                    ovl = ctl2[1 : 1 + n2] != 0
                    if ovl.any():
                        fallback[sreads[ovl]] = True
                    rows2 = self._order_rows(rows2)
                    read2 = (sreads[rows2[:, 5]] if len(rows2)
                             else np.zeros(0, np.int64))
                    done2 = True
                # ov2 (backward OR capacity): fall through to the exact
                # synchronous route with the same fwd2 outputs
            if not done2:
                p2 = np.asarray(_pack_fwd1(fwd2))
                tt["p2_fwd"] = tt.get("p2_fwd", 0.0) + _time.time() - t2
                ovl = p2[:n2, 0] != 0
                if ovl.any():
                    fallback[sreads[ovl]] = True
                live2 = p2[:n2, 1] > 0
                est2["e"] = max(int(p2[:n2, 4][live2].sum()), 64)
                l2idx = np.nonzero(live2)[0]
                if len(l2idx):
                    call_list2 = np.stack(
                        [l2idx, p2[l2idx, 3], p2[l2idx, 4], p2[l2idx, 2],
                         min2[l2idx]], axis=1)
                    t2 = _time.time()
                    rows2, ov2 = self._backward_rows(q2d, call_list2,
                                                     fwd2.ivals,
                                                     fwd2.infos)
                    tt["p2_bwd"] = tt.get("p2_bwd", 0.0) + _time.time() - t2
                    if ov2:
                        return None
                    rows2 = self._order_rows(rows2)
                    read2 = (sreads[l2idx[rows2[:, 5]]] if len(rows2)
                             else np.zeros(0, np.int64))
        t0 = _mark("pass2", t0)

        # ---- pass 3 rows ----
        rows3 = np.zeros((0, 4), np.int64)
        read3 = np.zeros(0, np.int64)
        if p3_sparse is not None:
            ov3, n3, seeds_thunk3 = p3_sparse
            fallback |= ov3 != 0
            seeds_np = seeds_thunk3()  # transfer overlapped the backward
            if len(seeds_np):
                read3 = np.repeat(np.arange(B, dtype=np.int64), n3)
                keep3 = ~fallback[read3]
                read3 = read3[keep3]
                rows3 = seeds_np[keep3]
        t0 = _mark("pass3", t0)

        # ---- combine per read: pass order within read, no sort ----
        def to4(rows):
            out = np.empty((len(rows), 4), np.int64)
            out[:, 0] = rows[:, 0]
            out[:, 1] = rows[:, 1]
            out[:, 2] = rows[:, 2]
            out[:, 3] = (rows[:, 3].astype(np.int64) << 32) | rows[:, 4]
            return out

        flat = np.concatenate([to4(rows1), to4(rows2), rows3], axis=0)
        reads = np.concatenate([read1, read2, read3])
        ranks = np.concatenate(
            [np.zeros(len(read1), np.int64),
             np.ones(len(read2), np.int64),
             np.full(len(read3), 2, np.int64)])
        keep = ~fallback[reads] if len(reads) else np.zeros(0, bool)
        flat, reads, ranks = flat[keep], reads[keep], ranks[keep]
        order = np.argsort(reads * 4 + ranks, kind="stable")
        flat = flat[order]
        reads = reads[order]
        mem_off = np.searchsorted(reads, np.arange(B + 1, dtype=np.int64))
        _mark("sortout", t0)
        return flat, mem_off.astype(np.int64), fallback
