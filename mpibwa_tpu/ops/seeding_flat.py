"""Flat-queue backward SMEM pass: compute proportional to true work.

The lockstep (lane x P_CAP) backward pass wastes max_steps x padded-width
compute on dead entries. Here the surviving intervals of ALL (read, call)
lanes live in ONE flat array sorted by lane; every round extends exactly the
live entries (one occ4 pair each) and applies the per-lane keep/dedup/emit
logic of bwt.c:326-345 with segmented scans over the flat array. The host
compacts and halves capacity as entries die, so total compute tracks the
scalar engine's true work while staying fully batched.

Differentially tested against the scalar engine (same contract as
ops.seeding.backward_segment).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .fmd import DeviceFMIndex

M_CAP = 16  # max mems per lane (overflow -> scalar fallback)
SEG_SCHEDULE = (1, 2, 4)  # early compaction pays: most entries die fast


class FlatState(NamedTuple):
    ik: jnp.ndarray  # (E, 3)
    info: jnp.ndarray  # (E,) int64
    lane: jnp.ndarray  # (E,) int32, ascending
    live: jnp.ndarray  # (E,) bool
    i: jnp.ndarray  # (NL,) int32
    active: jnp.ndarray  # (NL,) bool
    last_start: jnp.ndarray  # (NL,) int64
    minv: jnp.ndarray  # (NL,) interval dtype
    mems: jnp.ndarray  # (NL, M_CAP, 3)
    mem_infos: jnp.ndarray  # (NL, M_CAP) int64
    n_mems: jnp.ndarray  # (NL,) int32
    overflow: jnp.ndarray  # (NL,) bool


def _seg_incl_cumsum(x: jnp.ndarray, reset: jnp.ndarray) -> jnp.ndarray:
    """Segmented inclusive cumsum: resets at positions where reset is True."""

    def comb(a, b):
        asum, areset = a
        bsum, breset = b
        return jnp.where(breset, bsum, asum + bsum), areset | breset

    out, _ = jax.lax.associative_scan(comb, (x, reset))
    return out


def _seg_last_keeper_x2(x2: jnp.ndarray, keeper: jnp.ndarray,
                        reset: jnp.ndarray):
    """For each position: (has_prev_keeper, x2_of_last_prev_keeper) among
    strictly-earlier positions of the same segment."""

    # inclusive scan carrying (last keeper x2, any keeper since segment start)
    def comb3(a, b):
        av, ah, ar = a
        bv, bh, br = b
        v = jnp.where(bh, bv, jnp.where(br, jnp.zeros_like(av), av))
        h = bh | (ah & ~br)
        r = ar | br
        return v, h, r

    v, h, _ = jax.lax.associative_scan(
        comb3, (jnp.where(keeper, x2, 0), keeper, reset))
    # shift right by one; a segment-start position has no previous keeper
    pv = jnp.concatenate([jnp.zeros_like(v[:1]), v[:-1]])
    ph = jnp.concatenate([jnp.zeros_like(h[:1]), h[:-1]])
    ph = ph & ~reset
    return ph, pv


@functools.partial(jax.jit, static_argnums=(3,))
def flat_rounds(fm: DeviceFMIndex, st: FlatState, qrows: jnp.ndarray,
                n_rounds: int) -> FlatState:
    E = st.ik.shape[0]
    NL, L = qrows.shape
    pos = jnp.arange(E, dtype=jnp.int32)
    lane_start = jnp.concatenate(
        [jnp.ones(1, bool), st.lane[1:] != st.lane[:-1]])

    def body(_, st: FlatState) -> FlatState:
        lane = st.lane
        i_lane = st.i[lane]
        live = st.live & st.active[lane]
        safe_i = jnp.clip(i_lane, 0, L - 1)
        qi = jnp.where((i_lane >= 0) & (i_lane < L),
                       qrows[lane, safe_i], jnp.uint8(4))
        has_c = (i_lane >= 0) & (qi < 4)
        c = jnp.clip(qi, 0, 3).astype(jnp.int32)

        ok = fm.extend(st.ik, 1)  # (E, 4, 3)
        okc = ok[pos, c, :]
        keeper = live & has_c & (okc[:, 2] >= st.minv[lane])

        # first live entry of each lane
        excl_live = _seg_incl_cumsum(live.astype(jnp.int32), lane_start) \
            - live.astype(jnp.int32)
        first_live = live & (excl_live == 0)

        # mem emission: the first (longest-match) entry fails extension
        not_contained = (i_lane + 1) < st.last_start[lane]
        emit = first_live & ~keeper & not_contained
        midx = jnp.minimum(st.n_mems[lane], M_CAP - 1)
        lane_sel = jnp.where(emit, lane, NL).astype(jnp.int32)
        info_val = st.info | ((i_lane + 1).astype(jnp.int64) << 32)
        mems = st.mems.at[lane_sel, midx].set(st.ik, mode="drop")
        mem_infos = st.mem_infos.at[lane_sel, midx].set(info_val, mode="drop")
        emit_per_lane = jax.ops.segment_sum(emit.astype(jnp.int32),
                                            lane.astype(jnp.int32),
                                            num_segments=NL)
        n_mems = st.n_mems + emit_per_lane
        ov_e = emit & (st.n_mems[lane] >= M_CAP)
        overflow = st.overflow | (jax.ops.segment_sum(
            ov_e.astype(jnp.int32), lane.astype(jnp.int32),
            num_segments=NL) > 0)
        # the first-fails emission also happens for first-live entries whose
        # lane already emitted at this i? cannot: one first_live per lane.
        last_start = st.last_start.at[jnp.where(
            emit, lane, NL).astype(jnp.int32)].set(
                (i_lane + 1).astype(jnp.int64), mode="drop")

        # dedup: drop a keeper whose previous keeper in the lane has the
        # same interval size (bwt.c:338)
        ph, pv = _seg_last_keeper_x2(okc[:, 2], keeper, lane_start)
        append = keeper & (~ph | (okc[:, 2] != pv))

        n_new = jax.ops.segment_sum(append.astype(jnp.int32),
                                    lane.astype(jnp.int32), num_segments=NL)
        cont = st.active & (n_new > 0)
        new_ik = jnp.where(append[:, None], okc, st.ik)
        new_active = cont
        new_i = jnp.where(cont, st.i - 1, st.i)
        return FlatState(new_ik, st.info, st.lane, append, new_i, new_active,
                         last_start, st.minv, mems, mem_infos, n_mems,
                         overflow)

    return jax.lax.fori_loop(0, n_rounds, body, st)


@functools.partial(jax.jit, static_argnums=(3,))
def flat_rounds_while(fm: DeviceFMIndex, st: FlatState, qrows: jnp.ndarray,
                      max_rounds: int) -> FlatState:
    """Single-shot backward: run rounds until no entry is live (or the
    max_rounds safety bound), entirely on device — one dispatch, one sync.

    Per-round work stays at the initial capacity E (no compaction), while
    each host sync of the segment ladder would cost a host round trip."""
    E = st.ik.shape[0]
    NL, L = qrows.shape
    pos = jnp.arange(E, dtype=jnp.int32)
    lane_start = jnp.concatenate(
        [jnp.ones(1, bool), st.lane[1:] != st.lane[:-1]])

    def round_body(st: FlatState) -> FlatState:
        lane = st.lane
        i_lane = st.i[lane]
        live = st.live & st.active[lane]
        safe_i = jnp.clip(i_lane, 0, L - 1)
        qi = jnp.where((i_lane >= 0) & (i_lane < L),
                       qrows[lane, safe_i], jnp.uint8(4))
        has_c = (i_lane >= 0) & (qi < 4)
        c = jnp.clip(qi, 0, 3).astype(jnp.int32)

        ok = fm.extend(st.ik, 1)  # (E, 4, 3)
        okc = ok[pos, c, :]
        keeper = live & has_c & (okc[:, 2] >= st.minv[lane])

        excl_live = _seg_incl_cumsum(live.astype(jnp.int32), lane_start)             - live.astype(jnp.int32)
        first_live = live & (excl_live == 0)

        not_contained = (i_lane + 1) < st.last_start[lane]
        emit = first_live & ~keeper & not_contained
        midx = jnp.minimum(st.n_mems[lane], M_CAP - 1)
        lane_sel = jnp.where(emit, lane, NL).astype(jnp.int32)
        info_val = st.info | ((i_lane + 1).astype(jnp.int64) << 32)
        mems = st.mems.at[lane_sel, midx].set(st.ik, mode="drop")
        mem_infos = st.mem_infos.at[lane_sel, midx].set(info_val, mode="drop")
        emit_per_lane = jax.ops.segment_sum(emit.astype(jnp.int32),
                                            lane.astype(jnp.int32),
                                            num_segments=NL)
        n_mems = st.n_mems + emit_per_lane
        ov_e = emit & (st.n_mems[lane] >= M_CAP)
        overflow = st.overflow | (jax.ops.segment_sum(
            ov_e.astype(jnp.int32), lane.astype(jnp.int32),
            num_segments=NL) > 0)
        last_start = st.last_start.at[jnp.where(
            emit, lane, NL).astype(jnp.int32)].set(
                (i_lane + 1).astype(jnp.int64), mode="drop")

        ph, pv = _seg_last_keeper_x2(okc[:, 2], keeper, lane_start)
        append = keeper & (~ph | (okc[:, 2] != pv))

        n_new = jax.ops.segment_sum(append.astype(jnp.int32),
                                    lane.astype(jnp.int32), num_segments=NL)
        cont = st.active & (n_new > 0)
        new_ik = jnp.where(append[:, None], okc, st.ik)
        new_i = jnp.where(cont, st.i - 1, st.i)
        return FlatState(new_ik, st.info, st.lane, append, new_i, cont,
                         last_start, st.minv, mems, mem_infos, n_mems,
                         overflow)

    def cond(carry):
        r, st = carry
        return (r < max_rounds) & jnp.any(st.live & st.active[st.lane])

    def body(carry):
        r, st = carry
        return r + 1, round_body(st)

    _, st = jax.lax.while_loop(cond, body, (jnp.int32(0), st))
    return st




@functools.partial(jax.jit, static_argnums=(4,))
def assemble_entries(ivals: jnp.ndarray, infos: jnp.ndarray,
                     lane_row: jnp.ndarray, lane_tbl: jnp.ndarray,
                     E: int):
    """Build the flat entry arrays ON DEVICE from forward-pass buffers.

    lane_row: (NL,) int32 row into ivals/infos; lane_tbl: (NL, 3) int32 =
    (push_start, push_len, entry_start). Entry j of lane ln maps to push
    index push_start + push_len-1 - (j - entry_start) (reversed push order,
    longest match first)."""
    NL = lane_row.shape[0]
    starts = lane_tbl[:, 2]
    e_idx = jnp.arange(E, dtype=jnp.int32)
    # lane of entry e = last lane with entry_start <= e. searchsorted is a
    # log-depth gather chain over E entries (~0.5 s at E=2M); the same map
    # is one scatter-max + a running-max scan: mark each lane's id at its
    # start (max resolves zero-length-lane ties to the last lane id, the
    # searchsorted-right semantics; starts == E drop out), then carry.
    marks = jnp.zeros(E, jnp.int32).at[starts].max(
        jnp.arange(NL, dtype=jnp.int32), mode="drop")
    lane = jax.lax.associative_scan(jnp.maximum, marks)
    lane = jnp.clip(lane, 0, NL - 1)
    j_in = e_idx - starts[lane]
    push = lane_tbl[lane, 0] + lane_tbl[lane, 1] - 1 - j_in
    row = lane_row[lane]
    safe = jnp.clip(push, 0, ivals.shape[1] - 1)
    ik = ivals[row, safe]
    info = infos[row, safe].astype(jnp.int64)
    live = (j_in >= 0) & (j_in < lane_tbl[lane, 1])
    return ik, info, lane, live


@functools.partial(jax.jit, static_argnums=(4,))
def compact_entries(st_ik, st_info, st_lane, st_live, newE: int,
                    pad_lane: int):
    """Stable device-side compaction: live entries to the front of a smaller
    array. No index data crosses the host link (argsort on ~live)."""
    E = st_live.shape[0]
    order = jnp.argsort(~st_live, stable=True)[:newE]
    ik = st_ik[order]
    info = st_info[order]
    live = st_live[order]
    lane = jnp.where(live, st_lane[order], pad_lane).astype(jnp.int32)
    return ik, info, lane, live


@functools.partial(jax.jit, static_argnums=(3,))
def flatten_mems(mems, mem_infos, n_mems, TOT: int):
    """Compact per-lane mem buffers into one flat array of TOT entries so
    the host pulls only real data."""
    NL, M = mems.shape[0], mems.shape[1]
    off = jnp.concatenate([jnp.zeros(1, n_mems.dtype),
                           jnp.cumsum(n_mems)[:-1]])
    j = jnp.arange(M, dtype=jnp.int32)[None, :]
    dest = jnp.where(j < n_mems[:, None], off[:, None] + j, TOT)
    flat = jnp.zeros((TOT, 3), mems.dtype).at[dest.reshape(-1)].set(
        mems.reshape(-1, 3), mode="drop")
    flat_i = jnp.zeros((TOT,), mem_infos.dtype).at[dest.reshape(-1)].set(
        mem_infos.reshape(-1), mode="drop")
    return flat, flat_i


def run_backward_flat(fm: DeviceFMIndex, qrows_dev, entry_dev, n_lanes: int,
                      x0_np, minv_np, real_lanes=None):
    """Device-resident driver.

    qrows_dev: (NL, L) uint8 jax array (NL already ladder-padded);
    entry_dev: (ik, info, lane, live) jax arrays of ladder capacity E;
    x0_np/minv_np: (NL,) numpy. Only O(E) bools and O(n_live) int32 index
    vectors cross the host link per segment; mems are pulled once at the end
    for lanes that emitted. Returns (per-lane mem lists, overflow (NL,))."""
    NL = n_lanes
    idt = fm.np_idt
    ik_d, info_d, lane_d, live_d = entry_dev
    i_d = jnp.asarray(x0_np.astype(np.int32) - 1)
    # lanes active iff they have live entries
    act_d = jax.ops.segment_sum(live_d.astype(jnp.int32),
                                lane_d.astype(jnp.int32),
                                num_segments=NL) > 0
    ls_d = jnp.full(NL, jnp.int64(1) << 62)
    minv_d = jnp.asarray(minv_np.astype(idt))
    mems_d = jnp.zeros((NL, M_CAP, 3), jnp.asarray(ik_d).dtype)
    mi_d = jnp.zeros((NL, M_CAP), jnp.int64)
    nm_d = jnp.zeros(NL, jnp.int32)
    ov_d = jnp.zeros(NL, bool)

    def pad_cap(n):
        c = 256
        while c < n:
            c <<= 2
        return c

    seg_i = 0
    st = FlatState(ik_d, info_d, lane_d, live_d, i_d, act_d, ls_d, minv_d,
                   mems_d, mi_d, nm_d, ov_d)
    import os

    dbg = os.environ.get("MPIBWA_BWD_DEBUG") == "1"
    if dbg:
        import sys as _sys
        import time as _time
        _td = _time.time()

    # hybrid: compaction ladder while capacity is large (per-round cost
    # scales with E), then one device while_loop to finish once the live
    # set fits a small capacity (saves the tail's host syncs). Full
    # single-shot measured slower: the O(E log E) segmented scans dominate
    # at initial capacity.
    mode = os.environ.get("MPIBWA_BWD_MODE", "hybrid")
    L = qrows_dev.shape[1]
    if mode == "single":
        st = flat_rounds_while(fm, st, qrows_dev, L + 1)
        return _pull_mems(st, NL)
    finish_cap = int(os.environ.get("MPIBWA_FINISH_CAP", "4096"))
    sched = SEG_SCHEDULE
    env_sched = os.environ.get("MPIBWA_BWD_SCHED")
    if env_sched:
        sched = tuple(int(x) for x in env_sched.split(","))
    while True:
        n_rounds = sched[min(seg_i, len(sched) - 1)]
        seg_i += 1
        st = flat_rounds(fm, st, qrows_dev, n_rounds)
        n_live = int(jnp.sum(st.live))  # one scalar crosses the link
        if dbg:
            print(f"  bwd seg{seg_i} cap={st.ik.shape[0]} rounds={n_rounds} "
                  f"live={n_live} dt={_time.time()-_td:.3f}", file=_sys.stderr)
            _td = _time.time()
        if n_live == 0:
            break
        cap = st.ik.shape[0]
        newE = pad_cap(n_live)
        if newE < cap:
            ik2, info2, lane2, live2 = compact_entries(
                st.ik, st.info, st.lane, st.live, newE, NL - 1)
            st = FlatState(ik2, info2, lane2, live2, st.i, st.active,
                           st.last_start, st.minv, st.mems, st.mem_infos,
                           st.n_mems, st.overflow)
        if mode == "hybrid" and st.ik.shape[0] <= finish_cap:
            st = flat_rounds_while(fm, st, qrows_dev, L + 1)
            if dbg:
                st.live.block_until_ready()
                print(f"  bwd while cap={st.ik.shape[0]} "
                      f"dt={_time.time()-_td:.3f}", file=_sys.stderr)
            break
    return _pull_mems(st, NL)


# ---------------------------------------------------------------------------
# Contiguous-compaction backward engine ("contig").
#
# Key algebraic fact: within one lane the intervals are NESTED (all share the
# start position x, longer match = sub-interval), so their sizes are
# non-decreasing along the stored longest-match-first order, and backward
# extension preserves that order (bwt_extend is monotone wrt interval
# inclusion). Hence per round the extension FAILURES (ok[c].x[2] < max_intv)
# form a PREFIX of each lane's live list and the keepers a SUFFIX — exactly
# the structure bwt_smem1a's scalar loop exploits (bwt.c:326-345: the first
# entry emits iff it fails; dedup compares only against the previously
# appended entry).
#
# With live entries kept CONTIGUOUS per lane (full compaction every round),
# every segmented scan of the flat engine collapses to a neighbor
# comparison, per-lane bookkeeping becomes (NL,)-wide searchsorted+gather,
# and the only remaining scan is one int32 cumsum for the compaction
# scatter. State is stored as 1-D/(small, E) arrays so the entry axis is
# the minor dimension (the (E, 3) layout of FlatState strides 3 -> the
# entry axis on every materialization).
# ---------------------------------------------------------------------------


class ContigState(NamedTuple):
    kls: jnp.ndarray  # (3, E) idt: k, l, s rows
    info: jnp.ndarray  # (E,) int32 (forward 'end' payload)
    lane: jnp.ndarray  # (E,) int32 ascending; NL = dead sentinel
    i: jnp.ndarray  # (NL,) int32 current backward position
    active: jnp.ndarray  # (NL,) bool
    last_start: jnp.ndarray  # (NL,) int32
    minv: jnp.ndarray  # (NL,) idt
    mems_kls: jnp.ndarray  # (3, NL*M_CAP) idt
    mems_inf: jnp.ndarray  # (2, NL*M_CAP) int32: info_lo, start(i+1)
    n_mems: jnp.ndarray  # (NL,) int32
    overflow: jnp.ndarray  # (NL,) bool


@functools.partial(jax.jit, static_argnums=(4,))
def assemble_cols(ivals: jnp.ndarray, infos: jnp.ndarray,
                  lane_row: jnp.ndarray, lane_tbl: jnp.ndarray, E: int):
    """assemble_entries in column layout: (kls (3,E), info (E,), lane (E,))
    with live entries contiguous per lane and the dead tail lane == NL."""
    NL = lane_row.shape[0]
    starts = lane_tbl[:, 2]
    e_idx = jnp.arange(E, dtype=jnp.int32)
    lane = (jnp.searchsorted(starts, e_idx, side="right") - 1).astype(jnp.int32)
    lane = jnp.clip(lane, 0, NL - 1)
    j_in = e_idx - starts[lane]
    push = lane_tbl[lane, 0] + lane_tbl[lane, 1] - 1 - j_in
    row = lane_row[lane]
    safe = jnp.clip(push, 0, ivals.shape[1] - 1)
    kls = jnp.stack([ivals[row, safe, 0], ivals[row, safe, 1],
                     ivals[row, safe, 2]], axis=0)
    info = infos[row, safe].astype(jnp.int32)
    live = (j_in >= 0) & (j_in < lane_tbl[lane, 1])
    lane = jnp.where(live, lane, NL)
    return kls, info, lane


def _round_contig(fm: DeviceFMIndex, st: ContigState, qrows: jnp.ndarray,
                  NL: int) -> ContigState:
    E = st.lane.shape[0]
    L = qrows.shape[1]
    M = M_CAP
    lane = st.lane
    lane_c = jnp.minimum(lane, NL - 1)
    valid = lane < NL
    i_lane = st.i[lane_c]  # (E,)
    safe_i = jnp.clip(i_lane, 0, L - 1)
    qi = jnp.where((i_lane >= 0) & (i_lane < L),
                   qrows[lane_c, safe_i], jnp.uint8(4))
    has_c = (i_lane >= 0) & (qi < 4)
    c = jnp.clip(qi, 0, 3).astype(jnp.int32)

    k2, l2, s2 = fm.extend_back1(st.kls[0], st.kls[1], st.kls[2], c)
    keeper = valid & has_c & (s2 >= st.minv[lane_c])

    # neighbor logic (failures are a prefix, keepers a suffix per lane)
    lane_prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), lane[:-1]])
    boundary = lane != lane_prev
    keeper_prev = jnp.concatenate([jnp.zeros(1, bool), keeper[:-1]])
    s2_prev = jnp.concatenate([jnp.zeros_like(s2[:1]), s2[:-1]])
    append = keeper & (boundary | ~keeper_prev | (s2 != s2_prev))

    # per-lane bookkeeping: first/last live entry via searchsorted
    lanes_r = jnp.arange(NL, dtype=jnp.int32)
    pos_f = jnp.searchsorted(lane, lanes_r, side="left").astype(jnp.int32)
    pos_l = jnp.searchsorted(lane, lanes_r, side="right").astype(jnp.int32) - 1
    posf_c = jnp.clip(pos_f, 0, E - 1)
    lane_has = (pos_l >= pos_f) & (lane[posf_c] == lanes_r)

    # emission: first live entry failed (bwt.c:329-334), not contained
    emit_l = lane_has & ~keeper[posf_c] \
        & ((st.i + 1) < st.last_start)
    midx = jnp.minimum(st.n_mems, M - 1)
    dest_m = jnp.where(emit_l, lanes_r * M + midx, NL * M)
    mems_kls = st.mems_kls.at[:, dest_m].set(
        st.kls[:, posf_c], mode="drop")
    mems_inf = st.mems_inf.at[:, dest_m].set(
        jnp.stack([st.info[posf_c], st.i + 1]), mode="drop")
    overflow = st.overflow | (emit_l & (st.n_mems >= M))
    n_mems = st.n_mems + emit_l.astype(jnp.int32)
    last_start = jnp.where(emit_l, st.i + 1, st.last_start)

    # lane continues iff its LAST live entry kept (keepers are a suffix)
    new_active = lane_has & keeper[jnp.clip(pos_l, 0, E - 1)]
    new_i = jnp.where(new_active, st.i - 1, st.i)

    # full compaction: appended entries to the front, order preserved
    incl = jnp.cumsum(append.astype(jnp.int32))
    dest = jnp.where(append, incl - 1, E)
    new_kls = jnp.zeros_like(st.kls).at[:, dest].set(
        jnp.stack([k2, l2, s2]), mode="drop")
    new_info = jnp.zeros_like(st.info).at[dest].set(st.info, mode="drop")
    new_lane = jnp.full((E,), NL, jnp.int32).at[dest].set(lane, mode="drop")
    return ContigState(new_kls, new_info, new_lane, new_i, new_active,
                       last_start, st.minv, mems_kls, mems_inf, n_mems,
                       overflow)


@functools.partial(jax.jit, static_argnums=(3, 4))
def contig_rounds(fm: DeviceFMIndex, st: ContigState, qrows: jnp.ndarray,
                  n_rounds: int, NL: int) -> ContigState:
    return jax.lax.fori_loop(
        0, n_rounds, lambda _, s: _round_contig(fm, s, qrows, NL), st)


@functools.partial(jax.jit, static_argnums=(3, 4))
def contig_rounds_while(fm: DeviceFMIndex, st: ContigState,
                        qrows: jnp.ndarray, max_rounds: int,
                        NL: int) -> ContigState:
    """Whole backward in ONE dispatch: rounds until every lane is done."""

    def cond(carry):
        r, s = carry
        return (r < max_rounds) & jnp.any(s.active)

    def body(carry):
        r, s = carry
        return r + 1, _round_contig(fm, s, qrows, NL)

    _, st = jax.lax.while_loop(cond, body, (jnp.int32(0), st))
    return st


@functools.partial(jax.jit, static_argnums=(1, 2))
def _shrink_contig(st: ContigState, newE: int, NL: int) -> ContigState:
    """Capacity shrink = slicing: compaction already packed live entries."""
    return st._replace(kls=st.kls[:, :newE], info=st.info[:newE],
                       lane=st.lane[:newE])


def run_backward_contig(fm: DeviceFMIndex, qrows_dev, cols_dev, n_lanes: int,
                        x0_np, minv_np):
    """Driver: ladder of contig_rounds segments with slice-shrink, then a
    single while_loop to finish. cols_dev = (kls, info, lane) from
    assemble_cols. Same contract as run_backward_flat."""
    import os

    NL = n_lanes
    idt = fm.np_idt
    kls, info, lane = cols_dev
    L = qrows_dev.shape[1]
    st = ContigState(
        kls=kls, info=info, lane=lane,
        i=jnp.asarray(x0_np.astype(np.int32) - 1),
        active=jnp.zeros(NL, bool).at[lane].set(True, mode="drop"),
        last_start=jnp.full(NL, np.int32(2**31 - 1)),
        minv=jnp.asarray(minv_np.astype(idt)),
        mems_kls=jnp.zeros((3, NL * M_CAP), jnp.asarray(kls).dtype),
        mems_inf=jnp.zeros((2, NL * M_CAP), jnp.int32),
        n_mems=jnp.zeros(NL, jnp.int32),
        overflow=jnp.zeros(NL, bool),
    )

    dbg = os.environ.get("MPIBWA_BWD_DEBUG") == "1"
    if dbg:
        import sys as _sys
        import time as _time
        _td = _time.time()

    def pad2(n):
        c = 1024
        while c < n:
            c <<= 1
        return c

    mode = os.environ.get("MPIBWA_CONTIG_MODE", "ladder")
    finish_cap = int(os.environ.get("MPIBWA_FINISH_CAP", "16384"))
    sched_env = os.environ.get("MPIBWA_CONTIG_SCHED", "1,2,4")
    sched = tuple(int(x) for x in sched_env.split(","))
    seg_i = 0
    while mode == "ladder" and st.lane.shape[0] > finish_cap:
        n_rounds = sched[min(seg_i, len(sched) - 1)]
        seg_i += 1
        st = contig_rounds(fm, st, qrows_dev, n_rounds, NL)
        n_live = int(jnp.sum(st.lane < NL))  # one scalar sync
        if dbg:
            print(f"  ctg seg{seg_i} cap={st.lane.shape[0]} "
                  f"rounds={n_rounds} live={n_live} "
                  f"dt={_time.time()-_td:.3f}", file=_sys.stderr)
            _td = _time.time()
        if n_live == 0:
            return _pull_mems_contig(st, NL)
        newE = pad2(n_live)
        if newE < st.lane.shape[0]:
            st = _shrink_contig(st, newE, NL)
    st = contig_rounds_while(fm, st, qrows_dev, L + 1, NL)
    if dbg:
        st.lane.block_until_ready()
        print(f"  ctg while cap={st.lane.shape[0]} "
              f"dt={_time.time()-_td:.3f}", file=_sys.stderr)
    return _pull_mems_contig(st, NL)


@functools.partial(jax.jit, static_argnums=(1,))
def _flatten_mems_contig(st: ContigState, TOT: int):
    NL = st.n_mems.shape[0]
    M = M_CAP
    nm = jnp.minimum(st.n_mems, M)
    off = jnp.concatenate([jnp.zeros(1, jnp.int32),
                           jnp.cumsum(nm)[:-1].astype(jnp.int32)])
    j = jnp.arange(M, dtype=jnp.int32)[None, :]
    dest = jnp.where(j < nm[:, None], off[:, None] + j, TOT).reshape(-1)
    flat_kls = jnp.zeros((3, TOT), st.mems_kls.dtype).at[:, dest].set(
        st.mems_kls.reshape(3, -1), mode="drop")
    flat_inf = jnp.zeros((2, TOT), jnp.int32).at[:, dest].set(
        st.mems_inf.reshape(2, -1), mode="drop")
    return flat_kls, flat_inf


def _pull_mems_contig(st: ContigState, NL: int):
    def pad_cap(n):
        c = 256
        while c < n:
            c <<= 2
        return c

    nm_np = np.minimum(np.asarray(st.n_mems), M_CAP)
    overflow = np.asarray(st.overflow).copy()
    out_mems = [[] for _ in range(NL)]
    total = int(nm_np.sum())
    if total:
        TOT = pad_cap(total)
        flat_kls, flat_inf = _flatten_mems_contig(st, TOT)
        kls_np = np.asarray(flat_kls)
        inf_np = np.asarray(flat_inf)
        infos = (inf_np[1].astype(np.int64) << 32) \
            | inf_np[0].astype(np.uint32).astype(np.int64)
        off = 0
        for ln in range(NL):
            for j in range(nm_np[ln]):
                out_mems[ln].append(
                    (int(kls_np[0, off + j]), int(kls_np[1, off + j]),
                     int(kls_np[2, off + j]), int(infos[off + j])))
            off += nm_np[ln]
    return out_mems, overflow


def _pull_mems(st: FlatState, NL: int):
    """Final pull: flatten mems on device, ship only real entries."""

    def pad_cap(n):
        c = 256
        while c < n:
            c <<= 2
        return c

    nm_np = np.minimum(np.asarray(st.n_mems), M_CAP)
    overflow = np.asarray(st.overflow).copy()
    out_mems = [[] for _ in range(NL)]
    total = int(nm_np.sum())
    if total:
        TOT = pad_cap(total)
        flat, flat_i = flatten_mems(st.mems, st.mem_infos,
                                    jnp.asarray(nm_np.astype(np.int32)), TOT)
        flat_np = np.asarray(flat)
        fi_np = np.asarray(flat_i)
        off = 0
        for ln in range(NL):
            for j in range(nm_np[ln]):
                out_mems[ln].append(
                    (int(flat_np[off + j, 0]), int(flat_np[off + j, 1]),
                     int(flat_np[off + j, 2]), int(fi_np[off + j])))
            off += nm_np[ln]
    return out_mems, overflow
