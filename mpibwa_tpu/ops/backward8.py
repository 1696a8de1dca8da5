"""(8, W)-native XLA backward-SMEM engine ("v8"): minimal-gather rounds,
no scans, no searchsorted, no host syncs.

Design rule: a round is a few gathers of small data plus one fused
elementwise cluster; segmented scans, searchsorted and other non-fused
data movement stay out of the round body. (The rule and the constants
below were set on the previous accelerator; none is tuned on the H100.)

Three algebraic facts about bwt_smem1a's backward pass (bwt.c:326-345)
make that possible (all follow from per-lane intervals being NESTED with
sizes non-decreasing in slot order, which bwt_extend preserves):

1. Extension failures form a PREFIX of each lane's live entries and
   keepers a SUFFIX, so "the first live entry" is a per-lane POINTER that
   only moves to the first keeper's slot — maintained with one
   scatter-min, no scan.
2. Dedup (bwt.c:338 drops a keeper whose predecessor kept the same size)
   is REDUNDANT here: nested intervals of equal size are the SAME
   interval, so a duplicate behaves identically to its earlier twin every
   subsequent round, fails in the same round, and can never sit at the
   first-live pointer — it never emits and never diverges. Skipping dedup
   changes no output.
3. The backward interval x[1] of an emitted mem is consumed by NOTHING
   downstream (mem_chain reads x[0]/x[2]/info only, bwamem.c:277-289;
   x[1] exists for the forward half of the bidirectional search). v8
   freezes x[1] at its forward-pass value instead of maintaining it,
   which cuts the occ work per round from all 4 bases to the one chosen
   base (bwt_extend's x[1] cascade is the only consumer of the other
   three counts).

The FM-index is queried through a derived O2 layout (one (2,) int32 row
[occ_c, packed_word] per 16-base sub-block AND base, the base folded
into the gather index) so a rank query is ONE cheap 2-word row gather +
a dozen fused SWAR ops (multiply-free popcount). The layout is built
once from the bwa-format index and is output-invariant; positions may
be int64 (GRCh38-scale) while counts/gather indices stay int32.

Capacity follows a LEARNED shrink schedule: the first run of a shape
adapts (one 4-byte live-count sync per segment), records the capacity
trajectory, and every later run replays it with no syncs at all
(SCHED_CACHE below). Device-side overflow flags guard the replay — a
shrink that would drop live entries is detected on the single result
pull and the group is redone adaptively, so results never depend on the
schedule; an adaptive-run overflow falls back to the exact flat engine
(seeding_flat).

Differentially tested against the scalar engine in tests/test_device_ops.py
(x[1] excluded for this engine).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from mpibwa_tpu.ops.pulls import pull_prefix

M33 = jnp.uint32(0x33333333)
M55 = jnp.uint32(0x55555555)
M0F = jnp.uint32(0x0F0F0F0F)
I0 = np.int32(0)
I1 = np.int32(1)

import os as _os_mod

# Neither constant changes the output; both are untuned on the H100.
SEG_ROUNDS = int(_os_mod.environ.get("MPIBWA_SEG_ROUNDS", "4"))
#                    rounds per segment between shrinks (first seg: +1)
MIN_CAP = int(_os_mod.environ.get("MPIBWA_MIN_CAP", "8192"))
#                    switch to the single while_loop tail at this capacity

# MPIBWA_BWD_STATS=1 accumulates driver-phase seconds here (segments with
# their live-count syncs, tail+pack, result pull) for the bench profile
TIMES: dict = {}

# Learned capacity schedules: (E, L, NL, min_len) -> tuple of per-segment
# capacities measured on the first (adaptive) run of that shape, with
# SCHED_MARGIN headroom. Replaying the schedule statically removes EVERY
# per-segment live-count sync (each one a host round trip that stalls the
# dispatch queue). A shrink that would drop live entries flips the device
# overflow flag (checked on the single result pull); the driver then
# invalidates the schedule and redoes the group adaptively, so results
# never depend on the learned schedule being right.
SCHED_CACHE: dict = {}
# Margin 1.0: the replay uses the adaptive run's capacities VERBATIM, so
# it never introduces a compiled shape the adaptive pass didn't already
# build (a new segment8/shrink8 shape costs a compile). Group-to-group live-count drift is absorbed by the ladder's
# inherent rounding headroom; a genuine overflow retries adaptively.
SCHED_MARGIN = 1.0


def cap_bucket(n: int, floor: int = MIN_CAP) -> int:
    """Smallest {2^k, 1.5*2^k} ladder capacity >= n (multiple of 8).

    The ladder keeps the set of compiled segment/shrink shapes small (two
    per octave) while letting the adaptive schedule track the measured
    live count closely — a pure pow2 ladder wastes up to 2x round compute."""
    c = floor
    while c < n:
        if (c + (c >> 1)) >= n and (c + (c >> 1)) % 8 == 0:
            return c + (c >> 1)
        c <<= 1
    return c


def build_o2(bwt_arr):
    """Derived O2 table: one (2,) int32 row PER (16-base sub-block, base) —
    row[sb*4 + c] = [occ_c(sb), packed_word(sb)] — so a SINGLE-base rank
    query is one 2-word row gather with the base folded into the INDEX.

    The backward round (bwt_extend with x[1] frozen, bwt.c:262-275) needs
    exactly [occ_c, word] per position. 2 B/base of device memory (the
    word is stored 4x, the counts 1x). Valid for both position dtypes (counts are int32 up to
    ~8.6 Gbp of one base, guarded in DeviceFMIndex.__init__; the gather
    index sb*4+c < 2^31 for every supported genome)."""
    n_blocks = len(bwt_arr) // 16
    blocks = np.ascontiguousarray(bwt_arr[: n_blocks * 16]).reshape(
        n_blocks, 16)
    occ = blocks[:, :8].copy().view(np.uint64).astype(np.int64)  # (nb, 4)
    words = np.ascontiguousarray(blocks[:, 8:])  # (nb, 8) uint32

    def popcnt_pairs(m):
        x = (m & 0x33333333) + ((m >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        return (((x * 0x01010101) >> 24) & 0xFF).astype(np.int64)

    w = words.astype(np.uint32)
    nw = ~w
    wc = np.zeros((n_blocks, 8, 4), np.int64)
    for c in range(4):
        a = (w if c & 2 else nw) >> 1
        b = w if c & 1 else nw
        wc[:, :, c] = popcnt_pairs(a & b & np.uint32(0x55555555))
    wcum = np.zeros((n_blocks, 8, 4), np.int64)
    wcum[:, 1:] = np.cumsum(wc, axis=1)[:, :-1]
    occ16 = occ[:, None, :] + wcum  # (nb, 8, 4) counts at sub-block starts
    if occ16.max() > np.iinfo(np.int32).max:
        raise ValueError("occ counts exceed int32")
    n16 = n_blocks * 8
    o2 = np.zeros((n16 * 4, 2), np.int32)
    o2[:, 0] = occ16.reshape(n16 * 4).astype(np.int32)
    o2[:, 1] = np.repeat(words.reshape(n16).view(np.int32), 4)
    return o2  # host array: the caller places it on its device


def _bytesum(x):
    # multiply-free SWAR byte-sum (fields <= 16, no carries)
    return ((x + (x >> 8) + (x >> 16) + (x >> 24))
            & jnp.uint32(0x3F)).astype(jnp.int32)


def _count_prefix(word_i32, c, within):
    """Occurrences of base c (2-D int32 array) in the first within+1
    bases of the MSB-first packed word, incl. the bwt.c:183-184 base-0
    pad correction — the partial-word half of _occ_c2/_occ_c16."""
    sh = (np.int32(30) - np.int32(2) * within).astype(jnp.uint32)
    keepmask = ~((jnp.uint32(1) << sh) - jnp.uint32(1))
    w = lax.bitcast_convert_type(word_i32, jnp.uint32) & keepmask
    nw = ~w
    a = jnp.where((c & np.int32(2)) != I0, w, nw) >> 1
    b = jnp.where((c & np.int32(1)) != I0, w, nw)
    m = a & b & M55
    x = (m & M33) + ((m >> 2) & M33)
    x = (x + (x >> 4)) & M0F
    cnt = _bytesum(x)
    corr = jnp.where(c == I0, np.int32(15) - within, I0)
    return cnt - corr


def _occ_c2(o2, primary, ks, c):
    """Rank of base c at positions ks (negative = sentinel) via the O2
    layout: ONE (·, 2) row gather per position — the base is folded into
    the gather index, so the 4-way count select of _occ_c16 disappears
    too. Bit-identical to _occ_c16 / bwt_occ (bwt.c:98-130)."""
    sent = ks < I0
    k = jnp.where(sent, jnp.zeros_like(ks), ks)
    k = k - (k >= primary).astype(k.dtype)
    sb = (k >> 4).astype(jnp.int32)
    within = (k & np.int32(15)).astype(jnp.int32)
    row = o2[(sb << 2) + c]  # (..., 2) int32
    out = row[..., 0] + _count_prefix(row[..., 1], c, within)
    return jnp.where(sent, I0, out)


# ---------------------------------------------------------------------------
# round body
# ---------------------------------------------------------------------------


def _prev_slot(x, fill):
    """Slot-order predecessor of a (S, W) array (slot = r*W + c): shift
    along the minor axis, with column 0 fed from the previous row's last
    column. Two cheap 2-D slice/concat ops — no reshape relayout."""
    S, W = x.shape
    carry = jnp.concatenate(
        [jnp.full((1, 1), fill, x.dtype), x[:-1, -1:]], axis=0)  # (S, 1)
    return jnp.concatenate([carry, x[:, :-1]], axis=1)


def _round8(o2, l2sel, primary, qflat, Ln, NL, st):
    """One backward round — 4 latency-bound ops total. Gathers ride the
    measured-cheapest forms on this hardware (/tmp/gbench*.log): both occ
    positions in ONE O2 row-gather pair over a (8, 2W) index array
    (4.5 ns/index vs 11 for the OCC16 rows). The lane's first-live entry
    is found by NEIGHBOR logic, not per-lane state: dead entries grow as
    a prefix of each lane's contiguous slot block (fact 1 + stable
    compaction), so an entry is first-live iff it is live and its slot
    predecessor is dead or across a lane boundary — two 2-D shifts
    replace the old per-lane fp scatter-min + (NL, 2) row gather + the
    O(NL) fresh rebuild that dominated small-capacity rounds. State:
    (ik0, ik1, ik2, live, i_e, info, lane2d, minv_e — per-entry (8, W);
     bound — per-entry (8, W) int32 lane-start mask, static between
     compactions; emitted, em_start — per-entry (8, W))."""
    (ik0, ik1, ik2, live, i_e, info, lane2d, minv_e, bound,
     emitted, em_start) = st
    S, W = ik0.shape

    valid = (i_e >= I0) & (i_e < Ln)
    qoff = lane2d * Ln + jnp.clip(i_e, I0, Ln - I1)
    qi = jnp.where(valid, qflat[qoff], np.int32(4))
    c = jnp.minimum(qi, np.int32(3))
    has_c = valid & (qi < np.int32(4))

    # bwt_occ at k-1 and k-1+s in one O2 row-gather pair over (8, 2W)
    kq = ik0 - I1
    ks2 = jnp.concatenate([kq, kq + ik2], axis=1)
    c2 = jnp.concatenate([c, c], axis=1)
    t2 = _occ_c2(o2, primary, ks2, c2)
    tk = t2[:, :W]
    tl = t2[:, W:]
    s2 = tl - tk
    k2 = l2sel[c] + I1 + tk

    liveb = live != I0
    keeper = liveb & has_c & (s2 >= minv_e)

    # emission: the lane's first live entry fails (bwt.c:329-337). The C
    # loop's last_start containment check is REDUNDANT under fact 1
    # (failures form a prefix): within a round only the first-live entry
    # can emit (the check's within-round role), and between rounds i
    # strictly decreases so a new start i+1 is always < every earlier
    # start — the check can never fire.
    prev_live = _prev_slot(live, I0) != I0
    is_first = liveb & ((bound != I0) | ~prev_live)
    emit = is_first & ~keeper
    new_emitted = emitted | emit.astype(jnp.int32)
    new_em_start = jnp.where(emit, i_e + I1, em_start)

    app = keeper
    return (jnp.where(app, k2, ik0), ik1,
            jnp.where(app, s2, ik2),
            app.astype(jnp.int32),
            jnp.where(app, i_e - I1, i_e),
            info, lane2d, minv_e, bound, new_emitted, new_em_start)


def _mk_state_args(o2, l2sel, primary, qflat, Ln, NL):
    return lambda st: _round8(o2, l2sel, primary, qflat, Ln, NL, st)


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def segment8(tables, l2p, qflat, st, L: int, NL: int, n_rounds: int):
    """n_rounds rounds at the current capacity (one dispatch, no syncs)."""
    l2sel = l2p[:4]
    rb = _mk_state_args(tables, l2sel, l2p[4], qflat, np.int32(L), NL)
    return lax.fori_loop(0, n_rounds, lambda i, s: rb(s), st)


TAIL_STEPS = 4  # rounds per while_loop iteration in the tail


@functools.partial(jax.jit, static_argnums=(4, 5))
def tail8(tables, l2p, qflat, st, L: int, NL: int):
    """Run rounds until no entry is live (single dispatch).

    The body runs TAIL_STEPS rounds per loop iteration: at tail capacity
    (<= MIN_CAP) a round is launch-bound (~1.3 ms fixed vs ~0.2 ms of
    index work measured at E=8192), and a round over an all-dead state is
    a no-op (keeper/emit are masked by live), so over-stepping past the
    last live round costs only the wasted index work — the while cond and
    its device sync amortize 4x."""
    l2sel = l2p[:4]
    rb = _mk_state_args(tables, l2sel, l2p[4], qflat, np.int32(L), NL)

    def cond(carry):
        r, st = carry
        return (r < np.int32(L + 2)) & jnp.any(st[3] != I0)

    def body(carry):
        r, st = carry
        for _ in range(TAIL_STEPS):
            st = rb(st)
        return r + np.int32(TAIL_STEPS), st

    _, st = lax.while_loop(cond, body, (jnp.int32(0), st))
    return st


@functools.partial(jax.jit, static_argnums=(3, 4))
def shrink8(st, acc, acc_off, newE: int, NL: int, min_len=I0):
    """Device compaction to a smaller capacity: LIVE entries move to the
    front of the new working set; EMITTED entries are evacuated into the
    (MAXM, 6) accumulator at acc_off (they never rejoin the rounds, so the
    working set tracks only live work and the halving schedule holds).
    Overflow flag = live didn't fit or the accumulator is full.

    Compaction is cumsum + scatter (stable, O(E) data movement) — an
    argsort here is a full sort network, ~300 ms at E=2M vs ~10 ms for the
    scatter form. Emitted rows shorter than min_len are dropped at
    evacuation (the host filters them anyway — _merge_filter semantics):
    measured on 101 bp data ~99% of raw emissions are sub-min_len, so the
    filter keeps the accumulator ~100x smaller."""
    (ik0, ik1, ik2, live, i_e, info, lane2d, minv_e, bound,
     emitted, em_start) = st
    S = 8
    W = ik0.shape[1]
    E = S * W
    W2 = newE // S
    liveb = live.reshape(E) != I0
    pos_live = jnp.cumsum(liveb.astype(jnp.int32)) - I1
    n_live = jnp.sum(liveb, dtype=jnp.int32)
    dest_live = jnp.where(liveb, pos_live, np.int32(newE))  # drop overflow
    # evacuate emitted rows (chronological == slot order per lane)
    em = (emitted.reshape(E) != I0) \
        & ((info.reshape(E) - em_start.reshape(E)) >= min_len)
    pos_em = jnp.cumsum(em.astype(jnp.int32)) - I1
    n_em = jnp.sum(em, dtype=jnp.int32)
    rows = jnp.stack([ik0.reshape(E), ik1.reshape(E), ik2.reshape(E),
                      em_start.reshape(E), info.reshape(E),
                      lane2d.reshape(E)], axis=1).astype(acc.dtype)
    MAXM = acc.shape[0]
    dest_em = jnp.where(em, pos_em + acc_off, np.int32(MAXM))
    acc = acc.at[dest_em].set(rows, mode="drop")
    new_off = acc_off + n_em
    overflow = (n_live > np.int32(newE)) | (new_off > np.int32(MAXM))

    def put2(x, fill=I0):
        flat = jnp.full(newE, fill, x.dtype).at[dest_live].set(
            x.reshape(E), mode="drop")
        return flat.reshape(S, W2)

    ik0, ik1, ik2 = put2(ik0), put2(ik1), put2(ik2)
    live2 = put2(live)
    i_e, info, minv_e = put2(i_e), put2(info), put2(minv_e)
    lane2 = put2(lane2d, fill=np.int32(NL))
    # rebuild the lane-boundary mask (slots changed; compaction is stable,
    # so lanes stay contiguous): start = lane differs from predecessor
    bound2 = (lane2 != _prev_slot(lane2, np.int32(-1))).astype(jnp.int32)
    st2 = (ik0, ik1, ik2, live2, i_e, info, lane2, minv_e, bound2,
           jnp.zeros((S, W2), jnp.int32), jnp.zeros((S, W2), jnp.int32))
    return st2, acc, new_off, overflow


@functools.partial(jax.jit, static_argnums=(1,))
def pack_emitted8(st, E: int):
    """Append the tail's in-slot emissions to the accumulator contract:
    (E, 6) int32 rows (ik0, ik1, ik2, start, info_end, lane) + count."""
    (ik0, ik1, ik2, live, i_e, info, lane2d, minv_e, bound,
     emitted, em_start) = st
    em = emitted.reshape(E) != I0
    pos = jnp.cumsum(em.astype(jnp.int32)) - I1
    n = jnp.sum(em, dtype=jnp.int32)
    cols = jnp.stack([ik0.reshape(E), ik1.reshape(E), ik2.reshape(E),
                      em_start.reshape(E), info.reshape(E),
                      lane2d.reshape(E)], axis=1)
    out = jnp.zeros((E, 6), cols.dtype).at[
        jnp.where(em, pos, np.int32(E))].set(cols, mode="drop")
    return out, n


@functools.partial(jax.jit, static_argnums=(3,))
def _merge_filter(acc, acc_off, tail_cols, n_tail_cap: int, n_tail,
                  min_len):
    """Concatenate accumulator + tail emissions and keep only mems of
    length >= min_len (the host drops shorter ones immediately —
    device_seed.py pass filters — so they need not cross the link).
    Order within a lane is preserved. Returns (rows, count)."""
    allr = jnp.concatenate([acc, tail_cols[:n_tail_cap]], axis=0)
    N = allr.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    MAXM = acc.shape[0]
    valid = (idx < acc_off) | ((idx >= np.int32(MAXM))
                               & (idx < np.int32(MAXM) + n_tail))
    keep = valid & ((allr[:, 4] - allr[:, 3]) >= min_len)
    pos = jnp.cumsum(keep.astype(jnp.int32)) - I1
    out = jnp.zeros_like(allr).at[
        jnp.where(keep, pos, np.int32(N))].set(allr, mode="drop")
    return out, jnp.sum(keep, dtype=jnp.int32)


def run_backward8(fm, qrows_dev, entry_dev, n_lanes, x0_np, minv_np,
                  min_len=0, raw=False, est_rows=0, _force_adaptive=False,
                  extra_ov=None):
    """Driver matching seeding_flat.run_backward_flat's contract, except
    x[1] of the returned mems is the un-extended forward value (see module
    docstring, fact 3) and mems shorter than min_len are dropped on device
    (callers filter them immediately anyway). Returns (per-lane mem lists,
    overflow (NL,) bool) — overflow True for ALL lanes when a static
    shrink didn't fit (the caller redoes the group on the exact engine).

    raw=True: returns ((n, 6) int32 rows [x0, x1, x2, start, end, lane],
    overflow bool) and no per-row Python — the arrays-end-to-end fast
    path. When est_rows > 0, a [n | overflow] header row is prepended to
    the row buffer device-side and the first 1 + est_rows rows ride ONE
    speculative pull (typical row yield is ~0.1/lane, so a generous
    estimate still moves ~25 B/lane); only an underestimate pays a second
    pull for the full prefix."""
    tables = fm.o2_tables()
    NL, L = int(qrows_dev.shape[0]), int(qrows_dev.shape[1])
    ik_d, info_d, lane_d, live_d = entry_dev
    E = int(ik_d.shape[0])
    S = 8
    assert E % S == 0
    W = E // S

    # positions (ik0/ik1, L2, primary) ride the index dtype — int64 for
    # doubled genomes >= 2^31 (GRCh38 scale); sizes/counts stay int32
    idt, np_idt = fm.idt, fm.np_idt
    l2p = jnp.asarray(np.concatenate(
        [np.asarray(fm.L2)[:4].astype(np.int64),
         [fm.primary, 0, 0, 0]]).astype(np_idt))
    qflat = qrows_dev.reshape(-1).astype(jnp.int32)
    lane_flat = lane_d.astype(jnp.int32)
    live_flat = live_d.astype(jnp.int32)
    lane_masked = jnp.where(live_flat != I0, lane_flat, np.int32(NL))
    lane2d = lane_masked.reshape(S, W)
    lane_c2d = jnp.clip(lane_flat, 0, NL - 1).reshape(S, W)
    # x0/minv may arrive as device arrays (sync-free callers build the
    # lane tables on device) or as host numpy
    x0_d = (x0_np.astype(jnp.int32) if isinstance(x0_np, jnp.ndarray)
            else jnp.asarray(x0_np.astype(np.int32)))
    minv_d = (minv_np.astype(jnp.int32) if isinstance(minv_np, jnp.ndarray)
              else jnp.asarray(minv_np.astype(np.int32)))
    # lane-boundary mask for the neighbor first-live logic (_round8):
    # lanes are laid out contiguously by assemble_entries, dead padding
    # only at the global tail (lane == NL there)
    bound0 = (lane2d != _prev_slot(lane2d, np.int32(-1))).astype(jnp.int32)
    st = (
        ik_d[:, 0].astype(idt).reshape(S, W),
        ik_d[:, 1].astype(idt).reshape(S, W),
        ik_d[:, 2].astype(jnp.int32).reshape(S, W),
        live_flat.reshape(S, W),
        (x0_d[lane_c2d.reshape(E)].reshape(S, W) - 1),
        info_d.astype(jnp.int32).reshape(S, W),
        lane2d,
        minv_d[lane_c2d.reshape(E)].reshape(S, W),
        bound0,
        jnp.zeros((S, W), jnp.int32),
        jnp.zeros((S, W), jnp.int32),
    )

    import os as _os
    import time as _time

    dbg = _os.environ.get("MPIBWA_BWD_DEBUG") == "1"
    prof = TIMES if _os.environ.get("MPIBWA_BWD_STATS") == "1" else None
    # The evac-time min_len filter drops ~99% of raw emissions on short-read
    # data; with no filter (min_len == 0) every emission lands in the
    # accumulator, so size it for the worst case to avoid overflow cliffs.
    MAXM = max(65536, E) if min_len <= 0 else max(65536, E // 8)
    acc = jnp.zeros((MAXM, 6), idt)
    acc_off = jnp.int32(0)
    ov_flags = []
    ml = jnp.int32(min_len)
    cap = E
    seg = 0
    # Capacity schedule: on the FIRST run of a shape, adapt — after each
    # segment, pull the live count (4 bytes; live only ever decreases) and
    # shrink to its ladder bucket. Record the margined capacities in
    # SCHED_CACHE; every later run of the shape REPLAYS them with no syncs
    # at all (each sync is a host round trip).
    # A replayed shrink that would drop live entries flips the device
    # overflow flag -> invalidate + redo adaptively below.
    max_segs = (int(qrows_dev.shape[1]) + 2) // SEG_ROUNDS + 2
    t0 = _time.time() if prof is not None else 0.0
    n_segs = 0
    skey = (E, L, NL, int(min_len))
    sched = None if _force_adaptive else SCHED_CACHE.get(skey)
    static_mode = sched is not None
    if static_mode:
        # sync-free replay of the learned capacities: the segment/shrink
        # dispatches queue asynchronously (the only blocking point is the
        # result pull), and every shape was already compiled by the
        # adaptive first run. (A fully-fused one-dispatch variant was
        # measured: ~20 s extra remote compile per schedule with no
        # steady-state gain — async dispatch already hides the per-call
        # latency — so the loop form stays.)
        for i, newE in enumerate(sched):
            rounds = SEG_ROUNDS + 1 if i == 0 else SEG_ROUNDS
            st = segment8(tables, l2p, qflat, st, L, NL, rounds)
            n_segs += 1
            if newE < cap:
                st, acc, acc_off, ov = shrink8(st, acc, acc_off, newE, NL,
                                               ml)
                ov_flags.append(ov)
                cap = newE
    else:  # adaptive first run of this shape: record the schedule
        trace = []
        while cap > MIN_CAP and seg < max_segs:
            rounds = SEG_ROUNDS + 1 if seg == 0 else SEG_ROUNDS
            st = segment8(tables, l2p, qflat, st, L, NL, rounds)
            n_live = int(jnp.sum(st[3]))
            n_segs += 1
            trace.append(n_live)
            if n_live == 0:
                break
            newE = min(cap_bucket(n_live), cap)
            if newE < cap:
                st, acc, acc_off, ov = shrink8(st, acc, acc_off, newE, NL,
                                               ml)
                ov_flags.append(ov)
                if dbg:
                    import sys as _sys

                    print(f"  v8 seg{seg}: cap {cap}->{newE} live={n_live} "
                          f"acc={int(acc_off)} ov={bool(ov)}",
                          file=_sys.stderr, flush=True)
                cap = newE
            seg += 1
        caps, c = [], E
        for n_live in trace:
            c = min(cap_bucket(max(int(n_live * SCHED_MARGIN), 1)), c)
            caps.append(c)
            if c <= MIN_CAP:
                break
        # merge with any prior recording (elementwise upper envelope):
        # group-to-group live counts drift, and alternating tight
        # schedules would thrash overflow-retry; the envelope converges
        old = SCHED_CACHE.get(skey)
        if old:
            n = max(len(old), len(caps))
            o = list(old) + [old[-1]] * (n - len(old))
            m = list(caps) + [caps[-1]] * (n - len(caps))
            caps = []
            c = E
            for a, b in zip(o, m):
                c = min(max(a, b), c)
                caps.append(c)
        SCHED_CACHE[skey] = tuple(caps)
    if prof is not None:
        # stats mode only: block so segs_s measures the queued segment
        # round compute instead of lumping it into tail_s
        jax.block_until_ready(st[0])
        prof["segs_s"] = prof.get("segs_s", 0.0) + _time.time() - t0
        prof["n_segs"] = prof.get("n_segs", 0) + n_segs
        prof["n_calls"] = prof.get("n_calls", 0) + 1
        prof["sum_E"] = prof.get("sum_E", 0) + E
        t0 = _time.time()
    st = tail8(tables, l2p, qflat, st, L, NL)
    cols, n_tail = pack_emitted8(st, cap)
    rows_d, n_keep = _merge_filter(acc, acc_off, cols, cap, n_tail,
                                   jnp.int32(min_len))
    if prof is not None:
        jax.block_until_ready(rows_d)
        prof["tail_s"] = prof.get("tail_s", 0.0) + _time.time() - t0
        t0 = _time.time()

    ov_d = (jnp.any(jnp.stack(ov_flags)) if ov_flags
            else jnp.asarray(False))
    if extra_ov is not None:
        # caller-provided device flag (e.g. a speculative entry capacity
        # that measured too small) — surfaces through the same overflow
        # path; an adaptive retry with the flag still set reports
        # overflow to the caller, which redoes the group exactly
        ov_d = ov_d | extra_ov
    return _finish8(rows_d, n_keep, ov_d, fm, qrows_dev, entry_dev,
                    n_lanes, x0_np, minv_np, min_len, raw, est_rows,
                    static_mode, np_idt, prof, t0, extra_ov)


def _finish8(rows_d, n_keep, ov_d, fm, qrows_dev, entry_dev, n_lanes,
             x0_np, minv_np, min_len, raw, est_rows, static_mode, np_idt,
             prof, t0, extra_ov=None):
    """Shared result/overflow handling for both driver modes: pull the
    merged rows (speculative prefix in raw mode); on overflow, a static
    replay redoes the group adaptively (the rerun envelope-merges this
    group's trace into the schedule so the cache converges upward instead
    of thrashing — results never depend on the learned schedule) while an
    adaptive run reports overflow to the caller (exact-engine redo)."""
    import time as _time

    def _retry_adaptive():
        # extra_ov forwarded: if IT caused the overflow, the adaptive
        # rerun still reports overflow (entries were truncated at
        # assembly; only the caller's exact redo has them all)
        return run_backward8(fm, qrows_dev, entry_dev, n_lanes, x0_np,
                             minv_np, min_len, raw, est_rows,
                             _force_adaptive=True, extra_ov=extra_ov)

    if raw:
        if est_rows > 0:
            hdr = jnp.concatenate(
                [n_keep[None], ov_d.astype(jnp.int32)[None],
                 jnp.zeros(4, jnp.int32)]).astype(rows_d.dtype)[None, :]
            comb = jnp.concatenate([hdr, rows_d], axis=0)
            est = min(int(rows_d.shape[0]), int(est_rows))
            first = pull_prefix(comb, 1 + est)
            n, ov = int(first[0, 0]), bool(first[0, 1])
            if ov:
                if static_mode:
                    return _retry_adaptive()
                return np.zeros((0, 6), np_idt), True
            if n == 0:
                return np.zeros((0, 6), np_idt), False
            if prof is not None:
                prof["pull_s"] = prof.get("pull_s", 0.0) + _time.time() - t0
            if n <= est:
                return first[1 : 1 + n], False
            return pull_prefix(rows_d, n), False
        # one tiny control pull: [n_keep, any-overflow]
        ctrl = np.asarray(jnp.stack([n_keep, ov_d.astype(jnp.int32)]))
        if bool(ctrl[1]):
            if static_mode:
                return _retry_adaptive()
            return np.zeros((0, 6), np_idt), True
        n = int(ctrl[0])
        if n == 0:
            return np.zeros((0, 6), np_idt), False
        return pull_prefix(rows_d, n), False

    overflow = np.zeros(n_lanes, bool)
    if bool(np.asarray(ov_d)):
        if static_mode:
            return _retry_adaptive()
        overflow[:] = True  # rare: redo the whole group exactly
        return [[] for _ in range(n_lanes)], overflow
    n = int(n_keep)
    out_mems = [[] for _ in range(n_lanes)]
    if n:
        rows = pull_prefix(rows_d, n)
        lanes = rows[:, 5]
        infos = (rows[:, 3].astype(np.int64) << 32) | rows[:, 4]
        for j in range(n):
            ln = int(lanes[j])
            if 0 <= ln < n_lanes:
                out_mems[ln].append(
                    (int(rows[j, 0]), int(rows[j, 1]), int(rows[j, 2]),
                     int(infos[j])))
    return out_mems, overflow
