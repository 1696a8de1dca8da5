"""Batched mate-rescue local SW (ksw_align2 / ksw_u8 semantics) on device.

Replicates the striped SSE2 kernel's exact outputs (ksw.c:111-230, 343-365):
the padded-query SW matrix (query padded to slen*16 positions with zero
scores), u8 bias/saturation arithmetic, the per-column second-best tracking
with its contiguous-run merge rule, the min-query-position tie-break for qe,
and the reverse pass that recovers start positions. Sequences never cross
the host link: the mate is gathered from the device read batch (with
optional reverse-complement) and the reference window from the packed pac.

i16-mode problems (long mates, l_ms * a >= 250) are rare for short reads and
fall back to the scalar engine via the cache-miss path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class SWOut(NamedTuple):
    score: jnp.ndarray  # (B,) capped at 255 like u8
    te: jnp.ndarray  # (B,)
    qe: jnp.ndarray  # (B,)
    score2: jnp.ndarray  # (B,)
    te2: jnp.ndarray  # (B,)


def _maxscan_decay(t: jnp.ndarray, decay: int) -> jnp.ndarray:
    n = t.shape[-1]
    out = t
    shift = 1
    while shift < n:
        shifted = jnp.pad(out[..., :-shift],
                          [(0, 0)] * (out.ndim - 1) + [(shift, 0)],
                          constant_values=-(1 << 28))
        out = jnp.maximum(out, shifted - shift * decay)
        shift <<= 1
    return out


@functools.partial(jax.jit, static_argnums=(3, 4, 6, 7, 8, 9, 10, 11, 14))
def striped_sw_u8(fm, qd: jnp.ndarray, qcoords: jnp.ndarray, N: int, T: int,
                  tcoords: jnp.ndarray, o_del: int, e_del: int, o_ins: int,
                  e_ins: int, shift: int, qmax: int,
                  params: jnp.ndarray = None, mat: jnp.ndarray = None,
                  ab=None) -> SWOut:
    """qcoords: (B, 5) int32 (row, start, step, comp, qlen) — query position
    k reads qd[row, start + k*step], complemented (3-x, N stays) if comp.
    tcoords: (B, 3) int32/int64 (t_start, t_step, t_len) over doubled
    reference coordinates. params: (B, 2) int32 (minsc, endsc).
    N: padded query capacity (multiple of 16 covering slen*16); T: padded
    target capacity. shift = 256 - min(mat) (mod 256); qmax = max(mat)."""
    B = qcoords.shape[0]
    row = qcoords[:, 0]
    qstart = qcoords[:, 1]
    qstep = qcoords[:, 2]
    qcomp = qcoords[:, 3] != 0
    qlen = qcoords[:, 4]
    minsc = params[:, 0]
    endsc = params[:, 1]
    L = qd.shape[1]

    # padded query per the striped layout: nlen = ceil(qlen/16)*16
    nlen = ((qlen + 15) >> 4) << 4
    k = jnp.arange(N, dtype=jnp.int32)[None, :]
    qpos = qstart[:, None] + k * qstep[:, None]
    qraw = qd[row[:, None], jnp.clip(qpos, 0, L - 1)].astype(jnp.int32)
    qraw = jnp.where(qcomp[:, None] & (qraw < 4), 3 - qraw, qraw)
    qvalid = k < qlen[:, None]
    qb = jnp.where(qvalid, qraw, 0)  # base value for padding is irrelevant

    tstart = tcoords[:, 0].astype(jnp.int64)
    tstep = tcoords[:, 1].astype(jnp.int64)
    tlen = tcoords[:, 2].astype(jnp.int32)

    rows = jnp.arange(B)
    state = dict(
        H=jnp.zeros((B, N), jnp.int32),
        E=jnp.zeros((B, N), jnp.int32),
        Hmax=jnp.zeros((B, N), jnp.int32),
        gmax=jnp.zeros(B, jnp.int32),
        te=jnp.full(B, -1, jnp.int32),
        colmax=jnp.zeros((B, T), jnp.int32),
        broken=tlen <= 0,
    )
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins

    def body(i, st):
        act = ~st["broken"] & (i < tlen)
        tpos = tstart + i * tstep
        tb = fm.ref_base(jnp.clip(tpos, 0, 2 * fm.l_pac - 1))  # (B,)
        if ab is not None:
            # standard matrix: fused selects instead of the (B, N) gather
            S = jnp.where((tb[:, None] < 4) & (qraw < 4),
                          jnp.where(tb[:, None] == qraw,
                                    jnp.int32(ab[0]), jnp.int32(-ab[1])),
                          jnp.int32(-1))
        else:
            S = mat[tb[:, None], qb]  # (B, N)
        S = jnp.where(qvalid & (k < nlen[:, None]), S, 0)  # padding scores 0
        Hd = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), st["H"][:, :-1]],
                             axis=1)
        # u8: max(min(Hdiag + S + shift, 255) - shift, 0)
        hm = jnp.maximum(jnp.minimum(Hd + S + shift, 255) - shift, 0)
        Hnf = jnp.maximum(hm, st["E"])
        Tm = jnp.maximum(Hnf - oe_ins, 0)
        scan = _maxscan_decay(Tm, e_ins)
        F = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), scan[:, :-1]],
                            axis=1)
        lanemask = k < nlen[:, None]
        Hrow = jnp.where(lanemask, jnp.maximum(Hnf, F), 0)
        newE = jnp.where(lanemask, jnp.maximum(
            jnp.maximum(st["E"] - e_del, 0),
            jnp.maximum(Hrow - oe_del, 0)), 0)
        imax = jnp.max(Hrow, axis=1)
        better = act & (imax > st["gmax"])
        H = jnp.where(act[:, None], Hrow, st["H"])
        E = jnp.where(act[:, None], newE, st["E"])
        Hmax = jnp.where(better[:, None], Hrow, st["Hmax"])
        gmax = jnp.where(better, imax, st["gmax"])
        te = jnp.where(better, i, st["te"])
        colmax = st["colmax"].at[:, jnp.minimum(i, T - 1)].set(
            jnp.where(act, imax, st["colmax"][:, jnp.minimum(i, T - 1)]))
        brk = st["broken"] | (better & ((gmax + shift >= 255)
                                        | (gmax >= endsc)))
        return dict(H=H, E=E, Hmax=Hmax, gmax=gmax, te=te, colmax=colmax,
                    broken=brk)

    state = jax.lax.fori_loop(0, jnp.max(tlen), body, state)

    gmax = state["gmax"]
    te = state["te"]
    score = jnp.where(gmax + shift < 255, gmax, 255)
    # qe: min query position among the argmax of Hmax (padding included)
    Hmax = state["Hmax"]
    mx = jnp.max(Hmax, axis=1)
    qe = jnp.min(jnp.where(Hmax == mx[:, None], k, N), axis=1)
    qe = jnp.where(score != 255, qe, -1)

    # score2: the b-array records entries over rows with colmax >= minsc
    # (ksw.c:192-199). The entry's index advances only on STRICT improvement,
    # and the "contiguous" check compares that index + 1 against the current
    # row — so a plateau of two rows splits entries. Exact emulation: a row
    # is "absorbed" (no new entry, no update) iff it doesn't start an entry
    # and doesn't improve on the previous row; a row starts an entry iff the
    # run starts there or the previous row was absorbed. The absorbed bit is
    # a flip-flop (absorbed[i] = d[i] & ~absorbed[i-1], d = non-start and
    # non-improving), computed as an associative boolean-function scan.
    cm = state["colmax"]
    tidx = jnp.arange(T, dtype=jnp.int32)[None, :]
    inb = (cm >= minsc[:, None]) & (tidx < tlen[:, None])
    run_start = inb & jnp.concatenate(
        [jnp.ones((B, 1), bool), ~inb[:, :-1]], axis=1)
    prev_cm = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), cm[:, :-1]],
                              axis=1)
    d = inb & ~run_start & (cm <= prev_cm)
    # function composition scan: element is const0 (d=0) or NOT (d=1),
    # encoded as (f(0), f(1))
    f0 = d  # d=0 -> (0,0); d=1 -> (1,0)
    f1 = jnp.zeros_like(d)

    def comb_fn(a, b):
        a0, a1 = a
        b0, b1 = b
        return jnp.where(a0, b1, b0), jnp.where(a1, b1, b0)

    g0, _ = jax.lax.associative_scan(comb_fn, (f0, f1), axis=1)
    absorbed = g0  # applied to initial state 0
    start_e = inb & (run_start | jnp.concatenate(
        [jnp.zeros((B, 1), bool), absorbed[:, :-1]], axis=1))
    entry_rows = inb & ~absorbed

    def comb_max(a, b):
        av, ar = a
        bv, br = b
        return jnp.where(br, bv, jnp.maximum(av, bv)), ar | br

    # per entry-segment: value and index of the last non-absorbed row
    NEG1 = jnp.full_like(cm, -1)
    segval, _ = jax.lax.associative_scan(
        comb_max, (jnp.where(entry_rows, cm, NEG1), start_e), axis=1)
    segidx, _ = jax.lax.associative_scan(
        comb_max, (jnp.where(entry_rows, tidx, NEG1), start_e), axis=1)
    # segment end: position before the next entry start (or run/row end)
    nxt_start = jnp.concatenate([start_e[:, 1:], jnp.zeros((B, 1), bool)],
                                axis=1)
    nxt_inb = jnp.concatenate([inb[:, 1:], jnp.zeros((B, 1), bool)], axis=1)
    seg_end = inb & (nxt_start | ~nxt_inb)
    win = (score + qmax - 1) // qmax
    low = te - win
    high = te + win
    qual = seg_end & ((segidx < low[:, None]) | (segidx > high[:, None]))
    score2 = jnp.max(jnp.where(qual, segval, -1), axis=1)
    te2 = -1 * jnp.ones_like(score2)  # te2 unused downstream (csub only)
    # C only fills score2 when score != 255 and b-array nonempty
    score2 = jnp.where(score != 255, score2, -1)
    return SWOut(score, te, qe, score2, te2)


_PACK_SW = []


def _pack_sw(o):
    import jax

    if not _PACK_SW:
        @jax.jit
        def pack(a, b, c, d):
            return jnp.stack([a.astype(jnp.int32), b.astype(jnp.int32),
                              c.astype(jnp.int32), d.astype(jnp.int32)],
                             axis=0)

        _PACK_SW.append(pack)
    return _PACK_SW[0](o.score, o.te, o.qe, o.score2)


def ksw_align2_batch(fm, qd, problems, opt, N: int, T: int):
    """Full ksw_align2 (forward + reverse pass) for a list of u8 problems.

    problems: list of dicts with qcoords (row, start, step, comp, qlen) and
    tcoords (t_start, t_step, t_len); all share xtra =
    XSUBO|XSTART|XBYTE|minsc (mem_matesw, bwamem_pair.c:150).
    Returns list of (score, te, qe, score2, te2, tb, qb)."""
    B = len(problems)
    if B == 0:
        return []
    m5 = opt.mat.reshape(5, 5)
    shift = (256 - int(m5.min())) & 0xFF
    qmax = int(m5.max())
    minsc = opt.min_seed_len * opt.a
    Bp = 1 << max(4, (B - 1).bit_length())
    qc = np.zeros((Bp, 5), np.int32)
    tc = np.zeros((Bp, 3), np.int64)
    pr = np.zeros((Bp, 2), np.int32)
    qc[:, 4] = 1
    for i, p in enumerate(problems):
        qc[i] = p["qcoords"]
        tc[i] = p["tcoords"]
        pr[i] = (minsc, 0x10000)
    mat = jnp.asarray(m5.astype(np.int32))
    from mpibwa_tpu.ops.extend_batch import standard_mat_ab

    ab = standard_mat_ab(opt.mat)
    fwd = striped_sw_u8(fm, qd, jnp.asarray(qc), N, T, jnp.asarray(tc),
                        opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, shift,
                        qmax, jnp.asarray(pr), mat, ab)
    packed = np.asarray(_pack_sw(fwd))  # one device->host pull
    score = packed[0, :B]
    te = packed[1, :B]
    qe = packed[2, :B]
    score2 = packed[3, :B]
    out = []
    # reverse pass for problems with score >= minsc (the caller discards the
    # rest, and ksw_align2 skips XSTART when XSUBO && score < minsc)
    rev_idx = [i for i in range(B)
               if score[i] >= minsc and score[i] != 255 and qe[i] >= 0]
    rev_res = {}
    if rev_idx:
        B2 = len(rev_idx)
        B2p = 1 << max(4, (B2 - 1).bit_length())
        qc2 = np.zeros((B2p, 5), np.int32)
        tc2 = np.zeros((B2p, 3), np.int64)
        pr2 = np.zeros((B2p, 2), np.int32)
        qc2[:, 4] = 1
        for j, i in enumerate(rev_idx):
            r0, st, sp, cp, _ = qc[i]
            qc2[j] = (r0, st + qe[i] * sp, -sp, cp, qe[i] + 1)
            ts0, tsp, _ = tc[i]
            tc2[j] = (ts0 + te[i] * tsp, -tsp, te[i] + 1)
            pr2[j] = (0x10000, score[i])  # KSW_XSTOP | r.score
        rev = striped_sw_u8(fm, qd, jnp.asarray(qc2), N, T, jnp.asarray(tc2),
                            opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, shift,
                            qmax, jnp.asarray(pr2), mat, ab)
        rpk = np.asarray(_pack_sw(rev))  # one pull
        rsc = rpk[0, :B2]
        rte = rpk[1, :B2]
        rqe = rpk[2, :B2]
        for j, i in enumerate(rev_idx):
            rev_res[i] = (rsc[j], rte[j], rqe[j])
    for i in range(B):
        tb = qb = -1
        if i in rev_res and rev_res[i][0] == score[i]:
            tb = int(te[i] - rev_res[i][1])
            qb = int(qe[i] - rev_res[i][2])
        out.append((int(score[i]), int(te[i]), int(qe[i]), int(score2[i]),
                    -1, tb, qb))
    return out
