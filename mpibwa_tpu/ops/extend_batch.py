"""Batched banded seed-extension DP (ksw_extend2 semantics) on device.

One program per (extension problem) lane; rows of the DP are computed with
full-width vector ops because E(i+1,j) and F(i,j+1) derive from M(i,j) of the
previous row (ksw.c:424-448) — F is a max-plus prefix scan over the row's M.
Band narrowing, the eh[end] boundary writes, z-drop, the m==0 break and the
gscore-at-qlen tracking replicate the scalar semantics exactly (see
core/extend.py, which this kernel is differentially tested against).

Scores are int32 (bounded by read length * match score); positions int32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = -(1 << 28)


def _maxscan_decay(t: jnp.ndarray, decay: jnp.ndarray) -> jnp.ndarray:
    """out[..., j] = max_{k<=j} (t[..., k] - (j-k)*decay) along last axis."""
    n = t.shape[-1]
    out = t
    shift = 1
    while shift < n:
        shifted = jnp.pad(out[..., :-shift], [(0, 0)] * (out.ndim - 1) + [(shift, 0)],
                          constant_values=NEG)
        out = jnp.maximum(out, shifted - shift * decay[..., None])
        shift <<= 1
    return out


def standard_mat_ab(mat) -> "tuple[int, int] | None":
    """If mat is the bwa_fill_scmat(a, b) shape, return (a, b); else None."""
    m = np.asarray(mat).reshape(5, 5).astype(np.int64)
    a = int(m[0, 0])
    b = int(-m[0, 1])
    want = np.full((5, 5), -1, np.int64)
    for i in range(4):
        for j in range(4):
            want[i, j] = a if i == j else -b
    if np.array_equal(m, want):
        return a, b
    return None


class ExtendOut(NamedTuple):
    score: jnp.ndarray
    qle: jnp.ndarray
    tle: jnp.ndarray
    gtle: jnp.ndarray
    gscore: jnp.ndarray
    max_off: jnp.ndarray


@functools.partial(jax.jit, static_argnums=(6, 7, 8, 9))
def extend_batch(qs: jnp.ndarray, ts: jnp.ndarray, qlens: jnp.ndarray,
                 tlens: jnp.ndarray, params: jnp.ndarray, mat: jnp.ndarray,
                 o_del: int, e_del: int, o_ins: int, e_ins: int) -> ExtendOut:
    """qs: (B, Q) uint8 query (nt4, pad 4); ts: (B, T) uint8 target;
    qlens/tlens: (B,) int32; params: (B, 4) int32 columns
    (w, end_bonus, zdrop, h0); mat: (5, 5) int32 scoring matrix."""
    B, Q = qs.shape
    T = ts.shape[1]
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    w_in = params[:, 0]
    end_bonus = params[:, 1]
    zdrop = params[:, 2]
    h0 = params[:, 3]

    # per-problem score rows: s[b, i, j] = mat[ts[b,i], qs[b,j]] is too big to
    # materialize; gather one row per step instead.
    jidx = jnp.arange(Q, dtype=jnp.int32)

    # first-row fill (ksw.c:395-397): eh_h[0]=h0; eh_h[1]=max(h0-oe_ins,0);
    # eh_h[j] = eh_h[j-1]-e_ins while previous > e_ins
    ehh1 = jnp.maximum(h0 - oe_ins, 0)
    # closed form: for j>=1, v_j = ehh1 - (j-1)*e_ins while chain positive
    jj = jnp.arange(1, Q + 1, dtype=jnp.int32)
    chain_val = ehh1[:, None] - (jj[None, :] - 1) * e_ins
    # valid while eh_h[j-1] > e_ins, i.e. chain_val[j-1] > e_ins for j>=2
    ok_prev = jnp.concatenate(
        [jnp.ones((B, 1), bool), chain_val[:, :-1] > e_ins], axis=1)
    ok_chain = jnp.cumprod(ok_prev.astype(jnp.int32), axis=1).astype(bool)
    first_row = jnp.where(ok_chain & (jj[None, :] <= qlens[:, None]),
                          jnp.maximum(chain_val, 0), 0)
    eh_h0 = jnp.concatenate([h0[:, None], first_row], axis=1)  # (B, Q+1)
    eh_e0 = jnp.zeros((B, Q + 1), jnp.int32)

    # band clamp (ksw.c:399-407)
    mmax = jnp.max(mat)
    max_ins = ((qlens * mmax + end_bonus - o_ins).astype(jnp.float64)
               / e_ins + 1.0).astype(jnp.int32)
    max_ins = jnp.maximum(max_ins, 1)
    w = jnp.minimum(w_in, max_ins)
    max_del = ((qlens * mmax + end_bonus - o_del).astype(jnp.float64)
               / e_del + 1.0).astype(jnp.int32)
    max_del = jnp.maximum(max_del, 1)
    w = jnp.minimum(w, max_del)

    state = dict(
        eh_h=eh_h0, eh_e=eh_e0,
        beg=jnp.zeros(B, jnp.int32), end=qlens.astype(jnp.int32),
        maxv=h0.astype(jnp.int32),
        max_i=jnp.full(B, -1, jnp.int32), max_j=jnp.full(B, -1, jnp.int32),
        max_ie=jnp.full(B, -1, jnp.int32), gscore=jnp.full(B, -1, jnp.int32),
        max_off=jnp.zeros(B, jnp.int32),
        broken=tlens <= 0,
    )
    rows = jnp.arange(B)

    def body(i, st):
        act = ~st["broken"] & (i < tlens)
        beg = jnp.maximum(st["beg"], i - w)
        end = jnp.minimum(jnp.minimum(st["end"], i + w + 1), qlens)
        empty = beg >= end
        act2 = act & ~empty

        tb = ts[rows, jnp.minimum(i, T - 1)].astype(jnp.int32)  # target base
        srow = mat[tb[:, None], qs.astype(jnp.int32)]  # (B, Q)
        live = (jidx[None, :] >= beg[:, None]) & (jidx[None, :] < end[:, None])

        h1_first = jnp.where(beg == 0,
                             jnp.maximum(h0 - (o_del + e_del * (i + 1)), 0), 0)
        Hprev = st["eh_h"][:, :Q]  # H(i-1, j-1) at cell j
        E = st["eh_e"][:, :Q]
        M = jnp.where(Hprev != 0, Hprev + srow, 0)
        Tm = jnp.where(live, jnp.maximum(M - oe_ins, 0), NEG)
        scan = _maxscan_decay(Tm, jnp.full(B, e_ins, jnp.int32))
        Fs = jnp.concatenate([jnp.full((B, 1), NEG, jnp.int32), scan[:, :-1]],
                             axis=1)
        F = jnp.where(jidx[None, :] == beg[:, None], 0, Fs)
        H = jnp.maximum(jnp.maximum(M, E), F)
        H = jnp.where(live, H, 0)
        m = jnp.max(jnp.where(live, H, -1), axis=1)
        m = jnp.maximum(m, 0) * (end > beg)  # m=0 when no live cells
        is_max = live & (H == m[:, None]) & (m[:, None] > 0)
        mj = jnp.max(jnp.where(is_max, jidx[None, :], -1), axis=1)
        newE = jnp.maximum(jnp.maximum(M - oe_del, 0), E - e_del)

        # row writes (only for active lanes)
        upd = act2
        # eh_h[j] for j in [beg+1, end]: H shifted right by one; eh_h[beg]=h1_first
        H_sh = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), H], axis=1)  # (B,Q+1)
        write_h = (jnp.arange(Q + 1)[None, :] > beg[:, None]) & \
                  (jnp.arange(Q + 1)[None, :] <= end[:, None])
        new_eh_h = jnp.where(write_h & upd[:, None], H_sh, st["eh_h"])
        new_eh_h = jnp.where(
            (jnp.arange(Q + 1)[None, :] == beg[:, None]) & upd[:, None],
            h1_first[:, None], new_eh_h)
        write_e = (jnp.arange(Q + 1)[None, :] >= beg[:, None]) & \
                  (jnp.arange(Q + 1)[None, :] < end[:, None])
        newE_pad = jnp.concatenate([newE, jnp.zeros((B, 1), jnp.int32)], axis=1)
        new_eh_e = jnp.where(write_e & upd[:, None], newE_pad, st["eh_e"])
        new_eh_e = jnp.where(
            (jnp.arange(Q + 1)[None, :] == end[:, None]) & upd[:, None],
            0, new_eh_e)

        h1_last = jnp.where(end > beg,
                            H[rows, jnp.maximum(end - 1, 0)], h1_first)
        # gscore at full query (ksw.c:450-453)
        at_q = act2 & (end == qlens)
        upd_ie = at_q & ~(st["gscore"] > h1_last)
        new_max_ie = jnp.where(upd_ie, i, st["max_ie"])
        new_gscore = jnp.where(at_q, jnp.maximum(st["gscore"], h1_last),
                               st["gscore"])

        zero_m = act2 & (m == 0)
        better = act2 & ~zero_m & (m > st["maxv"])
        new_maxv = jnp.where(better, m, st["maxv"])
        new_max_i = jnp.where(better, i, st["max_i"])
        new_max_j = jnp.where(better, mj, st["max_j"])
        new_max_off = jnp.where(better,
                                jnp.maximum(st["max_off"], jnp.abs(mj - i)),
                                st["max_off"])
        # z-drop (ksw.c:458-463) for non-improving rows
        di = i - st["max_i"]
        dj = mj - st["max_j"]
        zd1 = st["maxv"] - m - (di - dj) * e_del > zdrop
        zd2 = st["maxv"] - m - (dj - di) * e_ins > zdrop
        zbreak = act2 & ~zero_m & ~better & (zdrop > 0) & \
            jnp.where(di > dj, zd1, zd2)

        # band trimming over the UPDATED eh arrays (ksw.c:466-469)
        nz = (new_eh_h != 0) | (new_eh_e != 0)  # (B, Q+1)
        jr = jnp.arange(Q + 1, dtype=jnp.int32)[None, :]
        in_range = (jr >= beg[:, None]) & (jr < end[:, None])
        first_nz = jnp.min(jnp.where(in_range & nz[:, :Q + 1], jr, Q + 1), axis=1)
        new_beg = jnp.minimum(first_nz, end)
        in_range2 = (jr >= new_beg[:, None]) & (jr <= end[:, None])
        last_nz = jnp.max(jnp.where(in_range2 & nz, jr, new_beg[:, None] - 1),
                          axis=1)
        new_end = jnp.minimum(last_nz + 2, qlens)

        brk = st["broken"] | zero_m | zbreak | (act & empty)
        keep = act2
        st = dict(
            eh_h=new_eh_h, eh_e=new_eh_e,
            beg=jnp.where(keep, new_beg, st["beg"]),
            end=jnp.where(keep, new_end, st["end"]),
            maxv=jnp.where(keep, new_maxv, st["maxv"]),
            max_i=jnp.where(keep, new_max_i, st["max_i"]),
            max_j=jnp.where(keep, new_max_j, st["max_j"]),
            max_ie=jnp.where(keep, new_max_ie, st["max_ie"]),
            gscore=jnp.where(keep, new_gscore, st["gscore"]),
            max_off=jnp.where(keep, new_max_off, st["max_off"]),
            broken=brk,
        )
        return st

    def cond(carry):
        i, st = carry
        return jnp.any(~st["broken"] & (i < tlens))

    def loop_body(carry):
        i, st = carry
        return i + 1, body(i, st)

    _, state = jax.lax.while_loop(cond, loop_body, (jnp.int32(0), state))
    return ExtendOut(state["maxv"], state["max_j"] + 1, state["max_i"] + 1,
                     state["max_ie"] + 1, state["gscore"], state["max_off"])


@functools.partial(jax.jit, static_argnums=(3, 4, 6, 7, 8, 9))
def extend_from_coords(fm, qd: jnp.ndarray, coords: jnp.ndarray, Q: int,
                       T: int, params: jnp.ndarray, o_del: int, e_del: int,
                       o_ins: int, e_ins: int, mat: jnp.ndarray) -> ExtendOut:
    """Build extension problems on device from coordinates and run the DP;
    returns an ExtendOut of (B,) arrays.

    qd: (NR, L) uint8 read batch (device-resident); coords: (B, 6) int32
    columns (row, q_off, q_len, q_rev, r_start, t_len) where the query is
    qd[row, q_off : q_off+q_len] (reversed if q_rev) and the target is
    t_len reference bases from doubled-coordinate r_start, walking DOWN
    from r_start-1 when q_rev (left extension mirrors both sequences,
    bwamem.c:716-722). params: (B, 4) int32 (w, end_bonus, zdrop, h0).
    Only coordinates cross the host link; sequences are gathered from the
    device-resident read batch and packed reference."""
    # coords may be int64 (r_start is a doubled reference coordinate, which
    # exceeds int32 on human-scale genomes); the small columns feed int32
    # kernel state
    row = coords[:, 0].astype(jnp.int32)
    q_off = coords[:, 1].astype(jnp.int32)
    q_len = coords[:, 2].astype(jnp.int32)
    q_rev = coords[:, 3] != 0
    r_start = coords[:, 4].astype(jnp.int64)
    t_len = coords[:, 5].astype(jnp.int32)
    L = qd.shape[1]
    jq = jnp.arange(Q, dtype=jnp.int32)[None, :]
    qpos = jnp.where(q_rev[:, None], q_off[:, None] + q_len[:, None] - 1 - jq,
                     q_off[:, None] + jq)
    qvalid = jq < q_len[:, None]
    qs = jnp.where(qvalid,
                   qd[row[:, None], jnp.clip(qpos, 0, L - 1)], jnp.uint8(4))
    jt = jnp.arange(T, dtype=jnp.int32)[None, :]
    tpos = jnp.where(q_rev[:, None],
                     r_start[:, None] - 1 - jt, r_start[:, None] + jt)
    tvalid = jt < t_len[:, None]
    ts = jnp.where(tvalid,
                   fm.ref_base(jnp.clip(tpos, 0, 2 * fm.l_pac - 1))
                   .astype(jnp.uint8), jnp.uint8(4))
    return extend_batch(qs, ts, q_len, t_len, params, mat,
                        o_del, e_del, o_ins, e_ins)
