"""Batched SMEM seeding automata (device, JAX).

Re-expression of mem_collect_intv's three passes (bwamem.c:114-162) as
lockstep batched automata:

- Forward pass (bwt_smem1a forward loop, bwt.c:304-321, max_intv==0): one
  interval-extension step per iteration for a whole batch of reads. Because
  bwt_smem1's return value (the next start position) is the info of the LAST
  interval pushed by the forward loop, the chained sequence of per-read
  smem1 calls is determined by forward extension alone — the backward phase
  never feeds back into it. This is what makes the two-phase batching exact.
- Backward pass (bwt.c:326-345): lanes are (read, call) pairs; each step
  extends the whole surviving interval list of every lane at once. The C
  inner j-loop collapses to vector ops: a mem is emitted iff the FIRST
  (longest-match) entry fails extension, and the surviving list is the
  extension results with consecutive duplicate sizes collapsed.
- Pass 3 (bwt_seed_strategy1, bwt.c:358-379): forward-only automaton.

Fixed-capacity buffers with overflow flags; overflowing reads fall back to
the scalar host path (exactness preserved, rare in practice).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .fmd import DeviceFMIndex

# Buffer caps: a read that overflows one goes to the exact host engine, so
# they never change output. Sized on the previous accelerator; untuned on
# the H100.
F_CAP = 192  # max forward-pushed intervals per read (all calls)
C_CAP = 48  # max smem1 calls per read
P_CAP = 16  # fast-tier interval width for the backward step (99%+ of calls)
P_BIG = 48  # wide tier for repeat-rich calls; beyond this -> host fallback
M_CAP = 64  # max mems per (read, call)
S3_CAP = 24  # max pass-3 seeds per read


class FwdOut(NamedTuple):
    ivals: jnp.ndarray  # (B, F_CAP, 3) idt pushed intervals
    infos: jnp.ndarray  # (B, F_CAP) int32 pushed info (end position)
    n_pushed: jnp.ndarray  # (B,) int32
    call_x: jnp.ndarray  # (B, C_CAP) int32 start of each call
    call_start: jnp.ndarray  # (B, C_CAP) int32 index of first push
    call_len: jnp.ndarray  # (B, C_CAP) int32 number of pushes
    n_calls: jnp.ndarray  # (B,) int32
    overflow: jnp.ndarray  # (B,) bool


@functools.partial(jax.jit, static_argnums=(4,))
def forward_pass(fm: DeviceFMIndex, q: jnp.ndarray, lens: jnp.ndarray,
                 min_intv: jnp.ndarray, chain: bool = True,
                 starts: jnp.ndarray = None) -> FwdOut:
    """Run chained (pass 1) or single (pass 2) smem1 forward loops.

    q: (B, L) uint8 nt4 codes (pad >= 4); lens: (B,) int32;
    min_intv: (B,) int64; starts: (B,) int32 initial x (default 0).
    chain=True: after each call, continue from the returned position
    (mem_collect_intv pass-1 loop); chain=False: exactly one call per lane.

    Internals run in (8, W) layout — the v8 backward lesson: (B,)
    elementwise maps to one VPU sublane row while (8, W) uses all eight —
    with the push buffers FLAT (Bp*F_CAP) and every update a pure
    drop-mode scatter so XLA mutates the donated loop buffers in place.
    The returned FwdOut is reshaped to the documented (B, ...) contract.
    """
    B, L = q.shape
    if starts is None:
        starts = jnp.zeros(B, dtype=jnp.int32)

    SEEK, EXT, DONE = 0, 1, 2
    S = 8
    Bp = ((B + S - 1) // S) * S
    W = Bp // S
    pad = Bp - B

    def pad1(x, fill=0):
        if pad:
            x = jnp.concatenate(
                [x, jnp.full((pad,), fill, x.dtype)])
        return x.reshape(S, W)

    qflat = q.reshape(-1).astype(jnp.int32)
    lens2 = pad1(lens.astype(jnp.int32))  # pad lanes: len 0 -> DONE round 1
    minv2 = pad1(min_intv.astype(fm.idt), 1)
    row2d = jnp.arange(Bp, dtype=jnp.int32).reshape(S, W)
    # Section-fused flat buffers: every per-round output lands in one of
    # TWO flat buffers (A: idt-valued interval words; B: int32 metadata),
    # each updated with ONE drop-mode scatter per round. Separate buffers
    # cost one scatter op EACH per round, and at automaton widths the
    # per-op launch overhead dominates the index work (1-word flat
    # scatters are this backend's fast path; (n, k) row scatters measured
    # 2-5x slower still).
    F = Bp * F_CAP
    C = Bp * C_CAP
    OUT_A = np.int32(3 * F)  # A sections: iv0 | iv1 | iv2
    OUT_B = np.int32(F + 2 * C)  # B sections: infos | call_x | call_start

    state = dict(
        x=pad1(starts.astype(jnp.int32)),
        kind=jnp.full((S, W), SEEK, jnp.int32),
        ik0=jnp.zeros((S, W), fm.idt),
        ik1=jnp.zeros((S, W), fm.idt),
        ik2=jnp.zeros((S, W), fm.idt),
        info=jnp.zeros((S, W), jnp.int32),
        i=jnp.zeros((S, W), jnp.int32),
        bufA=jnp.zeros(3 * F, fm.idt),
        bufB=jnp.zeros(F + 2 * C, jnp.int32),
        n_pushed=jnp.zeros((S, W), jnp.int32),
        # call_len is DERIVED after the loop (pushes within a call are
        # consecutive, so call_len[c] = start[c+1] - start[c], last =
        # n_pushed - start); no per-round owner/length bookkeeping
        n_calls=jnp.zeros((S, W), jnp.int32),
        overflow=jnp.zeros((S, W), bool),
    )

    def qat1(pos):
        safe = jnp.clip(pos, 0, L - 1)
        idx = jnp.minimum(row2d * np.int32(L) + safe, np.int32(B * L - 1))
        ok = (pos >= 0) & (pos < L) & (row2d < np.int32(B))
        return jnp.where(ok, qflat[idx], np.int32(4))

    def end_call(st, do):
        """Call finished: last pushed info is the return; chain or stop.
        Every terminating lane pushed THIS round (term is a subset of
        push_now), so the last pushed info IS the lane's current info
        register — no buffer gather needed."""
        ret = st["info"]
        if chain:
            new_x = jnp.where(do, ret, st["x"])
            new_kind = jnp.where(do, SEEK, st["kind"])
        else:
            new_x = st["x"]
            new_kind = jnp.where(do, DONE, st["kind"])
        return dict(st, x=new_x, kind=new_kind)

    def body(st):
        kind, x = st["kind"], st["x"]
        seek = kind == SEEK
        qx = qat1(x)

        # --- seek step ---
        fin = seek & (x >= lens2)
        amb = seek & ~fin & (qx > 3)
        beg = seek & ~fin & ~amb
        call_ov = beg & (st["n_calls"] >= C_CAP)
        beg = beg & ~call_ov
        if not chain:
            # single-call mode: an ambiguous start yields no mems (bwt.c:296)
            fin = fin | amb
            amb = amb & False
        st = dict(st, overflow=st["overflow"] | call_ov,
                  kind=jnp.where(fin | call_ov, DONE, st["kind"]),
                  x=jnp.where(amb, x + 1, st["x"]))
        # begin call: capture the scatter values now, land them in the
        # round's single fused B scatter below (beg excludes n_calls >=
        # C_CAP: in-range iff beg)
        cslot = (row2d * np.int32(C_CAP)
                 + jnp.minimum(st["n_calls"], C_CAP - 1)).reshape(-1)
        begf = beg.reshape(-1)
        beg_x = x.reshape(-1)
        beg_np = st["n_pushed"].reshape(-1)
        st["n_calls"] = st["n_calls"] + beg.astype(jnp.int32)
        ik0n = fm.set_intv(jnp.clip(qx, 0, 3))  # (8, W, 3)
        st["ik0"] = jnp.where(beg, ik0n[..., 0], st["ik0"])
        st["ik1"] = jnp.where(beg, ik0n[..., 1], st["ik1"])
        st["ik2"] = jnp.where(beg, ik0n[..., 2], st["ik2"])
        st["info"] = jnp.where(beg, x + 1, st["info"])
        st["i"] = jnp.where(beg, x + 1, st["i"])
        st["kind"] = jnp.where(beg, EXT, st["kind"])

        # --- extend step (one forward base for lanes in EXT) ---
        kind, i = st["kind"], st["i"]
        ext = kind == EXT
        at_end = ext & (i >= lens2)
        qi = qat1(i)
        amb_i = ext & ~at_end & (qi > 3)
        do_ext = ext & ~at_end & ~amb_i
        # known-base extension: ONLY the consumed bwt_extend row
        # (extend1_fwd) — one 4-wide O2 row gather per step instead of
        # extend()'s two 8-word OCC16 rows + the (…, 4, 3) select
        cb = (3 - jnp.clip(qi, 0, 3)).astype(jnp.int32)
        nk0, nk1, ns = fm.extend1_fwd(st["ik0"], st["ik1"], st["ik2"], cb)
        changed = ns != st["ik2"]
        too_small = ns < minv2
        # pushes: end-of-read, ambiguous, or size change
        push_now = at_end | amb_i | (do_ext & changed)
        can = (push_now & (st["n_pushed"] < F_CAP)).reshape(-1)
        ov = push_now & (st["n_pushed"] >= F_CAP)
        slot = (row2d * np.int32(F_CAP) + st["n_pushed"]).reshape(-1)
        FF = np.int32(F)
        idxA = jnp.concatenate(
            [jnp.where(can, slot, OUT_A),
             jnp.where(can, slot + FF, OUT_A),
             jnp.where(can, slot + np.int32(2 * F), OUT_A)])
        valA = jnp.concatenate(
            [st["ik0"].reshape(-1), st["ik1"].reshape(-1),
             st["ik2"].reshape(-1)])
        st["bufA"] = st["bufA"].at[idxA].set(valA, mode="drop")
        idxB = jnp.concatenate(
            [jnp.where(can, slot, OUT_B),
             jnp.where(begf, cslot + FF, OUT_B),
             jnp.where(begf, cslot + np.int32(F + C), OUT_B)])
        valB = jnp.concatenate(
            [st["info"].reshape(-1), beg_x, beg_np])
        st["bufB"] = st["bufB"].at[idxB].set(valB, mode="drop")
        st["n_pushed"] = st["n_pushed"] + push_now.astype(jnp.int32)
        st["overflow"] = st["overflow"] | ov
        # call terminations
        term = at_end | amb_i | (do_ext & changed & too_small)
        st = end_call(st, term)
        # advance for continuing lanes
        go_on = do_ext & ~(changed & too_small)
        st["ik0"] = jnp.where(go_on, nk0, st["ik0"])
        st["ik1"] = jnp.where(go_on, nk1, st["ik1"])
        st["ik2"] = jnp.where(go_on, ns, st["ik2"])
        st["info"] = jnp.where(go_on, i + 1, st["info"])
        st["i"] = jnp.where(go_on, i + 1, st["i"])
        return st

    def cond(st):
        return jnp.any(st["kind"] != DONE)

    state = jax.lax.while_loop(cond, body, state)
    n_pushed = state["n_pushed"].reshape(Bp)
    n_calls = state["n_calls"].reshape(Bp)
    # call_len[c] = call_start[c+1] - call_start[c] (last: n_pushed - start):
    # pushes within a call are consecutive in the lane's push buffer, so
    # the lengths need no per-round bookkeeping (non-overflow lanes only;
    # overflow lanes fall back to the exact scalar engine anyway)
    bufA, bufB = state["bufA"], state["bufB"]
    call_start = bufB[F + C : F + 2 * C].reshape(Bp, C_CAP)
    nc = jnp.minimum(n_calls, C_CAP)[:, None]
    cix = jnp.arange(C_CAP, dtype=jnp.int32)[None, :]
    nxt = jnp.concatenate(
        [call_start[:, 1:], jnp.zeros((Bp, 1), jnp.int32)], axis=1)
    nxt = jnp.where(cix + 1 < nc, nxt, n_pushed[:, None])
    call_len = jnp.where(cix < nc, nxt - call_start, 0)
    ivals = jnp.stack([bufA[:F], bufA[F : 2 * F], bufA[2 * F :]],
                      axis=-1).reshape(Bp, F_CAP, 3)
    return FwdOut(ivals[:B],
                  bufB[:F].reshape(Bp, F_CAP)[:B],
                  n_pushed[:B],
                  bufB[F : F + C].reshape(Bp, C_CAP)[:B],
                  call_start[:B],
                  call_len[:B],
                  n_calls[:B],
                  state["overflow"].reshape(Bp)[:B])


@functools.partial(jax.jit, static_argnums=(4, 5))
def forward_p3(fm: DeviceFMIndex, q: jnp.ndarray, lens: jnp.ndarray,
               min_intv: jnp.ndarray, min_seed_len: int, max_intv: int
               ) -> "tuple[FwdOut, Pass3Out]":
    """Chained pass-1 forward loop AND the pass-3 sweep in ONE while_loop.

    Run separately the two automata cost rounds_1 + rounds_3 lockstep
    rounds (each ~L for 101 bp reads); merged they cost max(rounds_1,
    rounds_3), with the per-round query gathers, set_intv table reads and
    the extend1_fwd O2 row gather SHARED by stacking the two automata's
    lanes into one (16, W) dispatch. Semantics are exactly
    forward_pass(chain=True) + pass3 (bwt.c:304-321, 358-379)."""
    B, L = q.shape
    SEEK, EXT, DONE = 0, 1, 2
    S = 8
    Bp = ((B + S - 1) // S) * S
    W = Bp // S
    pad = Bp - B

    def pad1(x, fill=0):
        if pad:
            x = jnp.concatenate([x, jnp.full((pad,), fill, x.dtype)])
        return x.reshape(S, W)

    qflat = q.reshape(-1).astype(jnp.int32)
    lens2 = pad1(lens.astype(jnp.int32))
    minv2 = pad1(min_intv.astype(fm.idt), 1)
    row2d = jnp.arange(Bp, dtype=jnp.int32).reshape(S, W)
    # Section-fused flat buffers (see forward_pass): A holds the
    # idt-valued interval words (iv0|iv1|iv2|s0|s1|s2), B the int32
    # metadata (infos|call_x|call_start|sx|si) — ONE drop-mode scatter
    # each per round instead of 11 separate scatters.
    F = Bp * F_CAP
    C = Bp * C_CAP
    S3 = Bp * S3_CAP
    OUT_A = np.int32(3 * F + 3 * S3)
    OUT_B = np.int32(F + 2 * C + 2 * S3)

    state = dict(
        # forward (pass-1) automaton
        x=jnp.zeros((S, W), jnp.int32),
        kind=jnp.full((S, W), SEEK, jnp.int32),
        ik0=jnp.zeros((S, W), fm.idt),
        ik1=jnp.zeros((S, W), fm.idt),
        ik2=jnp.zeros((S, W), fm.idt),
        info=jnp.zeros((S, W), jnp.int32),
        i=jnp.zeros((S, W), jnp.int32),
        bufA=jnp.zeros(3 * F + 3 * S3, fm.idt),
        bufB=jnp.zeros(F + 2 * C + 2 * S3, jnp.int32),
        n_pushed=jnp.zeros((S, W), jnp.int32),
        n_calls=jnp.zeros((S, W), jnp.int32),
        overflow=jnp.zeros((S, W), bool),
        # pass-3 automaton
        px=jnp.zeros((S, W), jnp.int32),
        pi=jnp.zeros((S, W), jnp.int32),
        pkind=jnp.full((S, W), SEEK, jnp.int32),
        pk0=jnp.zeros((S, W), fm.idt),
        pk1=jnp.zeros((S, W), fm.idt),
        pk2=jnp.zeros((S, W), fm.idt),
        pn=jnp.zeros((S, W), jnp.int32),
        pov=jnp.zeros((S, W), bool),
    )

    def qat2(p0, p1):
        """One gather for two positions per lane."""
        def idx_of(pos):
            safe = jnp.clip(pos, 0, L - 1)
            return jnp.minimum(row2d * np.int32(L) + safe,
                               np.int32(B * L - 1))

        got = qflat[jnp.stack([idx_of(p0), idx_of(p1)])]

        def mask(pos, g):
            ok = (pos >= 0) & (pos < L) & (row2d < np.int32(B))
            return jnp.where(ok, g, np.int32(4))

        return mask(p0, got[0]), mask(p1, got[1])

    def body(st):
        # ---- phase 1: seek bases for both automata (one gather) ----
        x, kind = st["x"], st["kind"]
        px, pkind = st["px"], st["pkind"]
        qx, pqx = qat2(x, px)
        seek = kind == SEEK
        pseek = pkind == SEEK

        # ---- forward seek ----
        fin = seek & (x >= lens2)
        amb = seek & ~fin & (qx > 3)
        beg = seek & ~fin & ~amb
        call_ov = beg & (st["n_calls"] >= C_CAP)
        beg = beg & ~call_ov
        st = dict(st, overflow=st["overflow"] | call_ov,
                  kind=jnp.where(fin | call_ov, DONE, st["kind"]),
                  x=jnp.where(amb, x + 1, st["x"]))
        # begin call: capture values now, land them in the round's single
        # fused B scatter below
        cslot = (row2d * np.int32(C_CAP)
                 + jnp.minimum(st["n_calls"], C_CAP - 1)).reshape(-1)
        begf = beg.reshape(-1)
        beg_x = x.reshape(-1)
        beg_np = st["n_pushed"].reshape(-1)
        st["n_calls"] = st["n_calls"] + beg.astype(jnp.int32)

        # ---- pass-3 seek ----
        pfin = pseek & (px >= lens2)
        pamb = pseek & ~pfin & (pqx > 3)
        pbeg = pseek & ~pfin & ~pamb
        st["pkind"] = jnp.where(pfin, DONE, st["pkind"])
        st["px"] = jnp.where(pamb, px + 1, st["px"])

        # shared set_intv: stacked (16, W) single L2 read set
        ikn = fm.set_intv(jnp.concatenate(
            [jnp.clip(qx, 0, 3), jnp.clip(pqx, 0, 3)], axis=0))
        st["ik0"] = jnp.where(beg, ikn[:S, :, 0], st["ik0"])
        st["ik1"] = jnp.where(beg, ikn[:S, :, 1], st["ik1"])
        st["ik2"] = jnp.where(beg, ikn[:S, :, 2], st["ik2"])
        st["info"] = jnp.where(beg, x + 1, st["info"])
        st["i"] = jnp.where(beg, x + 1, st["i"])
        st["kind"] = jnp.where(beg, EXT, st["kind"])
        st["pk0"] = jnp.where(pbeg, ikn[S:, :, 0], st["pk0"])
        st["pk1"] = jnp.where(pbeg, ikn[S:, :, 1], st["pk1"])
        st["pk2"] = jnp.where(pbeg, ikn[S:, :, 2], st["pk2"])
        st["pi"] = jnp.where(pbeg, st["px"] + 1, st["pi"])
        st["pkind"] = jnp.where(pbeg, EXT, st["pkind"])

        # ---- phase 2: extend bases for both automata (one gather) ----
        i, pi = st["i"], st["pi"]
        qi, pqi = qat2(i, pi)
        ext = st["kind"] == EXT
        pext = st["pkind"] == EXT
        at_end = ext & (i >= lens2)
        amb_i = ext & ~at_end & (qi > 3)
        do_ext = ext & ~at_end & ~amb_i
        p_end = pext & (pi >= lens2)
        pamb_i = pext & ~p_end & (pqi > 3)
        pdo = pext & ~p_end & ~pamb_i

        # shared extension: stacked (16, W) — ONE O2 row gather
        cb = (3 - jnp.clip(qi, 0, 3)).astype(jnp.int32)
        pcb = (3 - jnp.clip(pqi, 0, 3)).astype(jnp.int32)
        ek0, ek1, ek2 = fm.extend1_fwd(
            jnp.concatenate([st["ik0"], st["pk0"]], axis=0),
            jnp.concatenate([st["ik1"], st["pk1"]], axis=0),
            jnp.concatenate([st["ik2"], st["pk2"]], axis=0),
            jnp.concatenate([cb, pcb], axis=0))
        nk0, nk1, ns = ek0[:S], ek1[:S], ek2[:S]
        qk0, qk1, qs = ek0[S:], ek1[S:], ek2[S:]

        # ---- forward extend bookkeeping ----
        changed = ns != st["ik2"]
        too_small = ns < minv2
        push_now = at_end | amb_i | (do_ext & changed)
        can = (push_now & (st["n_pushed"] < F_CAP)).reshape(-1)
        ov = push_now & (st["n_pushed"] >= F_CAP)
        slot = (row2d * np.int32(F_CAP) + st["n_pushed"]).reshape(-1)
        # capture push values BEFORE the go_on advance mutates them; they
        # land in the round's single fused scatters below
        push_ik = (st["ik0"].reshape(-1), st["ik1"].reshape(-1),
                   st["ik2"].reshape(-1))
        push_info = st["info"].reshape(-1)
        st["n_pushed"] = st["n_pushed"] + push_now.astype(jnp.int32)
        st["overflow"] = st["overflow"] | ov
        # call end: the last pushed info is the return, and every
        # terminating lane pushed THIS round (term subset of push_now),
        # so it IS the lane's info register — no buffer gather
        term = at_end | amb_i | (do_ext & changed & too_small)
        st["x"] = jnp.where(term, st["info"], st["x"])
        st["kind"] = jnp.where(term, SEEK, st["kind"])
        go_on = do_ext & ~(changed & too_small)
        st["ik0"] = jnp.where(go_on, nk0, st["ik0"])
        st["ik1"] = jnp.where(go_on, nk1, st["ik1"])
        st["ik2"] = jnp.where(go_on, ns, st["ik2"])
        st["info"] = jnp.where(go_on, i + 1, st["info"])
        st["i"] = jnp.where(go_on, i + 1, st["i"])

        # ---- pass-3 extend bookkeeping ----
        hit = pdo & (qs < max_intv) & ((pi - st["px"]) >= min_seed_len)
        emit = hit & (qs > 0)
        pcan = (emit & (st["pn"] < S3_CAP)).reshape(-1)
        pv = emit & (st["pn"] >= S3_CAP)
        pslot = (row2d * np.int32(S3_CAP) + st["pn"]).reshape(-1)
        st["pn"] = st["pn"] + emit.astype(jnp.int32)
        st["pov"] = st["pov"] | pv

        # ---- the round's TWO fused scatters ----
        FF, F3 = np.int32(F), np.int32(3 * F)
        idxA = jnp.concatenate(
            [jnp.where(can, slot, OUT_A),
             jnp.where(can, slot + FF, OUT_A),
             jnp.where(can, slot + np.int32(2 * F), OUT_A),
             jnp.where(pcan, pslot + F3, OUT_A),
             jnp.where(pcan, pslot + np.int32(3 * F + S3), OUT_A),
             jnp.where(pcan, pslot + np.int32(3 * F + 2 * S3), OUT_A)])
        valA = jnp.concatenate(
            [push_ik[0], push_ik[1], push_ik[2],
             qk0.reshape(-1), qk1.reshape(-1), qs.reshape(-1)])
        st["bufA"] = st["bufA"].at[idxA].set(valA, mode="drop")
        FC = np.int32(F + C)
        F2C = np.int32(F + 2 * C)
        idxB = jnp.concatenate(
            [jnp.where(can, slot, OUT_B),
             jnp.where(begf, cslot + FF, OUT_B),
             jnp.where(begf, cslot + FC, OUT_B),
             jnp.where(pcan, pslot + F2C, OUT_B),
             jnp.where(pcan, pslot + np.int32(F + 2 * C + S3), OUT_B)])
        valB = jnp.concatenate(
            [push_info, beg_x, beg_np,
             st["px"].reshape(-1), (pi + 1).reshape(-1)])
        st["bufB"] = st["bufB"].at[idxB].set(valB, mode="drop")
        st["pkind"] = jnp.where(p_end, DONE, st["pkind"])
        pnxt = pamb_i | hit
        st["px"] = jnp.where(pnxt, pi + 1, st["px"])
        st["pkind"] = jnp.where(pnxt, SEEK, st["pkind"])
        pgo = pdo & ~hit
        st["pk0"] = jnp.where(pgo, qk0, st["pk0"])
        st["pk1"] = jnp.where(pgo, qk1, st["pk1"])
        st["pk2"] = jnp.where(pgo, qs, st["pk2"])
        st["pi"] = jnp.where(pgo, pi + 1, st["pi"])
        return st

    def cond(st):
        return jnp.any((st["kind"] != DONE) | (st["pkind"] != DONE))

    state = jax.lax.while_loop(cond, body, state)
    bufA, bufB = state["bufA"], state["bufB"]
    n_pushed = state["n_pushed"].reshape(Bp)
    n_calls = state["n_calls"].reshape(Bp)
    call_start = bufB[F + C : F + 2 * C].reshape(Bp, C_CAP)
    nc = jnp.minimum(n_calls, C_CAP)[:, None]
    cix = jnp.arange(C_CAP, dtype=jnp.int32)[None, :]
    nxt = jnp.concatenate(
        [call_start[:, 1:], jnp.zeros((Bp, 1), jnp.int32)], axis=1)
    nxt = jnp.where(cix + 1 < nc, nxt, n_pushed[:, None])
    call_len = jnp.where(cix < nc, nxt - call_start, 0)
    ivals = jnp.stack([bufA[:F], bufA[F : 2 * F], bufA[2 * F : 3 * F]],
                      axis=-1).reshape(Bp, F_CAP, 3)
    fwd = FwdOut(ivals[:B],
                 bufB[:F].reshape(Bp, F_CAP)[:B],
                 n_pushed[:B],
                 bufB[F : F + C].reshape(Bp, C_CAP)[:B],
                 call_start[:B],
                 call_len[:B],
                 n_calls[:B],
                 state["overflow"].reshape(Bp)[:B])
    seeds = jnp.stack([bufA[3 * F : 3 * F + S3],
                       bufA[3 * F + S3 : 3 * F + 2 * S3],
                       bufA[3 * F + 2 * S3 :]],
                      axis=-1).reshape(Bp, S3_CAP, 3)
    sinf = ((bufB[F + 2 * C : F + 2 * C + S3].astype(jnp.int64) << 32)
            | bufB[F + 2 * C + S3 :].astype(jnp.int64))
    p3 = Pass3Out(seeds[:B],
                  sinf.reshape(Bp, S3_CAP)[:B],
                  state["pn"].reshape(Bp)[:B],
                  state["pov"].reshape(Bp)[:B])
    return fwd, p3


class BwdOut(NamedTuple):
    mems: jnp.ndarray  # (N, M_CAP, 3) idt — mems emitted THIS segment
    mem_infos: jnp.ndarray  # (N, M_CAP) int64 (start<<32 | end)
    n_mems: jnp.ndarray  # (N,) int32
    overflow: jnp.ndarray  # (N,) bool
    i: jnp.ndarray  # (N,) int32 resumable position
    prev: jnp.ndarray  # (N, P, 3) surviving intervals
    prev_info: jnp.ndarray  # (N, P) int64
    n_prev: jnp.ndarray  # (N,) int32
    last_start: jnp.ndarray  # (N,) int64
    active: jnp.ndarray  # (N,) bool


@functools.partial(jax.jit, static_argnums=(8,))
def backward_segment(fm: DeviceFMIndex, qrows: jnp.ndarray, prev: jnp.ndarray,
                     prev_info: jnp.ndarray, n_prev: jnp.ndarray,
                     i0: jnp.ndarray, min_intv: jnp.ndarray,
                     last_start: jnp.ndarray, max_steps: int) -> BwdOut:
    """Run up to max_steps backward iterations for N (read, call) lanes.

    Lanes die at different times; the caller compacts survivors between
    segments so dead lanes stop consuming lockstep compute. qrows: (N, L)
    uint8; prev: (N, P, 3) idt reversed-push-order forward intervals;
    i0: (N,) the next backward position; last_start: (N,) the containment
    guard state (1<<62 when no mem emitted yet)."""
    N, L = qrows.shape
    P = prev.shape[1]
    rows = jnp.arange(N)
    lanes = jnp.arange(P)

    state = dict(
        i=i0.astype(jnp.int32),
        prev=prev.astype(fm.idt), prev_info=prev_info,
        n_prev=n_prev.astype(jnp.int32),
        mems=jnp.zeros((N, M_CAP, 3), fm.idt),
        mem_infos=jnp.zeros((N, M_CAP), jnp.int64),
        n_mems=jnp.zeros(N, jnp.int32),
        last_start=last_start.astype(jnp.int64),
        active=n_prev > 0,
        overflow=jnp.zeros(N, bool),
        steps=jnp.int32(0),
    )

    def body(st):
        i = st["i"]
        act = st["active"]
        safe_i = jnp.clip(i, 0, L - 1)
        qi = jnp.where((i >= 0) & (i < L), qrows[rows, safe_i], jnp.uint8(4))
        has_c = (i >= 0) & (qi < 4)
        c = jnp.clip(qi, 0, 3).astype(jnp.int32)

        live = lanes[None, :] < st["n_prev"][:, None]  # (N, P)
        ok = fm.extend(st["prev"], 1)  # (N, P, 4, 3)
        okc = ok[rows[:, None], lanes[None, :], c[:, None], :]  # (N, P, 3)
        keeper = live & has_c[:, None] & (okc[:, :, 2] >= min_intv[:, None])

        # mem emission: the first (longest-match) entry fails -> push prev[0]
        first_fails = act & live[:, 0] & ~keeper[:, 0]
        not_contained = (i + 1) < st["last_start"]
        emit = first_fails & not_contained
        midx = jnp.minimum(st["n_mems"], M_CAP - 1)
        mem_ov = emit & (st["n_mems"] >= M_CAP)
        info = st["prev_info"][:, 0] | ((i + 1).astype(jnp.int64) << 32)
        st["mems"] = st["mems"].at[rows, midx].set(
            jnp.where(emit[:, None], st["prev"][:, 0], st["mems"][rows, midx]))
        st["mem_infos"] = st["mem_infos"].at[rows, midx].set(
            jnp.where(emit, info, st["mem_infos"][rows, midx]))
        st["n_mems"] = st["n_mems"] + emit.astype(jnp.int32)
        st["last_start"] = jnp.where(emit, (i + 1).astype(jnp.int64),
                                     st["last_start"])
        st["overflow"] = st["overflow"] | mem_ov

        # survivors: keepers with consecutive duplicate sizes collapsed
        kidx = jnp.where(keeper, lanes[None, :], -1)
        prev_kidx = jax.lax.associative_scan(jnp.maximum, kidx, axis=1)
        prev_kidx = jnp.concatenate(
            [jnp.full((N, 1), -1), prev_kidx[:, :-1]], axis=1)
        prev_size = jnp.take_along_axis(
            okc[:, :, 2], jnp.maximum(prev_kidx, 0), axis=1)
        append = keeper & ((prev_kidx < 0) | (okc[:, :, 2] != prev_size))
        pos = jnp.cumsum(append.astype(jnp.int32), axis=1) - 1
        n_new = append.sum(axis=1).astype(jnp.int32)
        new_prev = jnp.zeros_like(st["prev"])
        new_info = jnp.zeros_like(st["prev_info"])
        scatter_pos = jnp.where(append, pos, P)  # P = dropped
        new_prev = new_prev.at[rows[:, None], scatter_pos].set(okc, mode="drop")
        new_info = new_info.at[rows[:, None], scatter_pos].set(
            st["prev_info"], mode="drop")

        cont = act & (n_new > 0)
        st["prev"] = jnp.where(cont[:, None, None], new_prev, st["prev"])
        st["prev_info"] = jnp.where(cont[:, None], new_info, st["prev_info"])
        st["n_prev"] = jnp.where(cont, n_new, st["n_prev"])
        st["active"] = cont & (i >= 0)
        st["i"] = jnp.where(st["active"], i - 1, i)
        st["steps"] = st["steps"] + 1
        return st

    def cond(st):
        return jnp.any(st["active"]) & (st["steps"] < max_steps)

    state = jax.lax.while_loop(cond, body, state)
    return BwdOut(state["mems"], state["mem_infos"], state["n_mems"],
                  state["overflow"], state["i"], state["prev"],
                  state["prev_info"], state["n_prev"], state["last_start"],
                  state["active"])


def run_backward(fm: DeviceFMIndex, qrows_np, prev_np, prev_info_np, n_prev_np,
                 x0_np, min_intv_np, seg_steps: int = 12):
    """Segmented backward driver with host compaction of dead lanes.

    Returns (per-lane mem lists in emission order, overflow mask) for the
    ORIGINAL lane indexing. numpy inputs; lanes beyond real count must have
    n_prev == 0."""
    import numpy as np

    N0 = len(n_prev_np)
    out_mems = [[] for _ in range(N0)]
    overflow = np.zeros(N0, bool)
    lane_ids = np.arange(N0)
    qrows, prev, prev_info = qrows_np, prev_np, prev_info_np
    n_prev = n_prev_np
    i_cur = x0_np.astype(np.int32) - 1
    last_start = np.full(N0, 1 << 62, np.int64)
    minv = min_intv_np
    while True:
        live = n_prev > 0
        if not live.any():
            break
        # compact
        sel = np.nonzero(live)[0]
        pad = 1 << max(4, (len(sel) - 1).bit_length())
        idxs = np.concatenate([sel, np.zeros(pad - len(sel), np.int64)])
        padmask = np.arange(pad) < len(sel)
        seg = backward_segment(
            fm, jnp.asarray(qrows[idxs]), jnp.asarray(prev[idxs]),
            jnp.asarray(prev_info[idxs]),
            jnp.asarray(np.where(padmask, n_prev[idxs], 0)),
            jnp.asarray(np.where(padmask, i_cur[idxs], -1)),
            jnp.asarray(minv[idxs]), jnp.asarray(last_start[idxs]), seg_steps)
        mems = np.asarray(seg.mems)
        infos = np.asarray(seg.mem_infos)
        nm = np.asarray(seg.n_mems)
        ov = np.asarray(seg.overflow)
        for ln in range(len(sel)):
            oid = lane_ids[sel[ln]]
            for j in range(nm[ln]):
                out_mems[oid].append((int(mems[ln, j, 0]), int(mems[ln, j, 1]),
                                      int(mems[ln, j, 2]), int(infos[ln, j])))
            if ov[ln]:
                overflow[oid] = True
        # write back survivor state into the original-slot arrays
        qrows = qrows[idxs]
        prev = np.asarray(seg.prev)
        prev_info = np.asarray(seg.prev_info)
        act = np.asarray(seg.active)
        n_prev = np.where(act & padmask, np.asarray(seg.n_prev), 0)
        i_cur = np.asarray(seg.i)
        last_start = np.asarray(seg.last_start)
        minv = minv[idxs]
        lane_ids = lane_ids[idxs]
    return out_mems, overflow


class Pass3Out(NamedTuple):
    seeds: jnp.ndarray  # (B, S3_CAP, 3) int64
    infos: jnp.ndarray  # (B, S3_CAP) int64
    n_seeds: jnp.ndarray  # (B,) int32
    overflow: jnp.ndarray  # (B,) bool


@functools.partial(jax.jit, static_argnums=(3, 4))
def pass3(fm: DeviceFMIndex, q: jnp.ndarray, lens: jnp.ndarray,
          min_seed_len: int, max_intv: int) -> Pass3Out:
    """bwt_seed_strategy1 sweep (mem_collect_intv 3rd pass).

    Runs in (8, W) layout like forward_pass — (B,) elementwise maps to one
    VPU sublane row while (8, W) uses all eight; the 1-D formulation
    measured SLOWER than the whole chained pass-1 automaton — with the
    seed quads [s0, s1, s2, info] fused into ONE flat drop-mode scatter."""
    B, L = q.shape
    SEEK, EXT, DONE = 0, 1, 2
    S = 8
    Bp = ((B + S - 1) // S) * S
    W = Bp // S
    pad = Bp - B

    def pad1(x, fill=0):
        if pad:
            x = jnp.concatenate([x, jnp.full((pad,), fill, x.dtype)])
        return x.reshape(S, W)

    qflat = q.reshape(-1).astype(jnp.int32)
    lens2 = pad1(lens.astype(jnp.int32))
    row2d = jnp.arange(Bp, dtype=jnp.int32).reshape(S, W)
    OUT_S = np.int32(Bp * S3_CAP)

    state = dict(
        x=jnp.zeros((S, W), jnp.int32), i=jnp.zeros((S, W), jnp.int32),
        kind=jnp.full((S, W), SEEK, jnp.int32),
        ik0=jnp.zeros((S, W), fm.idt),
        ik1=jnp.zeros((S, W), fm.idt),
        ik2=jnp.zeros((S, W), fm.idt),
        # flat per-component buffers: 1-word flat scatters are the fast
        # scatter path (row scatters measured 2-5x slower; see forward_pass)
        s0=jnp.zeros(Bp * S3_CAP, fm.idt),
        s1=jnp.zeros(Bp * S3_CAP, fm.idt),
        s2=jnp.zeros(Bp * S3_CAP, fm.idt),
        # info = (x<<32 | i+1) is int64, but int64 scatters are emulated
        # (2x): keep the two int32 halves flat and combine post-loop
        sx=jnp.zeros(Bp * S3_CAP, jnp.int32),
        si=jnp.zeros(Bp * S3_CAP, jnp.int32),
        n=jnp.zeros((S, W), jnp.int32),
        overflow=jnp.zeros((S, W), bool),
    )

    def qat2(p0, p1):
        def idx_of(pos):
            safe = jnp.clip(pos, 0, L - 1)
            return jnp.minimum(row2d * np.int32(L) + safe,
                               np.int32(B * L - 1))

        idx = jnp.stack([idx_of(p0), idx_of(p1)])
        got = qflat[idx]

        def mask(pos, g):
            ok = (pos >= 0) & (pos < L) & (row2d < np.int32(B))
            return jnp.where(ok, g, np.int32(4))

        return mask(p0, got[0]), mask(p1, got[1])

    def body(st):
        x, i, kind = st["x"], st["i"], st["kind"]
        seek = kind == SEEK
        # extend base: a lane beginning its call THIS round extends at x+1
        qx, qi0 = qat2(x, jnp.where(seek, x + 1, i))
        fin = seek & (x >= lens2)
        amb = seek & ~fin & (qx > 3)
        beg = seek & ~fin & ~amb
        st = dict(st, kind=jnp.where(fin, DONE, kind),
                  x=jnp.where(amb, x + 1, x))
        ik0n = fm.set_intv(jnp.clip(qx, 0, 3).astype(jnp.int32))
        st["ik0"] = jnp.where(beg, ik0n[..., 0], st["ik0"])
        st["ik1"] = jnp.where(beg, ik0n[..., 1], st["ik1"])
        st["ik2"] = jnp.where(beg, ik0n[..., 2], st["ik2"])
        st["i"] = jnp.where(beg, st["x"] + 1, st["i"])
        st["kind"] = jnp.where(beg, EXT, st["kind"])

        kind, i = st["kind"], st["i"]
        ext = kind == EXT
        end_of_read = ext & (i >= lens2)  # loop ran off: return len, done
        qi = qi0
        amb_i = ext & ~end_of_read & (qi > 3)  # return i+1 -> next x
        do = ext & ~end_of_read & ~amb_i
        c = (3 - jnp.clip(qi, 0, 3)).astype(jnp.int32)
        nk0, nk1, ns = fm.extend1_fwd(st["ik0"], st["ik1"], st["ik2"], c)
        hit = do & (ns < max_intv) & ((i - st["x"]) >= min_seed_len)
        # emit seed when hit & size > 0 (one fused quad scatter)
        emit = hit & (ns > 0)
        can = emit & (st["n"] < S3_CAP)
        ov = emit & (st["n"] >= S3_CAP)
        sidx = jnp.where(can, row2d * np.int32(S3_CAP) + st["n"],
                         OUT_S).reshape(-1)
        st["s0"] = st["s0"].at[sidx].set(nk0.reshape(-1), mode="drop")
        st["s1"] = st["s1"].at[sidx].set(nk1.reshape(-1), mode="drop")
        st["s2"] = st["s2"].at[sidx].set(ns.reshape(-1), mode="drop")
        st["sx"] = st["sx"].at[sidx].set(st["x"].reshape(-1), mode="drop")
        st["si"] = st["si"].at[sidx].set((i + 1).reshape(-1), mode="drop")
        st["n"] = st["n"] + emit.astype(jnp.int32)
        st["overflow"] = st["overflow"] | ov

        st["kind"] = jnp.where(end_of_read, DONE, st["kind"])
        nxt = amb_i | hit
        st["x"] = jnp.where(nxt, i + 1, st["x"])
        st["kind"] = jnp.where(nxt, SEEK, st["kind"])
        go_on = do & ~hit
        st["ik0"] = jnp.where(go_on, nk0, st["ik0"])
        st["ik1"] = jnp.where(go_on, nk1, st["ik1"])
        st["ik2"] = jnp.where(go_on, ns, st["ik2"])
        st["i"] = jnp.where(go_on, i + 1, st["i"])
        return st

    def cond(st):
        return jnp.any(st["kind"] != DONE)

    state = jax.lax.while_loop(cond, body, state)
    seeds = jnp.stack([state["s0"], state["s1"], state["s2"]],
                      axis=-1).reshape(Bp, S3_CAP, 3)
    sinf = ((state["sx"].astype(jnp.int64) << 32)
            | state["si"].astype(jnp.int64))
    return Pass3Out(seeds[:B],
                    sinf.reshape(Bp, S3_CAP)[:B],
                    state["n"].reshape(Bp)[:B],
                    state["overflow"].reshape(Bp)[:B])
