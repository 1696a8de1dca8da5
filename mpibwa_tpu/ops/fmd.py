"""Device-resident FM-index and batched rank/extension primitives (JAX).

The interleaved occ/BWT blocks live in HBM as a (n_blocks, 16) uint32 array
(layout per bwt.h:72-78: 4 LE u64 cumulative counts + 8 u32 of 128 packed
bases). A batched occ4 is one gather of the 16-word block plus SWAR popcount
counting over the packed 2-bit words — the device analog of bwt_occ4 and its
__occ_aux bit trick (bwt.c:98-105, 165-186).

Interval arithmetic uses int32 when the doubled genome fits (most bacterial
to mammalian-chromosome cases on one shard) and int64 otherwise (full human
doubled = 6.2e9).
"""

from __future__ import annotations

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

M55 = jnp.uint32(0x55555555)
M33 = jnp.uint32(0x33333333)
M0F = jnp.uint32(0x0F0F0F0F)


def _popcount_pairs(m: jnp.ndarray) -> jnp.ndarray:
    """Popcount of a uint32 that has at most one bit per 2-bit group."""
    v = (m & M33) + ((m >> 2) & M33)
    v = (v + (v >> 4)) & M0F
    return ((v * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)


class DeviceFMIndex:
    """HBM-resident index arrays + batched primitives."""

    def __init__(self, idx, device=None, force_wide: bool = False):
        """force_wide runs a small index through the int64 (GRCh38-scale)
        position path — the differential-test hook for the wide engines."""
        n_blocks = len(idx.bwt) // 16
        blocks = np.ascontiguousarray(idx.bwt[: n_blocks * 16]).reshape(n_blocks, 16)
        occ = blocks[:, :8].copy().view(np.uint64)
        if occ.max() > np.iinfo(np.int32).max:
            # per-base occ counts exceed int32 only past ~8.6 Gbp of one
            # base — beyond any vertebrate genome and beyond the fast
            # OCC16 layout; no supported index reaches this
            raise ValueError("occ counts exceed int32; unsupported genome size")
        put = (lambda a: jax.device_put(a, device)) if device else jax.device_put
        self._put = put
        # The original interleaved occ+data blocks are NOT device-put here:
        # the default engines (v8 backward, OCC16 rank, OCC16 SA walk,
        # forward automaton) run entirely off the derived OCC16 table, so
        # these ~0.375 B/base are pure device-memory redundancy. They
        # materialize lazily on first use — the exact fallback engines
        # (occ4/occ4_cols) and the opt-in MPIBWA_OCC=occ4 path.
        self._host_occ = occ.astype(np.int32)  # (n_blocks, 4)
        self._host_data = np.ascontiguousarray(blocks[:, 8:])  # (nb, 8) u32
        self._occ = None
        self._data = None
        self.primary = int(idx.primary)
        self.seq_len = int(idx.seq_len)
        self.sa_intv = int(idx.sa_intv)
        # position dtype: int32 when every value (<= seq_len + 1) fits,
        # int64 for doubled genomes >= 2^31 (full human = 6.2e9). Counts
        # and interval sizes fit int32 either way (bounded by the per-base
        # totals, guarded above), so the OCC16 tables and the rank outputs
        # stay int32 — only position arithmetic widens.
        if self.seq_len + 2 < 2**31 and not force_wide:
            self.idt, self.np_idt = jnp.int32, np.int32
        else:
            self.idt, self.np_idt = jnp.int64, np.int64
        self.L2 = put(np.asarray(idx.L2).astype(self.np_idt))
        sa = np.asarray(idx.sa).view(np.int64)
        if self.idt == jnp.int32:
            sa = sa.astype(np.int32)  # -1 sentinel preserved
        self.sa = put(sa)
        # 2-bit packed forward reference for device-side window construction
        self.pac = put(np.asarray(idx.pac))
        self.l_pac = int(idx.l_pac)
        self._host_bwt = idx.bwt  # for derived device layouts (O2)
        # O2 derived table — the ONLY device-resident FM layout (2 B/base):
        # one (2,) int32 row [occ_c, word] per (16-base sub-block, base),
        # so a single-base rank is ONE row gather with the base folded
        # into the index. Built eagerly so it survives pytree
        # flattening into jitted callees (extend/forward_pass take fm as
        # an argument); valid for BOTH position dtypes (counts are int32
        # for every supported genome).
        from mpibwa_tpu.ops.backward8 import build_o2

        self._o2 = put(build_o2(idx.bwt))
        # sa_lookup dispatches to the jitted OCC16 walk itself (the
        # pytree-jitted wrapper would lose the derived tables)
        self.sa_lookup_jit = lambda ks: self.sa_lookup(ks)

    @property
    def occ(self):
        """(n_blocks, 4) int32 cumulative counts — lazy device residency
        (see __init__); raises if this is a traced/unflattened object that
        was flattened before materialization (callers touch the property
        host-side first)."""
        if self._occ is None:
            if getattr(self, "_host_occ", None) is None:
                raise RuntimeError(
                    "occ blocks not materialized before tracing; touch "
                    "fm.occ host-side before the jitted call")
            self._occ = self._put(self._host_occ)
        return self._occ

    @property
    def data(self):
        """(n_blocks, 8) uint32 packed BWT words — lazy, as with occ."""
        if self._data is None:
            if getattr(self, "_host_data", None) is None:
                raise RuntimeError(
                    "data blocks not materialized before tracing; touch "
                    "fm.data host-side before the jitted call")
            self._data = self._put(self._host_data)
        return self._data

    def o2_tables(self):
        """O2 table (v8 backward, known-base forward): one (2,) int32 row
        [occ_c, packed_word] per (16-base sub-block, base) — a single-base
        rank is ONE cheap row gather (build_o2, backward8.py)."""
        if getattr(self, "_o2", None) is None:
            from mpibwa_tpu.ops.backward8 import build_o2

            self._o2 = self._put(build_o2(self._host_bwt))
        return self._o2

    def occ4_cols(self, ks: jnp.ndarray) -> jnp.ndarray:
        """(E,) int positions (negative = sentinel -1) -> (4, E) idt.

        Column-layout variant of occ4 (bwt_occ4 semantics, bwt.c:169-186)
        used by the contiguous backward engine (seeding_flat.contig).
        Blocks are gathered ROW-major (one contiguous 32-byte slice per
        index) and transposed on device so the arithmetic and outputs run
        in (4/8, E) column layout."""
        sent = ks < 0
        k = jnp.where(sent, 0, ks)
        k = k - (k >= self.primary)
        blk = (k >> 7).astype(jnp.int32)
        within = (k & 127).astype(jnp.int32)
        words = jnp.transpose(self.data[blk])  # (8, E) uint32
        widx = jnp.arange(8, dtype=jnp.int32)[:, None]
        nvalid = jnp.clip(within[None, :] + 1 - widx * 16, 0, 16)  # (8, E)
        half = (16 - nvalid).astype(jnp.uint32)
        v = jnp.uint32(1) << half
        mask = ~(v * v - jnp.uint32(1))
        w = words & mask
        nw = ~w
        cnts = []
        for c in range(4):
            a = (w if c & 2 else nw) >> 1
            b = w if c & 1 else nw
            m = a & b & M55
            cnts.append(_popcount_pairs(m).sum(axis=0))
        cnt = jnp.stack(cnts, axis=0)  # (4, E) int32
        corr = (16 - nvalid).sum(axis=0)
        cnt = cnt.at[0].add(-corr)
        out = (jnp.transpose(self.occ[blk]) + cnt).astype(self.idt)
        return jnp.where(sent[None, :], jnp.asarray(0, self.idt), out)

    def occ4_cols16(self, ks: jnp.ndarray) -> jnp.ndarray:
        """occ4_cols through the O2 layout (one sub-block row gather per
        position vs occ4_cols' 8-word block scan over the original tables)
        then a transpose to the (4, E) column contract. Bit-identical."""
        return jnp.transpose(self.occ4_16(ks))

    def extend_back1(self, k, l, s, c):
        """Backward-extend (E,) intervals by per-entry base c (0..3);
        single-char analog of extend(is_back=1) (bwt_extend, bwt.c:262-275)
        in column layout. Garbage c for masked entries is harmless.
        Rank rides the O2 table when built (always, in __init__-constructed
        indexes) so the exact flat engine never touches the original
        occ/data blocks — they stay host-side (see __init__)."""
        cols = (self.occ4_cols16 if getattr(self, "_o2", None) is not None
                else self.occ4_cols)
        kq = k - 1
        tk = cols(kq)  # (4, E)
        tl = cols(kq + s)
        x2 = tl - tk
        add = ((k <= self.primary)
               & (k + s - 1 >= self.primary)).astype(self.idt)
        l3 = l + add
        lb2 = l3 + x2[3]
        lb1 = lb2 + x2[2]
        lb0 = lb1 + x2[1]

        def pick(v0, v1, v2_, v3):
            return jnp.where(c == 0, v0, jnp.where(c == 1, v1,
                             jnp.where(c == 2, v2_, v3)))

        kc = pick(self.L2[0], self.L2[1], self.L2[2], self.L2[3]) + 1 \
            + pick(tk[0], tk[1], tk[2], tk[3])
        sc = pick(x2[0], x2[1], x2[2], x2[3])
        lc = pick(lb0, lb1, lb2, l3)
        return kc, lc, sc

    def ref_base(self, pos: jnp.ndarray) -> jnp.ndarray:
        """Reference base at doubled-coordinate pos (bns_get_seq semantics:
        positions >= l_pac are the reverse complement strand). pos clipped
        into range; caller masks invalid lanes."""
        is_rev = pos >= self.l_pac
        p = jnp.where(is_rev, 2 * self.l_pac - 1 - pos, pos)
        p = jnp.clip(p, 0, self.l_pac - 1)
        byte = self.pac[(p >> 2).astype(jnp.int32)]
        shift = (((~p) & 3) << 1).astype(jnp.uint32)
        b = ((byte >> shift) & jnp.uint8(3)).astype(jnp.int32)
        return jnp.where(is_rev, 3 - b, b)

    # -- batched occ4 --------------------------------------------------------

    def occ4(self, ks: jnp.ndarray) -> jnp.ndarray:
        """(...,) int positions (negative = sentinel -1) -> (..., 4) idt.

        SWAR formulation of bwt_occ4: per 16-base word, count base c with the
        __occ_aux bit trick; positions past k are masked off and the base-0
        overcount corrected, mirroring bwt.c:183-184."""
        sent = ks < 0
        k = jnp.where(sent, 0, ks)
        k = k - (k >= self.primary)
        blk = (k >> 7).astype(jnp.int32)
        within = (k & 127).astype(jnp.int32)
        words = self.data[blk]  # (..., 8) uint32
        widx = jnp.arange(8, dtype=jnp.int32)
        nvalid = jnp.clip(within[..., None] + 1 - widx * 16, 0, 16)  # (..., 8)
        # mask = ~((1 << (32 - 2*nvalid)) - 1) in pure uint32: split the
        # shift in half and square so the nvalid==0 case wraps to 0 exactly
        # (2^32 mod 2^32) instead of needing emulated uint64 shifts
        half = (16 - nvalid).astype(jnp.uint32)  # shift/2; shift is even
        v = jnp.uint32(1) << half
        mask = ~(v * v - jnp.uint32(1))
        w = words & mask
        nw = ~w
        cnts = []
        for c in range(4):
            a = (w if c & 2 else nw) >> 1
            b = w if c & 1 else nw
            m = a & b & M55
            cnt = _popcount_pairs(m).sum(axis=-1)
            cnts.append(cnt)
        cnt = jnp.stack(cnts, axis=-1)  # (..., 4) int32
        corr = (16 - nvalid).sum(axis=-1)
        cnt = cnt.at[..., 0].add(-corr)
        out = (self.occ[blk] + cnt).astype(self.idt)
        return jnp.where(sent[..., None], jnp.asarray(0, self.idt), out)

    def occ4_16(self, ks: jnp.ndarray) -> jnp.ndarray:
        """occ4 through the O2 layout (one [occ_c, word] row per sub-block
        and base): per position a (..., 4)-wide row gather (the 4 rows of
        one sub-block) + multiply-free SWAR — vs occ4's 8-word block scan
        with multiply popcounts. Bit-identical to occ4. The all-4-counts
        engines that call this (extend(), the exact flat fallbacks) gather
        four rows per position; a second table for them would double the
        index's device memory, and the default engines never query more
        than one base per position."""
        o2 = self.o2_tables()
        sent = ks < 0
        k = jnp.where(sent, 0, ks)
        k = k - (k >= self.primary)
        sb = (k >> 4).astype(jnp.int32)
        within = (k & 15).astype(jnp.int32)
        rows = o2[(sb[..., None] << 2)
                  + jnp.arange(4, dtype=jnp.int32)]  # (..., 4, 2)
        base = rows[..., 0]
        sh = (jnp.int32(30) - jnp.int32(2) * within).astype(jnp.uint32)
        keep = ~((jnp.uint32(1) << sh) - jnp.uint32(1))
        w = jax.lax.bitcast_convert_type(rows[..., 0, 1], jnp.uint32) & keep
        nw = ~w
        cnts = []
        for c in range(4):
            a = (w if c & 2 else nw) >> 1
            b = w if c & 1 else nw
            m = a & b & M55
            x = (m & M33) + ((m >> 2) & M33)
            x = (x + (x >> 4)) & M0F
            cnt = ((x + (x >> 8) + (x >> 16) + (x >> 24))
                   & jnp.uint32(0x3F)).astype(jnp.int32)
            cnts.append(cnt)
        cnt = jnp.stack(cnts, axis=-1)
        cnt = cnt.at[..., 0].add(-(jnp.int32(15) - within))
        out = (base + cnt).astype(self.idt)
        return jnp.where(sent[..., None], jnp.asarray(0, self.idt), out)

    def _occ4_dispatch(self, ks: jnp.ndarray) -> jnp.ndarray:
        import os

        # occ4_16 is dtype-generic (gather index k>>4 and the counts fit
        # int32 for every supported genome; only k itself may be int64)
        if os.environ.get("MPIBWA_OCC", "occ16") == "occ16":
            return self.occ4_16(ks)
        return self.occ4(ks)

    def bwt_b0(self, k: jnp.ndarray) -> jnp.ndarray:
        """Base at position k of the $-removed BWT (bwt_B0). k >= 0."""
        blk = (k >> 7).astype(jnp.int32)
        within = (k & 127).astype(jnp.int32)
        word = self.data[blk, within >> 4]
        shift = ((~within & 15) << 1).astype(jnp.uint32)
        return ((word >> shift) & jnp.uint32(3)).astype(jnp.int32)

    # -- batched bidirectional extension (bwt_extend, bwt.c:262-275) ---------

    def extend(self, ik: jnp.ndarray, is_back: int) -> jnp.ndarray:
        """ik: (..., 3) idt intervals -> ok: (..., 4, 3) for the 4 bases."""
        col = 0 if is_back else 1  # x[!is_back]
        oth = 1 - col
        kq = ik[..., col] - 1
        # both positions ride one occ query (fewer gather launches)
        both = self._occ4_dispatch(
            jnp.concatenate([kq[..., None], (kq + ik[..., 2])[..., None]],
                            axis=-1))
        tk = both[..., 0, :]
        tl = both[..., 1, :]
        okx2 = tl - tk
        ok_main = self.L2[:4] + 1 + tk
        add = ((ik[..., col] <= self.primary)
               & (ik[..., col] + ik[..., 2] - 1 >= self.primary)).astype(self.idt)
        ok3 = ik[..., oth] + add
        okb2 = ok3 + okx2[..., 3]
        okb1 = okb2 + okx2[..., 2]
        okb0 = okb1 + okx2[..., 1]
        ok_oth = jnp.stack([okb0, okb1, okb2, ok3], axis=-1)
        parts = [None, None, None]
        parts[col] = ok_main
        parts[oth] = ok_oth
        parts[2] = okx2
        return jnp.stack(parts, axis=-1)

    def extend1_fwd(self, ik0, ik1, ik2, cb):
        """Forward-extend intervals (ik0, ik1, ik2) by per-entry COMPLEMENT
        base cb (the bwt_extend is_back=0 row actually consumed — callers
        pass cb = 3 - q[i]); returns (ik0', ik1', ik2'). Exactly
        ok[cb] of extend(ik, 0) (bwt_extend, bwt.c:262-275), but computes
        ONLY the chosen row: the cascade term x[0]' - x[0] - adj =
        sum_{b>cb} (tl_b - tk_b) = G_{cb+1}(lq) - G_{cb+1}(kq) with
        G_c(k) = sum_{b>=c} occ_b(k), and G falls out of the identity
        sum_b occ_b(k) = k+1 (shifted coords) with at most ONE extra
        single-base rank: G_1 = k+1 - occ_0, G_2 = k+1 - occ_0 - occ_1,
        G_3 = occ_3, G_4 = 0. So one 4-wide O2 row gather replaces
        extend()'s two 8-word OCC16 rows AND the (…, 4, 3) select
        machinery. Shape-generic; positions may be int64 (the identity
        arithmetic rides the index dtype, never int32 counts)."""
        from mpibwa_tpu.ops.backward8 import _count_prefix

        o2 = self.o2_tables()
        idt = self.idt
        I0_ = jnp.asarray(0, idt)
        kq = ik1 - 1
        lq = kq + ik2
        # extra base whose rank completes G_{cb+1}: occ_0 for cb==1,
        # occ_3 for cb==2; cb==0/3 need none (gather a dummy, masked off)
        eb = jnp.where(cb == 1, np.int32(0), np.int32(3))
        W = kq.shape[-1]
        ks4 = jnp.concatenate([kq, lq, kq, lq], axis=-1)
        c4 = jnp.concatenate([cb, cb, eb, eb], axis=-1)
        sent = ks4 < I0_
        k = jnp.where(sent, I0_, ks4)
        k = k - (k >= self.primary).astype(k.dtype)
        sb = (k >> 4).astype(jnp.int32)
        within = (k & np.int32(15)).astype(jnp.int32)
        row = o2[(sb << 2) + c4]  # (..., 4W, 2) int32
        occ4w = jnp.where(sent, np.int32(0),
                          row[..., 0] + _count_prefix(row[..., 1], c4,
                                                      within))
        # chars <= position in shifted coords (0 at the sentinel)
        tot4w = jnp.where(sent, I0_, (k + 1).astype(idt))
        tkc = occ4w[..., :W]
        tlc = occ4w[..., W : 2 * W]
        ek = occ4w[..., 2 * W : 3 * W].astype(idt)
        el = occ4w[..., 3 * W :].astype(idt)
        totk = tot4w[..., :W]
        totl = tot4w[..., W : 2 * W]

        def g_term(tot, occ_c, occ_e):
            # G_{cb+1}(pos) by cb: 0 -> tot-occ_0(=occ_c); 1 -> tot-occ_0
            # (=occ_e)-occ_1(=occ_c); 2 -> occ_3(=occ_e); 3 -> 0
            return jnp.where(
                cb == 0, tot - occ_c,
                jnp.where(cb == 1, tot - occ_e - occ_c,
                          jnp.where(cb == 2, occ_e, I0_)))

        gk = g_term(totk, tkc.astype(idt), ek)
        gl = g_term(totl, tlc.astype(idt), el)
        s2 = (tlc - tkc).astype(idt)
        k1n = self.L2[jnp.clip(cb, 0, 3)] + 1 + tkc.astype(idt)
        add = ((ik1 <= self.primary)
               & (ik1 + ik2 - 1 >= self.primary)).astype(idt)
        k0n = ik0 + add + (gl - gk)
        return k0n, k1n, s2

    # -- batched set_intv ----------------------------------------------------

    def set_intv(self, c: jnp.ndarray) -> jnp.ndarray:
        """(N,) base codes (<4) -> (N,3) initial single-base intervals."""
        x0 = self.L2[c] + 1
        x2 = self.L2[c + 1] - self.L2[c]
        x1 = self.L2[3 - c] + 1
        return jnp.stack([x0, x1, x2], axis=-1)

    # -- batched SA lookup (bwt_sa, bwt.c:86-96) -----------------------------

    def sa_lookup(self, ks: jnp.ndarray) -> jnp.ndarray:
        """(N,) idt SA indices -> (N,) idt positions.

        Routes through the O2 table in (8, W) layout — one single-base
        rank ROW gather per inv_psi step instead of a full occ4. Position
        arithmetic runs in the index dtype (int64 for
        GRCh38-scale); gathers and counts stay int32 either way."""
        if getattr(self, "_o2", None) is not None:
            N = int(ks.shape[0])
            Np = ((N + 7) // 8) * 8
            ks_p = jnp.zeros(Np, self.idt).at[:N].set(ks.astype(self.idt))
            out = _sa_lookup16(
                self.o2_tables(), self.L2.astype(self.idt),
                self.np_idt(self.primary), self.np_idt(self.seq_len),
                self.sa, self.np_idt(self.sa_intv),
                ks_p.reshape(8, Np // 8))
            return out.reshape(Np)[:N]
        mask = self.sa_intv - 1
        ks = ks.astype(self.idt)

        def inv_psi(k):
            x = k - (k > self.primary)
            c = self.bwt_b0(x)
            occ_all = self.occ4(k)
            occc = jnp.take_along_axis(occ_all, c[:, None].astype(jnp.int64),
                                       axis=1)[:, 0]
            at_end = k == self.seq_len
            occc = jnp.where(at_end, self.L2[c + 1] - self.L2[c], occc)
            val = self.L2[c] + occc
            return jnp.where(k == self.primary, jnp.asarray(0, self.idt), val)

        def cond(state):
            k, _, act = state
            return jnp.any(act)

        def body(state):
            k, steps, act = state
            k2 = inv_psi(k)
            k = jnp.where(act, k2, k)
            steps = steps + act.astype(self.idt)
            act = (k & mask) != 0
            return k, steps, act

        steps0 = jnp.zeros_like(ks)
        act0 = (ks & mask) != 0
        k, steps, _ = jax.lax.while_loop(cond, body, (ks, steps0, act0))
        base = self.sa[(k // self.sa_intv).astype(jnp.int32)]
        return steps + base  # sa[0] == -1 wraps exactly like the C uint64


# Register as a pytree: the index arrays trace as ARGUMENTS, not as HLO
# constants — otherwise every kernel compile embeds megabytes of index data
# and the persistent compilation cache becomes index-specific.
# The un-materialized placeholders are NUMPY constants: flatten may run
# inside a trace (fm crossing into an inner jit), where a jnp.zeros would
# be a tracer and caching it would leak it out of the transform.
_EMPTY_OCC = np.zeros((0, 4), np.int32)
_EMPTY_DATA = np.zeros((0, 8), np.uint32)
_EMPTY_O2 = np.zeros((0, 2), np.int32)


def _dfm_flatten(fm: DeviceFMIndex):
    o2 = getattr(fm, "_o2", None)
    if o2 is None:
        o2 = _EMPTY_O2
        has_o2 = False
    else:
        has_o2 = True
    # un-materialized occ/data ride as 0-size numpy placeholders (the
    # default engines never touch them; materialization is host-side lazy)
    occ, data = fm._occ, fm._data
    if occ is None:
        occ = _EMPTY_OCC
    if data is None:
        data = _EMPTY_DATA
    leaves = (occ, data, fm.L2, fm.sa, fm.pac, o2)
    aux = (fm.primary, fm.seq_len, fm.sa_intv, fm.l_pac,
           "i32" if fm.np_idt == np.int32 else "i64", has_o2,
           fm._occ is not None, fm._data is not None)
    return leaves, aux


def _dfm_unflatten(aux, leaves):
    obj = object.__new__(DeviceFMIndex)
    (occ, data, obj.L2, obj.sa, obj.pac, o2) = leaves
    (obj.primary, obj.seq_len, obj.sa_intv, obj.l_pac, idt, has_o2,
     has_occ, has_data) = aux
    obj._occ = occ if has_occ else None
    obj._data = data if has_data else None
    obj._o2 = o2 if has_o2 else None
    if idt == "i32":
        obj.idt, obj.np_idt = jnp.int32, np.int32
    else:
        obj.idt, obj.np_idt = jnp.int64, np.int64
    obj.sa_lookup_jit = lambda ks: _sa_lookup_jit(obj, ks)
    return obj


jax.tree_util.register_pytree_node(DeviceFMIndex, _dfm_flatten, _dfm_unflatten)


@jax.jit
def _sa_lookup16(tables, l2, primary, seq_len, sa, sa_intv, ks2d):
    """bwt_sa walk (bwt.c:86-96) in (8, W) layout via the O2 table: per
    step one row gather for the BWT base word + one single-base rank row
    gather (_occ_c2). Dtype-generic: positions (ks2d/l2/primary/seq_len/
    sa) in int32 or int64; gathers and rank counts stay int32 either way."""
    from mpibwa_tpu.ops.backward8 import _occ_c2

    o2 = tables
    idt = ks2d.dtype
    mask = sa_intv - 1  # sa_intv is a power of two; np scalar of idt
    I0 = np.int32(0)

    def bwt_b0_o2(x):
        word = jax.lax.bitcast_convert_type(
            o2[(x >> 4).astype(jnp.int32) << 2][..., 1], jnp.uint32)
        sh = ((~x).astype(jnp.int32) & np.int32(15)) << 1
        return ((word >> sh.astype(jnp.uint32))
                & jnp.uint32(3)).astype(jnp.int32)

    def inv_psi(k):
        x = k - (k > primary).astype(idt)
        c = bwt_b0_o2(x)
        occc = _occ_c2(o2, primary, k, c)
        at_end = k == seq_len
        occc = jnp.where(at_end, (l2[c + 1] - l2[c]).astype(jnp.int32),
                         occc)
        val = l2[c] + occc.astype(idt)
        return jnp.where(k == primary, jnp.zeros_like(val), val)

    def cond(state):
        return jnp.any(state[2])

    def body(state):
        k, steps, act = state
        k2 = inv_psi(k)
        k = jnp.where(act, k2, k)
        steps = steps + act.astype(idt)
        act = (k & mask) != I0
        return k, steps, act

    ks = ks2d
    steps0 = jnp.zeros_like(ks)
    act0 = (ks & mask) != I0
    k, steps, _ = jax.lax.while_loop(cond, body, (ks, steps0, act0))
    base = sa[(k // sa_intv).astype(jnp.int32)].astype(idt)
    return steps + base  # sa[0] == -1 wraps exactly like the C uint64


@jax.jit
def _sa_lookup_jit(fm: DeviceFMIndex, ks):
    return fm.sa_lookup(ks)
