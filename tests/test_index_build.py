"""Index construction vs the bundled bwa-built index files."""

import filecmp

import pytest

from mpibwa_tpu.index.build import LRand48, build_index


def test_lrand48_sequence():
    # POSIX drand48 constants; first values for seed 11
    r = LRand48(11)
    vals = [r.lrand48() for _ in range(4)]
    r2 = LRand48(11)
    assert vals == [r2.lrand48() for _ in range(4)]
    assert all(0 <= v < (1 << 31) for v in vals)


@pytest.mark.slow
def test_build_matches_bwa_index(golden_prefix, tmp_path):
    """All five artifacts byte-identical to the bwa-0.7.17 built files."""
    out = str(tmp_path / "built.fa")
    build_index(golden_prefix, prefix=out)  # the FASTA ships with them
    for ext in (".pac", ".ann", ".amb", ".bwt", ".sa"):
        assert filecmp.cmp(out + ext, golden_prefix + ext,
                           shallow=False), ext


def test_build_small_synthetic(tmp_path):
    """Round-trip: build an index for a small synthetic genome and check the
    loader + FM queries are self-consistent."""
    import numpy as np

    from mpibwa_tpu.core.fm import FMIndex
    from mpibwa_tpu.index.format import load_index, unpack_pac

    rng = np.random.default_rng(3)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 5000))
    seq = seq[:1000] + "NNNN" + seq[1000:]
    fa = tmp_path / "toy.fa"
    fa.write_text(">toy test-comment\n" + "\n".join(
        seq[i : i + 70] for i in range(0, len(seq), 70)) + "\n")
    prefix = str(tmp_path / "toy.fa")
    built = build_index(prefix.replace("toy.fa", "toy.fa"), prefix=prefix)
    idx = load_index(prefix)
    assert idx.primary == built.primary
    assert idx.l_pac == len(seq)
    fm = FMIndex.from_index(idx)
    # every 8-mer of the forward reference must be findable
    ref = unpack_pac(idx.pac, idx.l_pac)
    for start in range(0, len(seq) - 8, 257):
        pat = ref[start : start + 8]
        ik = fm.set_intv(int(pat[-1]))
        ok = True
        for c in pat[-2::-1]:
            res = fm.extend(ik, 1)[int(c)]
            if res[2] <= 0:
                ok = False
                break
            ik = res
        assert ok
        # one of the occurrences must resolve to `start`
        poss = {fm.sa_lookup(ik[0] + i) for i in range(ik[2])}
        assert start in poss


def test_sais_matches_prefix_doubling():
    """Native SA-IS (native/sais.c) vs the numpy prefix-doubling SA on
    random and adversarial strings (runs, periodic, tiny)."""
    import numpy as np

    from mpibwa_tpu.index.build import suffix_array
    from mpibwa_tpu.native import sais_u8

    rng = np.random.default_rng(7)
    cases = [rng.integers(0, int(K), int(n)).astype(np.uint8)
             for n, K in zip(rng.integers(1, 3000, 12),
                             rng.integers(2, 5, 12))]
    cases += [np.zeros(257, np.uint8),
              np.tile([0, 1], 500).astype(np.uint8),
              np.tile([3, 2, 1, 0], 250).astype(np.uint8),
              np.array([1], np.uint8),
              np.array([2, 0], np.uint8)]
    for s in cases:
        got = sais_u8(s)
        if got is None:
            import pytest

            pytest.skip("native lib unavailable")
        want = suffix_array(s)
        assert np.array_equal(got.astype(np.int64), want), len(s)
