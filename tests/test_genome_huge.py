"""GRCh38-scale (>= 2^31 positions) index build + int64-engine identity.

Separate module from test_genome_scale so `-m slow` does not pull in a
~40 min / ~60 GB build; run with `-m huge`."""

import os
import subprocess

import numpy as np
import pytest

pytestmark = pytest.mark.huge

ORACLE = "/tmp/oracle_build/oracle"


# -- GRCh38-scale: doubled sequence >= 2^31 positions (int64 engines) --------


@pytest.fixture(scope="module")
def huge_prefix(tmp_path_factory):
    """A synthetic genome whose doubled sequence crosses 2^31 positions
    (l_pac = 2^30 + 256 bases -> seq_len = 2^31 + 512), the smallest
    scale that forces the int64 position path end to end: 64-bit SA-IS
    (native/sais.c), int64 DeviceFMIndex, wide v8 backward + O2 rank +
    SA walk. The reference's equivalent scale evidence is the 352-rank
    WGS run against full human (its CHANGELOG)."""
    from mpibwa_tpu.index.build import build_index
    from mpibwa_tpu.native import get_lib

    if get_lib() is None:
        pytest.skip("native sais unavailable")
    td = tmp_path_factory.mktemp("genome2g")
    fa = str(td / "g2g.fa")
    rng = np.random.default_rng(17)
    l_pac = (1 << 30) + 256  # seq_len = 2*l_pac >= 2^31; l_pac % 64 == 0
    with open(fa, "wb") as f:
        f.write(b">c1 synthetic2g\n")
        acgt = np.frombuffer(b"ACGT", np.uint8)
        step = 16_000_000
        left = l_pac
        while left:
            m = min(step, left)
            f.write(acgt[rng.integers(0, 4, m)].tobytes())
            f.write(b"\n")
            left -= m
    idx = build_index(fa)
    assert idx.seq_len >= (1 << 31)
    return fa


def test_genome2g_int64_identity_vs_oracle(huge_prefix, tmp_path,
                                           monkeypatch):
    """BASELINE config 3's single-host slice: reads aligned against a
    >=2^31-position index through the wide device engines, byte-identical
    to the reference engine (oracle)."""
    import jax.numpy as jnp

    # force the wide v8 backward (auto picks the exact flat engine on the
    # CPU test backend; the point here is the int64 fast path)
    monkeypatch.setenv("MPIBWA_BWD", "v8")

    from mpibwa_tpu.core.opts import mem_opt_init
    from mpibwa_tpu.index.format import load_index, unpack_pac
    from mpibwa_tpu.io.fastq import read_fastq
    from mpibwa_tpu.ops.fmd import DeviceFMIndex
    from mpibwa_tpu.pipeline.device_align import DeviceAligner

    if not os.path.exists(ORACLE):
        r = subprocess.run(["bash", "tests/oracle/build.sh"],
                           cwd=os.path.dirname(os.path.dirname(
                               os.path.abspath(__file__))),
                           capture_output=True)
        if r.returncode != 0:
            pytest.skip("oracle build failed")

    idx = load_index(huge_prefix)
    rng = np.random.default_rng(23)
    fwd = unpack_pac(idx.pac, idx.l_pac)
    fq = str(tmp_path / "reads.fastq")
    with open(fq, "w") as f:
        for k in range(300):
            p = int(rng.integers(0, idx.l_pac - 101))
            r = fwd[p : p + 101].copy()
            errs = rng.random(101) < 0.01
            r[errs] = (r[errs] + rng.integers(1, 4)) % 4
            if rng.random() < 0.5:
                r = 3 - r[::-1]
            f.write(f"@r{k}\n{''.join('ACGT'[b] for b in r)}\n+\n{'I'*101}\n")
    del fwd
    want = subprocess.run([ORACLE, "mem", huge_prefix, fq],
                          capture_output=True, text=True, check=True).stdout

    dfm = DeviceFMIndex(idx)
    assert dfm.idt == jnp.int64  # the real int64 path, not forced
    al = DeviceAligner(idx, mem_opt_init(), dfm=dfm)
    reads = read_fastq(fq)
    al.process_seqs(reads, 0)
    got = "".join(s.sam for s in reads)
    assert got == want

    # -- the same slice ON THE GPU (conftest pins this process to the CPU
    # backend, so the hardware half runs as a subprocess with a clean JAX
    # env): int64 index in device memory, default engines, byte-identity;
    # with no GPU the subprocess fails and so does this test
    want_f = tmp_path / "want.sam"
    want_f.write_text(want)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        ["python", os.path.join(repo, "tests", "hw_huge_identity.py"),
         huge_prefix, fq, str(want_f)],
        capture_output=True, text=True, env=env, cwd=repo, timeout=3600)
    sys_err = r.stderr[-2000:]
    assert r.returncode == 0, sys_err
