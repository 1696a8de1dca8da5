"""chip_smoke.py's phases at a tiny size on the CPU backend (only its
main() insists on a GPU)."""

import os

import pytest

import chip_smoke as C
from mpibwa_tpu.io import simulate as S


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("smoke"))
    return work, C.make_data(work, 400_000, 300, seed=2)


def test_native_phase_builds_from_source(monkeypatch, tmp_path):
    from mpibwa_tpu import native

    lib = tmp_path / "_libmpibwa.so"
    lib.write_bytes(b"not a library")  # a stale copy must not be trusted
    monkeypatch.setattr(native, "_LIB_PATH", str(lib))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert C.build_native() == str(lib)
    assert lib.read_bytes()[:4] == b"\x7fELF"


def test_data_phase(data):
    work, d = data
    for key in ("ref", "r1", "r2"):
        assert os.path.isfile(d[key])
    for ext in (".bwt", ".sa", ".pac", ".ann", ".amb"):
        assert os.path.isfile(d["ref"] + ext)
    assert d["generate_s"] >= 0 and d["index_s"] >= 0
    sub = C.head_fastq(d["r1"], os.path.join(work, "h.fq"), 7)
    assert open(sub).read().count("\n") == 28


def test_main_path_phase(data):
    """cli mem on the pairs, in process: the runtime's summary is read
    back, nothing falls back, and reads align at their origin."""
    work, d = data
    clock = C.CompileClock()
    r = C.run_mem(["-t", "2", "-o", os.path.join(work, "pe"), d["ref"],
                   d["r1"], d["r2"]], clock)
    assert r["rc"] == 0 and r["reads"] == 600 and r["engine"] == "flat"
    assert r["fallback"] / r["reads"] <= C.FALLBACK_MAX
    assert r["compile_s"] >= 0 and r["execute_s"] > 0
    hits, total = S.truth_share(os.path.join(work, "pe.sam"))
    assert total == 600 and hits / total >= C.TRUTH_MIN


def test_reference_phase(data):
    work, d = data
    out = C.compare_reference(d, work, n_se=60, n_pairs=40)
    assert out["se"]["identical"] and out["se"]["records"] >= 60
    assert out["pe"]["identical"] and out["pe"]["records"] >= 80


def test_main_requires_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        C.main(["--genome-bp", "100000", "--pairs", "10"])
    assert e.value.code == 2
    out = capsys.readouterr()
    assert '"ok"' not in out.out and "need 1 GPU" in out.err
