"""Test configuration: CPU-only JAX with 8 virtual devices for sharding
tests, and a generated genome, index and read set (mpibwa_tpu/io/simulate.py)
as the input of every differential test.

Must set flags before jax is imported anywhere.
"""

import os
import pathlib
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# no persistent compile cache in tests or the shard processes they start:
# every run compiles for this host
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import pytest  # noqa: E402

GOLDEN = REPO / "tests" / "golden"

# The generated test genome: two contigs (multi-contig paths: by-chromosome
# output, discordant pairs), ~3 Mbp like the hg19.small index the goldens
# were made from, half repeats.
SIM_GENOME = dict(contig_lengths=(2_500_000, 500_000), seed=7)
SIM_PAIRS = 2000


@pytest.fixture(scope="session")
def sim(tmp_path_factory):
    """{ref, r1, r2}: generated FASTA with its bwa index files, and
    SIM_PAIRS 2x150 pairs (one copy per test worker)."""
    from mpibwa_tpu.index.build import build_index
    from mpibwa_tpu.io import simulate as S

    d = tmp_path_factory.mktemp("sim")
    fa, r1, r2 = S.make_dataset(str(d), S.GenomeSpec(**SIM_GENOME),
                                SIM_PAIRS, read_seed=7)
    build_index(fa)
    return {"ref": fa, "r1": r1, "r2": r2}


@pytest.fixture(scope="session")
def idx_prefix(sim):
    return sim["ref"]


@pytest.fixture(scope="session")
def index(idx_prefix):
    from mpibwa_tpu.index import format as fmt

    return fmt.load_index(idx_prefix)


@pytest.fixture(scope="session")
def r1_path(sim):
    return sim["r1"]


@pytest.fixture(scope="session")
def r2_path(sim):
    return sim["r2"]


@pytest.fixture(scope="session")
def golden_dir():
    return GOLDEN


# -- the bwa-mem goldens ----------------------------------------------------
# tests/golden/*.sam are bwa-mem 0.7.17's output for the HCC1187C reads on
# the hg19.small index. Neither input is in this repository; a directory
# holding hg19.small.tar.gz and the HCC1187C FASTQs can be named with
# MPIBWA_GOLDEN_DATA to run those tests.


@pytest.fixture(scope="session")
def golden_data():
    d = os.environ.get("MPIBWA_GOLDEN_DATA")
    if not d or not (pathlib.Path(d) / "hg19.small.tar.gz").exists():
        pytest.skip("needs the hg19.small index and HCC1187C reads the "
                    "goldens were made from (not in the repository; set "
                    "MPIBWA_GOLDEN_DATA)")
    return pathlib.Path(d)


@pytest.fixture(scope="session")
def golden_prefix(golden_data, tmp_path_factory):
    import tarfile

    d = tmp_path_factory.mktemp("hg19small")
    with tarfile.open(golden_data / "hg19.small.tar.gz") as tf:
        tf.extractall(d)
    return str(d / "hg19.small.fa")


@pytest.fixture(scope="session")
def golden_index(golden_prefix):
    from mpibwa_tpu.index import format as fmt

    return fmt.load_index(golden_prefix)


@pytest.fixture(scope="session")
def golden_fastq(golden_data):
    """name -> path of one of the HCC1187C FASTQs."""
    return lambda name: str(golden_data / name)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running full-dataset tests")
    config.addinivalue_line(
        "markers",
        "huge: GRCh38-scale (>=2^31 positions) builds, ~40 min + ~60 GB RAM")


def pytest_collection_modifyitems(config, items):
    """slow and huge tests run only when -m names them: a marker
    expression such as "not slow" must not start a ~60 GB huge build."""
    mexpr = config.getoption("-m", default="") or ""
    skip = pytest.mark.skip(reason="slow; run with -m slow")
    skip_huge = pytest.mark.skip(reason="huge; run with -m huge")
    for item in items:
        if "huge" in item.keywords and "huge" not in mexpr:
            item.add_marker(skip_huge)
        elif "slow" in item.keywords and "slow" not in mexpr:
            item.add_marker(skip)
