"""Platform dispatch, compile-cache placement, card discovery and the
one-process-per-card rule of `cli launch`."""

import os
import stat
import subprocess

import numpy as np
import pytest

from mpibwa_tpu import devices


@pytest.mark.parametrize("platform,engine", [("gpu", "v8"), ("cpu", "flat")])
def test_engine_for_platform(platform, engine):
    assert devices.engine_for_platform(platform) == engine


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron", ""])
def test_engine_for_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no device engine"):
        devices.engine_for_platform(platform)


def test_backward_engine_auto_and_forced(monkeypatch):
    monkeypatch.delenv("MPIBWA_BWD", raising=False)
    assert devices.backward_engine() == "flat"  # the CPU test backend
    for mode in ("v8", "flat", "contig"):
        monkeypatch.setenv("MPIBWA_BWD", mode)
        assert devices.backward_engine() == mode
    monkeypatch.setenv("MPIBWA_BWD", "pallas")
    with pytest.raises(ValueError):
        devices.backward_engine()


def test_compile_cache_placement(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        jax.config.update("jax_compilation_cache_dir", None)
        assert devices.enable_compile_cache() == str(tmp_path)
        # the variable is JAX's own: nothing is set in code
        assert jax.config.jax_compilation_cache_dir is None
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        got = devices.enable_compile_cache()
        assert got == str(devices.CACHE_DIR)
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    repo = devices.CACHE_DIR.parent
    assert (repo / "mpibwa_tpu").is_dir()
    ignored = (repo / ".gitignore").read_text().split()
    assert devices.CACHE_DIR.name + "/" in ignored


def _fake_nvidia_smi(tmp_path, n):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    exe = bindir / "nvidia-smi"
    lines = "".join(f"echo 'GPU {i}: NVIDIA H100 80GB HBM3 (UUID: x)'\n"
                    for i in range(n))
    exe.write_text("#!/bin/sh\n" + lines)
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    return str(bindir)


def test_local_gpus(monkeypatch, tmp_path):
    assert devices.local_gpus() == []  # JAX_PLATFORMS=cpu in the tests
    bindir = _fake_nvidia_smi(tmp_path, 4)
    monkeypatch.setenv("PATH", bindir + os.pathsep + os.environ["PATH"])
    monkeypatch.delenv("JAX_PLATFORMS")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert devices.local_gpus() == ["0", "1", "2", "3"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    assert devices.local_gpus() == ["3", "5"]
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    assert devices.local_gpus() == ["3", "5"]


class _FakeProc:
    def __init__(self, cmd, env=None):
        self.env = env

    def wait(self):
        return 3  # stop main_launch before its merge


def test_launch_pins_one_card_per_shard(monkeypatch, tmp_path):
    from mpibwa_tpu import cli

    monkeypatch.setattr(devices, "local_gpus", lambda: ["0", "1"])
    started = []
    monkeypatch.setattr(subprocess, "Popen",
                        lambda cmd, env=None: started.append(env)
                        or _FakeProc(cmd, env))
    rc = cli.main(["launch", "-n", "2", "mem", "-o", str(tmp_path / "o"),
                   "ref", "r1.fq"])
    assert rc == 3
    assert [e["CUDA_VISIBLE_DEVICES"] for e in started] == ["0", "1"]
    assert [e["MPIBWA_SHARD"] for e in started] == ["0", "1"]


def test_launch_refuses_more_shards_than_cards(monkeypatch, tmp_path,
                                               capsys):
    from mpibwa_tpu import cli

    monkeypatch.setattr(devices, "local_gpus", lambda: ["0"])
    started = []
    monkeypatch.setattr(subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    rc = cli.main(["launch", "-n", "2", "mem", "-o", str(tmp_path / "o"),
                   "ref", "r1.fq"])
    assert rc == 1 and not started
    assert "one shard process per card" in capsys.readouterr().err


def test_standard_mat_ab():
    from mpibwa_tpu.core.opts import fill_scmat
    from mpibwa_tpu.ops.extend_batch import standard_mat_ab

    assert standard_mat_ab(fill_scmat(1, 4)) == (1, 4)
    assert standard_mat_ab(fill_scmat(2, 7)) == (2, 7)
    m = np.array(fill_scmat(1, 4)).reshape(5, 5)
    m[2, 3] = -3
    assert standard_mat_ab(m) is None
