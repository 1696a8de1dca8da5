"""Platform dispatch, compile cache and local card discovery.

Every choice that depends on the machine is made here, by name:

- the backward-SMEM engine per JAX platform (`gpu` -> v8, `cpu` -> the
  exact flat engine; any other platform is refused, not guessed);
- the persistent compile cache: `JAX_COMPILATION_CACHE_DIR` when set
  (JAX reads it itself), otherwise one fixed directory, `.jax_cache/` at
  the root of the checkout (git-ignored);
- which NVIDIA cards this host has, for one-process-per-card launches.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

BACKWARD_ENGINES = {"gpu": "v8", "cpu": "flat"}
_FORCED = ("v8", "flat", "contig")

CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def engine_for_platform(platform: str) -> str:
    try:
        return BACKWARD_ENGINES[platform]
    except KeyError:
        raise RuntimeError(
            f"no device engine for JAX platform {platform!r}; supported: "
            f"{', '.join(sorted(BACKWARD_ENGINES))}") from None


def backward_engine() -> str:
    """The backward-SMEM engine for this process: MPIBWA_BWD=v8|flat|contig
    forces one (the differential tests do); auto picks by platform."""
    mode = os.environ.get("MPIBWA_BWD", "auto")
    if mode == "auto":
        import jax

        return engine_for_platform(jax.default_backend())
    if mode not in _FORCED:
        raise ValueError(f"MPIBWA_BWD must be auto or one of {_FORCED}, "
                         f"got {mode!r}")
    return mode


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


def local_gpus() -> list:
    """CUDA_VISIBLE_DEVICES ids of the NVIDIA cards that processes started
    from here may use: empty when the JAX platform is pinned to the CPU or
    no driver answers. Asks nvidia-smi, so the caller never opens a card."""
    plat = os.environ.get("JAX_PLATFORMS", "")
    if plat and not any(p in plat for p in ("cuda", "gpu")):
        return []
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    n = sum(1 for ln in out.splitlines() if ln.startswith("GPU "))
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return [v.strip() for v in vis.split(",") if v.strip()][:n]
    return [str(i) for i in range(n)]
