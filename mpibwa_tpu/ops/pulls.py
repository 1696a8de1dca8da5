"""Device->host transfer helpers.

Pulling a data-dependent prefix of a device array (``np.asarray(x[:n])``)
lowers to a slice op whose length is baked into the executable — every
distinct ``n`` costs a fresh XLA compile. Quantizing the slice length to
a power of two keeps the per-process compile count at log2(range) while
bounding the extra bytes at 2x of an already-sparse array. (Whether the
bucketing still pays on the H100 is not measured yet.)
"""

from __future__ import annotations

import numpy as np


def pull_prefix(dev, n: int, min_cap: int = 256) -> np.ndarray:
    """Transfer rows [0, n) of ``dev`` with a pow2-bucketed device slice."""
    if n <= 0:
        return np.zeros((0,) + tuple(dev.shape[1:]), dev.dtype)
    total = int(dev.shape[0])
    cap = max(min_cap, 1 << (int(n) - 1).bit_length())
    if cap >= total:
        return np.asarray(dev)[:n]
    return np.asarray(dev[:cap])[:n]


def pull_prefix_async(dev, n: int, min_cap: int = 256):
    """Start the [0, n) transfer without blocking; returns a thunk that
    yields the ndarray. The device->host copy proceeds while the caller
    dispatches and waits on OTHER device work, so a pull scheduled before
    a long kernel chain is free by the time the thunk is called."""
    if n <= 0:
        empty = np.zeros((0,) + tuple(dev.shape[1:]), dev.dtype)
        return lambda: empty
    total = int(dev.shape[0])
    cap = max(min_cap, 1 << (int(n) - 1).bit_length())
    sl = dev if cap >= total else dev[:cap]
    try:
        sl.copy_to_host_async()
    except AttributeError:
        pass  # backend without async copies: the thunk blocks instead
    return lambda: np.asarray(sl)[:n]
