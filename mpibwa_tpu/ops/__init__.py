"""Device (JAX) kernels.

Interval arithmetic needs 64-bit (human genome doubled exceeds 2^32), so
importing this package enables jax x64 mode.
"""

import jax

jax.config.update("jax_enable_x64", True)
