"""Complex<->float boundary helpers.

A layout choice: all fdc_tpu step functions cross the host boundary as
float32 arrays with a trailing axis of size 2, interleaved exactly like
complex64 memory, so the host-side conversion is a zero-copy ``.view()``
and the matmul-DFT extraction can write its output in this layout directly
(interleaved matrix columns). Complex64 is used freely inside jitted
programs.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["c2f_host", "f2c_host", "c2f", "f2c"]


def c2f_host(x: np.ndarray) -> np.ndarray:
    """Host: complex64 [...] -> float32 [..., 2] (zero-copy when contiguous)."""
    x = np.ascontiguousarray(x, dtype=np.complex64)
    return x.view(np.float32).reshape(*x.shape, 2)


def f2c_host(x: np.ndarray) -> np.ndarray:
    """Host: float32 [..., 2] -> complex64 [...] (zero-copy when contiguous)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    return x.view(np.complex64).reshape(x.shape[:-1])


def c2f(z):
    """Device (inside jit): complex [...] -> float32 [..., 2]."""
    return jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1).astype(jnp.float32)


def f2c(x):
    """Device (inside jit): float32 [..., 2] -> complex64 [...]."""
    return jax.lax.complex(x[..., 0], x[..., 1])
