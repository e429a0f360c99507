"""Overlap-save framing: stream -> overlapped FFT blocks, batched.

The reference implements this as a stateful per-item memcpy block
(reference: lib/overlap_save_impl.cc:62-81): each output block of
``blocksize`` samples is the previous ``ovllen`` samples (history) followed
by ``blocksize - ovllen`` new samples. Here the whole batch of B blocks is
produced by one static gather from the concatenated [hist | new] buffer —
a single fused XLA op instead of B memcpys, with the history carried
explicitly as part of the step's carry pytree.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["frame_blocks", "initial_history", "vector_cut"]


def vector_cut(x: jax.Array, veclen: int, offset: int, blocklen: int) -> jax.Array:
    """Per-item slice: from each length-``veclen`` vector of a flat stream,
    keep ``blocklen`` items starting at ``offset``.

    Standalone equivalent of the reference's type-generic vector_cut_vxx
    block (reference: lib/vector_cut_vxx_impl.cc:59-72); inside the fused
    extraction paths this is just a slice, but the public op mirrors the
    reference API for direct use.

    x: [..., n*veclen] -> [..., n*blocklen]
    """
    if not (0 <= offset and offset + blocklen <= veclen):
        raise ValueError(
            f"invalid cut: offset={offset} blocklen={blocklen} veclen={veclen}"
        )
    lead = x.shape[:-1]
    n = x.shape[-1] // veclen
    v = x.reshape(*lead, n, veclen)[..., offset: offset + blocklen]
    return v.reshape(*lead, n * blocklen)


def initial_history(ovllen: int, dtype=jnp.complex64) -> jax.Array:
    """Zero history, matching the reference's zero-initialized hist buffer
    (reference: lib/overlap_save_impl.cc:52)."""
    return jnp.zeros((ovllen,), dtype=dtype)


def frame_blocks(x: jax.Array, hist: jax.Array, blocksize: int):
    """Frame a flat sample batch into overlapped blocks.

    Args:
      x: [B * inplen] new samples, where inplen = blocksize - len(hist).
      hist: [ovllen] trailing samples of the previous batch.
      blocksize: output block length N.

    Returns:
      (blocks [B, blocksize], new_hist [ovllen]): block b covers samples
      [b*inplen - ovllen, (b+1)*inplen) of the extended stream, i.e. carries
      ovllen samples of history like the reference block
      (reference: lib/overlap_save_impl.cc:70-78).
    """
    ovllen = hist.shape[0]
    inplen = blocksize - ovllen
    total = x.shape[0]
    if total % inplen:
        raise ValueError(
            f"sample count {total} must be a multiple of inplen={inplen}"
        )
    nblocks = total // inplen

    if ovllen <= inplen:
        # Fast path (any relinvovl >= 2): each block's history prefix is the
        # tail of the previous block's input run, so framing is pure layout —
        # reshape + two concats, no gather.
        xr = x.reshape(nblocks, inplen)
        tails = xr[:, inplen - ovllen:]  # [B, ovllen]
        prev = jnp.concatenate([hist[None], tails[:-1]], axis=0)
        blocks = jnp.concatenate([prev, xr], axis=1)
        return blocks, tails[-1]

    # General path (overlap longer than the input run): strided gather.
    ext = jnp.concatenate([hist, x])  # [ovllen + B*inplen]
    idx = (
        jnp.arange(nblocks, dtype=jnp.int32)[:, None] * inplen
        + jnp.arange(blocksize, dtype=jnp.int32)[None, :]
    )
    blocks = jnp.take(ext, idx, axis=0)
    new_hist = jax.lax.dynamic_slice_in_dim(ext, nblocks * inplen, ovllen)
    return blocks, new_hist
