"""FFT front-end and subband inverse-FFT helpers.

The reference computes, per overlapped block, a full-size fftshifted forward
FFT scaled by 1/N (reference: python/FrequencyDomainChannelizer.py:206,214-216)
and, per channel, an *unnormalized* inverse FFT of the fftshifted windowed
bin slice (reference: lib/SegmentDetection_impl.cc:399-429,649-657). Two
identities keep all of that in single fused batched ops here:

1. ``ifft(fftshift_l(Z))[m] == (-1)^m * ifft(Z)[m]`` for even l, so the
   pre-IFFT fftshift becomes a (-1)^m output modulation and never
   materializes a shuffled copy.

2. A w-point IFFT equals a W-point IFFT (W = q*w, power of 2) of the spectrum
   comb-upsampled by q (bins placed at multiples of q); the W-point output is
   w-periodic. This lets dynamically-sized detection channels of *any*
   power-of-2 width share ONE static-shape batched IFFT of width W
   (``comb_subband_ifft``) — the static-shape replacement for the reference's
   per-channel variable-size FFTW plans
   (reference: lib/SegmentDetection_impl.cc:404).
"""

from __future__ import annotations

import functools
import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "DFT_PRECISION",
    "dft_matmul",
    "forward_spectrum",
    "forward_spectrum_mxu",
    "subband_ifft",
    "comb_subband_ifft",
    "interp_subband_ifft",
    "subband_ifft_mxu",
    "interp_subband_ifft_mxu",
]


# Precision of every DFT matmul (the four-step forward transform and the
# subband transforms). On the GPU, DEFAULT and HIGH round float32 operands
# to TF32 (11 significant bits, ~1e-3 relative error), looser than the
# stream contract (rtol 2e-4 / atol 2e-5); HIGHEST keeps float32. PERF.md
# records the measured error and cost of each choice on the card.
DFT_PRECISION = jax.lax.Precision.HIGHEST


def dft_matmul(a: jax.Array, b: jax.Array) -> jax.Array:
    """Float32 matmul at :data:`DFT_PRECISION` (batch dims broadcast)."""
    return jnp.matmul(
        a, b, precision=DFT_PRECISION, preferred_element_type=jnp.float32
    )


def forward_spectrum(blocks: jax.Array, use_mxu: bool = False) -> jax.Array:
    """Batched forward FFT with fftshifted output and 1/N scaling.

    blocks: [..., N] complex -> [..., N] complex spectrum, DC at bin N/2,
    bin b at normalized FDC frequency b/N
    (reference: python/FrequencyDomainChannelizer.py:206,214-216).

    use_mxu routes to :func:`forward_spectrum_mxu` (the ``use_mxu_fft``
    config knob) for N >= 256; smaller transforms stay on the FFT path.
    """
    if use_mxu and blocks.shape[-1] >= 256:
        return forward_spectrum_mxu(blocks)
    n = blocks.shape[-1]
    spec = jnp.fft.fft(blocks, axis=-1)
    spec = jnp.fft.fftshift(spec, axes=-1)
    return spec * (1.0 / n)


@functools.lru_cache(maxsize=None)
def _four_step_matrices(n: int):
    """Constant matrices for the two-stage (four-step) matmul forward FFT.

    N = m1*m2 (m1 = 2^ceil(log2(N)/2)). Stage 1 (left-multiply, FFT over
    the n1 axis of the [m1, m2] view): rr matrix W1 [2m1, 2m1] of the
    forward DFT e^{-2pi i a b / m1}. Twiddle (tr, ti) [m1, m2]:
    T[k1, n2] = e^{-2pi i k1 n2 / N}. Stage 2 (right-multiply): rr matrix
    E2 [2m2, 2m2] of W_{m2} transposed, with the output fftshift folded
    in as (-1)^{n2} column signs and the 1/N scaling.
    """
    if n & (n - 1):
        raise ValueError(f"forward_spectrum_mxu needs power-of-2 N, got {n}")
    log2n = int(np.log2(n))
    m1 = 1 << ((log2n + 1) // 2)
    m2 = n // m1

    def dft(m):
        a = np.arange(m)[:, None].astype(np.float64)
        b = np.arange(m)[None, :].astype(np.float64)
        ang = -2.0 * np.pi * (a * b % m) / m
        return np.cos(ang), np.sin(ang)

    wr1, wi1 = dft(m1)
    # left rr form: [yr; yi] = [[wr, -wi], [wi, wr]] @ [xr; xi]
    w1 = np.block([[wr1, -wi1], [wi1, wr1]]).astype(np.float32)
    tang = -2.0 * np.pi * (
        np.arange(m1)[:, None] * np.arange(m2)[None, :] % n
    ).astype(np.float64) / n
    tr = np.cos(tang).astype(np.float32)
    ti = np.sin(tang).astype(np.float32)
    # stage 2: X_mat[k1, k2] = sum_{n2} Y'[k1, n2] W_{m2}[k2, n2]; fftshift
    # (k += N/2 == rotate k2 by m2/2) == (-1)^{n2} column signs; 1/N scale
    wr2, wi2 = dft(m2)
    s = np.where(np.arange(m2) % 2 == 0, 1.0, -1.0)[:, None]
    e_re = wr2.T * s / n
    e_im = wi2.T * s / n
    # right rr form: [yr yi] @ [[er, ei], [-ei, er]]
    e2 = np.block([[e_re, e_im], [-e_im, e_re]]).astype(np.float32)
    return m1, m2, w1, tr, ti, e2


def forward_spectrum_mxu(blocks: jax.Array) -> jax.Array:
    """:func:`forward_spectrum` as two DFT matmul stages.

    Four-step N = m1*m2 decomposition (64x64 for the flagship 4096): view
    each block as an [m1, m2] matrix, DFT the columns (one rr matmul with
    contraction 2*m1), twiddle, DFT the rows (second rr matmul, with the
    output fftshift folded into the matrix as column signs plus the 1/N
    scale), then transpose-and-flatten. Both matmuls run at
    :data:`DFT_PRECISION`.
    """
    n = blocks.shape[-1]
    m1, m2, w1, tr, ti, e2 = _four_step_matrices(n)
    lead = blocks.shape[:-1]
    z = blocks.reshape(lead + (m1, m2))
    dot = dft_matmul
    # stage 1: FFT over n1 — left rr matmul
    x_ri = jnp.concatenate(
        [jnp.real(z), jnp.imag(z)], axis=-2
    )  # [..., 2*m1, m2]
    y_ri = dot(jnp.asarray(w1), x_ri)
    yr, yi = y_ri[..., :m1, :], y_ri[..., m1:, :]
    # twiddle Y'[k1, n2] = Y * e^{-2pi i k1 n2 / N}
    trj = jnp.asarray(tr)
    tij = jnp.asarray(ti)
    zr = yr * trj - yi * tij
    zi = yr * tij + yi * trj
    # stage 2: FFT over n2 — right rr matmul, shift/scale folded
    z_ri = jnp.concatenate([zr, zi], axis=-1)  # [..., m1, 2*m2]
    o_ri = dot(z_ri, jnp.asarray(e2))
    x_mat = jax.lax.complex(o_ri[..., :m2], o_ri[..., m2:])  # [k1, k2]
    # spec[k] = X_mat[k % m1, k // m1] -> transpose then flatten
    return jnp.swapaxes(x_mat, -1, -2).reshape(lead + (n,))


def _alternating_signs(n: int, dtype=jnp.float32) -> jax.Array:
    return jnp.asarray(np.where(np.arange(n) % 2 == 0, 1.0, -1.0), dtype=dtype)


def subband_ifft(z: jax.Array) -> jax.Array:
    """Unnormalized IFFT of the fftshifted slice: l * ifft(z) * (-1)^m.

    Equivalent to the reference's fftshift-then-FFTW-inverse on a windowed
    bin slice (reference: lib/SegmentDetection_impl.cc:413-416,649-657).
    z: [..., l] complex, l even.
    """
    l = z.shape[-1]
    y = jnp.fft.ifft(z, axis=-1)
    return y * (_alternating_signs(l) * l).astype(y.dtype)


def comb_subband_ifft(z_pad: jax.Array, width_log2: jax.Array, w_max: int) -> jax.Array:
    """Variable-width unnormalized subband IFFT at a single static width.

    Args:
      z_pad: [..., w_max] complex; the leading w = 2**width_log2 entries of
        the last axis hold the windowed bin slice (fftshifted subband
        coordinates), the rest are ignored.
      width_log2: [...] int32, log2 of each item's true width (broadcastable
        against z_pad's batch dims).
      w_max: static maximum width (power of two).

    Returns:
      y: [..., w_max] complex where ``y[..., m] == w-point unnormalized
      IFFT(fftshift_w(slice))[m % w]`` — i.e. the first w samples along the
      last axis equal the reference's per-channel IFFT output
      (reference: lib/SegmentDetection_impl.cc:399-429) and the output is
      w-periodic beyond that.
    """
    if w_max & (w_max - 1):
        raise ValueError(f"w_max must be a power of 2, got {w_max}")
    w_max_log2 = int(np.log2(w_max))

    i = jnp.arange(w_max, dtype=jnp.int32)  # comb position
    shift = (w_max_log2 - width_log2).astype(jnp.int32)[..., None]  # [..., 1]
    q_mask = (1 << shift) - 1  # q - 1
    src = jnp.right_shift(i, shift)  # [..., w_max]
    on_comb = jnp.bitwise_and(i, q_mask) == 0

    comb = jnp.where(on_comb, jnp.take_along_axis(z_pad, src, axis=-1), 0.0)
    y = jnp.fft.ifft(comb, axis=-1)
    return y * (_alternating_signs(w_max) * w_max).astype(y.dtype)


@functools.lru_cache(maxsize=None)
def _rr_idft_matrix(
    l: int, keep_from: int, signs: bool, gain: float, pairs: bool = False
):
    """[2l, 2(l-keep_from)] float32 real-representation IDFT matrix.

    ``[zr zi] @ M == [yr yi]`` for ``y[m] = gain * l * ifft(z)[m]``
    (times ``(-1)^m`` when ``signs``), output columns restricted to
    ``m in [keep_from, l)``. One real matmul replaces the four of the
    classic split-complex formulation, and trimming the overlap prefix
    plus folding the gain happen for free in the constant matrix.

    ``pairs`` interleaves the output columns (re0, im0, re1, im1, ...) so
    the matmul result bit-casts straight into the float32 ``[..., k, 2]``
    host-boundary pair layout (``fdc_tpu.utils.cplx``) — the complexify +
    c2f passes over the (large) extraction outputs vanish entirely; each
    column's dot product is unchanged, so values stay bit-identical.
    """
    k = np.arange(l)[:, None].astype(np.float64)
    m = np.arange(keep_from, l)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * (k * m % l) / l
    e_re = np.cos(ang) * gain
    e_im = np.sin(ang) * gain
    if signs:
        s = np.where(np.arange(keep_from, l) % 2 == 0, 1.0, -1.0)[None, :]
        e_re = e_re * s
        e_im = e_im * s
    top = np.concatenate([e_re, e_im], axis=1)
    bot = np.concatenate([-e_im, e_re], axis=1)
    mat = np.concatenate([top, bot], axis=0).astype(np.float32)
    if pairs:
        kept = mat.shape[1] // 2
        mat = np.stack([mat[:, :kept], mat[:, kept:]], axis=2).reshape(
            mat.shape[0], 2 * kept
        )
    return mat


def _rr_matmul(z: jax.Array, mat_np, pairs: bool = False) -> jax.Array:
    """Complex-in via ONE real [..., 2l] x [2l, 2k] matmul.

    Returns complex [..., k], or float32 [..., k, 2] pairs when ``pairs``
    (the matrix must then be column-interleaved — see _rr_idft_matrix).
    Runs at :data:`DFT_PRECISION`."""
    mat = jnp.asarray(mat_np)
    zri = jnp.concatenate([jnp.real(z), jnp.imag(z)], axis=-1)
    yri = dft_matmul(zri, mat)
    kept = mat.shape[1] // 2
    if pairs:
        return yri.reshape(*yri.shape[:-1], kept, 2)
    return jax.lax.complex(yri[..., :kept], yri[..., kept:])


def subband_ifft_mxu(
    z: jax.Array, keep_from: int = 0, gain: float = 1.0, pairs: bool = False
) -> jax.Array:
    """Matmul-DFT variant of :func:`subband_ifft`: the subband inverse
    transforms are one real matmul against a constant real-representation
    DFT matrix (the ``use_mxu_fft`` config knob).

    Extensions over :func:`subband_ifft`'s contract: only output samples
    ``[keep_from, l)`` are computed (the caller's overlap trim, folded
    into the matrix), scaled by ``gain``; ``pairs`` returns the float32
    ``[..., k, 2]`` host-boundary layout directly (no complexify pass).
    """
    return _rr_matmul(
        z, _rr_idft_matrix(z.shape[-1], keep_from, True, float(gain), pairs),
        pairs=pairs,
    )


def interp_subband_ifft_mxu(
    z_pad: jax.Array, w_max: int, pairs: bool = False
) -> jax.Array:
    """Matmul-DFT variant of :func:`interp_subband_ifft`
    (same contract; ``pairs`` as in :func:`subband_ifft_mxu`)."""
    del w_max  # fixed by the last axis, kept for API symmetry
    return _rr_matmul(
        z_pad, _rr_idft_matrix(z_pad.shape[-1], 0, False, 1.0, pairs),
        pairs=pairs,
    )


def interp_subband_ifft(z_pad: jax.Array, w_max: int) -> jax.Array:
    """Variable-width subband IFFT, gather-free (the production hot path).

    Sampling identity: a W-point unnormalized IFFT of the ZERO-PADDED slice,
    read at stride q = W/w, equals the w-point unnormalized IFFT —
    ``p[m*q] == w * ifft_w(z)[m]`` — so variable widths need no comb
    upsampling (no traced-index gather as in ``comb_subband_ifft``) and no
    data-dependent shapes. The consumer (host emitter)
    strides by q and applies the fftshift sign compensation
    ``(-1)^m`` (see fdc_tpu/runtime/emission.py), both free on host.

    Args:
      z_pad: [..., w_max] complex; the leading w entries of each row hold
        the windowed UNSHIFTED bin slice, the rest are zero (the zero-padded
        window guarantees this).
      w_max: static maximum width W (power of two).

    Returns p: [..., w_max] complex with ``p[..., m*q] == w-point
    unnormalized IFFT(slice)[m]``; positions between comb samples hold the
    band-limited interpolation (ignored by consumers).
    """
    y = jnp.fft.ifft(z_pad, axis=-1)
    return y * jnp.asarray(w_max, dtype=y.dtype)
