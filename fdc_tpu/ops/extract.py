"""Channel extraction: bin-slice gather + window multiply + subband IFFT.

This single fused path replaces four reference blocks in the throughput chain
(vector_cut -> phase_shifting_windowing_vcc -> inverse fft_vcc -> vector_cut;
reference: python/FrequencyDomainChannelizer.py:218-231) and the
``process_channel`` routine of the burst/detection paths
(reference: lib/PowerActivationChannel_impl.cc:260-284,
lib/SegmentDetection_impl.cc:399-429).

Channels of equal width are batched into one [C, B, l] tensor so the windowed
multiply and the IFFT run as single large batched ops.

Phase compensation: every phase copy in the reference's window banks is the
base window times a constant scalar e^{j*2pi*p/R} (reference:
lib/windows.h:69-77 — the polar phase does not depend on the sample index),
so overlap-save phase-rotation compensation factors out of the IFFT entirely:
extraction_with_phase_p == e^{j*2pi*p/R} * extraction_with_phase_0. The hot
path therefore stores ONE real-amplitude window per channel and applies the
per-block phase as a scalar complex rotation on the IFFT output
(``apply_phase``), saving an R-times larger window table and a gather.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from fdc_tpu.ops.fft import (
    _rr_idft_matrix,
    dft_matmul,
    interp_subband_ifft,
    interp_subband_ifft_mxu,
    subband_ifft,
    subband_ifft_mxu,
)
from fdc_tpu.utils.cplx import c2f

__all__ = [
    "phase_table",
    "apply_phase",
    "apply_phase_pairs",
    "phase_shifting_windowing",
    "gather_slices",
    "extract_bucket",
    "extract_bucket_phased",
    "extract_dynamic",
]


def phase_table(relinvovl: int) -> jax.Array:
    """[R] complex64 table of e^{j*2pi*p/R} phase-compensation factors."""
    ang = (2.0 * np.pi / relinvovl) * jnp.arange(relinvovl, dtype=jnp.float32)
    return jax.lax.complex(jnp.cos(ang), jnp.sin(ang))


def apply_phase(y: jax.Array, phase_idx: jax.Array, relinvovl: int) -> jax.Array:
    """Multiply [..., L] outputs by the scalar phase factor of each row.

    phase_idx: integer array broadcastable against y's batch dims. The
    R-entry table lookup is an elementwise one-hot sum (R is tiny: the
    table is e^{j*2pi*p/R}, p in [0, R)), which fuses into the multiply.
    """
    ang = (2.0 * np.pi / relinvovl) * jnp.arange(
        relinvovl, dtype=jnp.float32
    )
    onehot = (
        phase_idx[..., None] == jnp.arange(relinvovl, dtype=phase_idx.dtype)
    ).astype(jnp.float32)
    re = jnp.sum(onehot * jnp.cos(ang), axis=-1)
    im = jnp.sum(onehot * jnp.sin(ang), axis=-1)
    return y * jax.lax.complex(re, im)[..., None]


def apply_phase_pairs(
    y: jax.Array, phase_idx: jax.Array, relinvovl: int
) -> jax.Array:
    """:func:`apply_phase` on the float32 ``[..., L, 2]`` pair layout.

    The complex rotation (a+bi)(c+di) in pair form is
    ``c*y + d*flip(y)*[-1, 1]`` — two fused elementwise passes, no
    complexify/split. Same one-hot table lookup as :func:`apply_phase`.
    """
    ang = (2.0 * np.pi / relinvovl) * jnp.arange(
        relinvovl, dtype=jnp.float32
    )
    onehot = (
        phase_idx[..., None] == jnp.arange(relinvovl, dtype=phase_idx.dtype)
    ).astype(jnp.float32)
    re = jnp.sum(onehot * jnp.cos(ang), axis=-1)[..., None, None]
    im = jnp.sum(onehot * jnp.sin(ang), axis=-1)[..., None, None]
    rot = jnp.flip(y, axis=-1) * jnp.asarray([-1.0, 1.0], y.dtype)
    return y * re + rot * im


def phase_shifting_windowing(
    x: jax.Array,
    wintype,
    blocklen: int,
    relinvovl: int,
    shifts: int,
    passbw: float,
    stopbw: float,
    counter0: int = 0,
    normalize: bool = False,
):
    """Standalone cycling-window multiply — the reference's user-wirable
    phase_shifting_windowing_vcc block (reference:
    include/FDC/phase_shifting_windowing_vcc.h:49,
    lib/phase_shifting_windowing_vcc_impl.cc:73-85): vector i of the
    stream is multiplied elementwise by the phase-``counter`` copy of the
    window bank, with ``counter`` advancing by ``shifts`` (mod
    relinvovl) per vector.

    Inside the channelizer this op never appears as-is — every phase copy
    is the base window times a scalar e^{j*2pi*p/R} (see the module
    docstring), so the hot paths factor the phases into scalars/matrix
    folds. This entry point exists for users who wired the block directly.

    Args:
      x: [..., B, blocklen] complex vectors.
      wintype/passbw/stopbw/normalize: window parameters
        (:func:`fdc_tpu.ops.windows.window_bank` semantics).
      relinvovl: number of phase states R.
      shifts: counter increment per vector (negatives allowed, as in the
        reference's ``((shifts % R) + R) % R``).
      counter0: starting phase counter (the reference starts at 0; pass
        the previous call's returned counter to continue a stream).

    Returns (y, counter_end): the windowed vectors and the counter to
    pass as ``counter0`` for the next batch.
    """
    from fdc_tpu.ops.windows import base_window

    if x.shape[-1] != blocklen:
        raise ValueError(
            f"vectors are {x.shape[-1]} long, expected blocklen={blocklen}"
        )
    shift = ((shifts % relinvovl) + relinvovl) % relinvovl
    b = x.shape[-2]
    w_d = jnp.asarray(
        base_window(wintype, blocklen, passbw, stopbw, normalize),
        jnp.float32,
    )
    counters = (
        jnp.int32(counter0)
        + jnp.int32(shift) * jnp.arange(b, dtype=jnp.int32)
    ) % relinvovl
    y = apply_phase(x * w_d.astype(x.dtype), counters, relinvovl)
    return y, int((counter0 + shift * b) % relinvovl)


def gather_slices(spectrum: jax.Array, starts: jax.Array, width: int) -> jax.Array:
    """Cut [C] bin slices of static length ``width`` out of [B, N] spectra.

    Equivalent of C parallel vector_cut_vxx blocks
    (reference: lib/vector_cut_vxx_impl.cc:59-72). starts may be traced
    (dynamic channels) or constant (static channels).

    Returns [C, B, width].
    """
    b = spectrum.shape[0]

    def cut(s):
        return jax.lax.dynamic_slice(spectrum, (0, s), (b, width))

    return jax.vmap(cut)(starts.astype(jnp.int32))


def extract_bucket(
    spectrum: jax.Array,
    starts: jax.Array,
    base_windows: jax.Array,
    gain: float = 1.0,
    use_mxu: bool = False,
    keep_from: int = 0,
    pairs: bool = False,
) -> jax.Array:
    """Extract a bucket of equal-width channels from a batch of spectra.

    Args:
      spectrum: [B, N] normalized fftshifted spectra.
      starts: [C] int32 slice start bins.
      base_windows: [C, l] window amplitudes (phase-0 copies). Pass a
        CONCRETE np.ndarray on the matmul path to fold the window into the
        per-channel DFT matrix at trace time (drops the windowed-multiply
        pass over the slices); traced arrays (e.g. sharded table views)
        take the multiply-then-matmul path.
      gain: scalar gain (the reference's trailing multiply_const,
        reference: python/FrequencyDomainChannelizer.py:231).
      use_mxu: run the subband inverse transform as a matmul-DFT
        instead of the FFT lowering (the ``use_mxu_fft`` config knob).
      keep_from: drop output time samples before this index (the l//R
        overlap trim). On the matmul path the dropped columns are never
        computed (folded into the DFT matrix); the FFT path slices.
      pairs: return the float32 ``[..., 2]`` host-boundary pair layout
        instead of complex. On the matmul path the pairs come straight out
        of the (column-interleaved) matmul — the complexify + c2f passes
        over the output tensor disappear; values are bit-identical.

    Returns [C, B, l - keep_from] phase-0 full-rate subband blocks
    (complex, or float32 [C, B, l - keep_from, 2] when ``pairs``). With
    ``keep_from=0`` this INCLUDES the leading l//R time-domain overlap
    samples. Callers apply per-block phase rotation via ``apply_phase`` /
    ``apply_phase_pairs``.
    """
    l = base_windows.shape[-1]
    if use_mxu and isinstance(base_windows, np.ndarray):
        # static windows fold into per-channel DFT matrices at trace time:
        # (z ⊙ w) @ M == z @ (diag([w; w]) M). Drops the whole windowed-
        # multiply pass over the [C, B, l] slices.
        m = _rr_idft_matrix(l, keep_from, True, float(gain), pairs=pairs)
        slices = gather_slices(spectrum, starts, l)  # [C, B, l]
        zri = jnp.concatenate(
            [jnp.real(slices), jnp.imag(slices)], axis=-1
        )  # [C, B, 2l]
        if (base_windows == base_windows[:1]).all():
            # equal windows across the bucket (the common equal-bandwidth
            # case): ONE flat matmul [C*B, 2l] @ [2l, 2k] instead of C
            # batched small matmuls (same per-element contraction).
            mc = (
                np.concatenate([base_windows[0], base_windows[0]])[:, None]
                * m
            ).astype(np.float32)  # [2l, 2k]
            c, b, l2 = zri.shape
            y = dft_matmul(
                zri.reshape(c * b, l2), jnp.asarray(mc)
            ).reshape(c, b, -1)  # [C, B, 2k]
        else:
            mc = (
                np.concatenate(
                    [base_windows, base_windows], axis=1
                )[:, :, None]
                * m[None]
            ).astype(np.float32)  # [C, 2l, 2k]
            y = dft_matmul(zri, jnp.asarray(mc))  # [C, B, 2k]
        kept = mc.shape[-1] // 2
        if pairs:
            return y.reshape(*y.shape[:-1], kept, 2)
        return jax.lax.complex(y[..., :kept], y[..., kept:])
    slices = gather_slices(spectrum, starts, l)  # [C, B, l]
    z = slices * jnp.asarray(base_windows)[:, None, :].astype(slices.dtype)
    if use_mxu:
        return subband_ifft_mxu(z, keep_from=keep_from, gain=gain,
                                pairs=pairs)
    y = subband_ifft(z)
    if gain != 1.0:
        y = y * jnp.asarray(gain, dtype=y.dtype)
    y = y[..., keep_from:] if keep_from else y
    return c2f(y) if pairs else y


def extract_bucket_phased(
    spectrum: jax.Array,
    starts,
    base_windows,
    relinvovl: int,
    gain: float = 1.0,
    use_mxu: bool = False,
    keep_from: int = 0,
) -> jax.Array:
    """:func:`extract_bucket` with the overlap-save phase compensation
    APPLIED (pairs layout), under the static contract that the global
    block index of spectrum row 0 is ≡ 0 (mod relinvovl) — callers
    guarantee it by keeping batch_blocks a multiple of relinvovl (t0 is
    always a whole number of batches). Then the per-row phase index
    ((t0 + b) * start_c) % R == ((b % R) * start_c) % R is a STATIC
    pattern (reference semantics:
    lib/phase_shifting_windowing_vcc_impl.cc:80-83). Returns
    phase-compensated [C, B, k, 2] float32.
    """
    r = relinvovl
    y = extract_bucket(
        spectrum, starts, base_windows, gain=gain, use_mxu=use_mxu,
        keep_from=keep_from, pairs=True,
    )
    b = y.shape[1]
    phase_idx = (
        jnp.arange(b, dtype=jnp.int32)[None, :]
        * jnp.asarray(starts, jnp.int32)[:, None]
    ) % r
    return apply_phase_pairs(y, phase_idx, r)


def extract_dynamic(
    spectrum: jax.Array,
    starts: jax.Array,
    width_log2: jax.Array,
    windows_pad: jax.Array,
    w_max: int,
    use_mxu: bool = False,
    pairs: bool = False,
) -> jax.Array:
    """Extract variable-width channels (dynamic slot table) at one static shape.

    Args:
      spectrum: [B, N] normalized fftshifted spectra.
      starts: [S] int32 extraction start bins (traced; in [0, N)).
      width_log2: [S] int32 log2 of each slot's extraction width (only used
        by consumers to pick the sampling stride; extraction itself is
        width-oblivious thanks to the zero-padded windows).
      windows_pad: [S, w_max] real/complex window amplitudes, zero-padded
        past each slot's true width.
      w_max: static maximum extraction width (power of 2).

    Returns [S, B, w_max] phase-0 INTERPOLATED outputs: with
    w = 2**width_log2[s] and q = w_max // w, sample ``y[s, b, m*q]`` equals
    the slot's w-point unnormalized subband IFFT at time index m (including
    the ovl prefix), without fftshift sign compensation — consumers stride
    by q and apply ``(-1)^m`` (see interp_subband_ifft). ``pairs``
    returns float32 [S, B, w_max, 2] (see extract_bucket).
    """
    del width_log2  # shape-static path; kept for API symmetry
    # Zero-pad the spectrum tail so a w_max-long slice starting anywhere in
    # [0, N) never clamps (slots narrower than w_max may start past
    # N - w_max; the zero window padding discards the garbage bins).
    spectrum = jnp.pad(spectrum, ((0, 0), (0, w_max)))
    slices = gather_slices(spectrum, starts, w_max)  # [S, B, w_max]
    z = slices * windows_pad[:, None, :].astype(slices.dtype)
    if use_mxu:
        return interp_subband_ifft_mxu(z, w_max, pairs=pairs)
    y = interp_subband_ifft(z, w_max)
    return c2f(y) if pairs else y
