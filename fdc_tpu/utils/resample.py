"""Rational resampling conveniences for per-channel output streams.

The reference emits each channel at its own fixed rate fs*width/blocksize
(reference: python/FrequencyDomainChannelizer.py:218-231 — the decimation
is the bin-slice width); downstream consumers usually want one common
rate. This module provides a polyphase rational resampler:
the up/down structure is expressed as ONE `lax.conv_general_dilated`
(input dilation = interpolation, window stride = decimation), which XLA
lowers to one convolution kernel — no per-phase Python loops.

No reference analog (gr-FDC leaves resampling to downstream GNU Radio
blocks); the filter is a Kaiser-windowed sinc like GNU Radio's
`rational_resampler` default design.
"""

from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["design_kaiser_lowpass", "rational_resample", "common_rate"]


def design_kaiser_lowpass(num_taps: int, cutoff: float,
                          beta: float = 8.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass, unit DC gain.

    Args:
      num_taps: filter length (odd recommended for symmetric delay).
      cutoff: normalized cutoff in cycles/sample of the target rate
        (0 < cutoff <= 0.5).
      beta: Kaiser shape parameter.
    """
    if not 0.0 < cutoff <= 0.5:
        raise ValueError(f"cutoff must be in (0, 0.5], got {cutoff}")
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * n)
    h *= np.kaiser(num_taps, beta)
    return (h / h.sum()).astype(np.float32)


def rational_resample(x, up: int, down: int, taps_per_phase: int = 16,
                      beta: float = 8.0):
    """Resample complex streams by up/down with a polyphase lowpass.

    Args:
      x: [T] or [C, T] complex64 streams (a batch resamples as one conv).
      up/down: interpolation / decimation factors (coprime not required;
        the fraction is reduced internally).
      taps_per_phase: filter taps per polyphase branch.
      beta: Kaiser window shape.

    Returns [ceil(T*up/down)] (or [C, ...]) complex64, group delay
    compensated — y[m] tracks x(m*down/up).
    """
    frac = Fraction(int(up), int(down))
    up, down = frac.numerator, frac.denominator
    if up == 1 and down == 1:
        return jnp.asarray(x)

    x = jnp.asarray(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    c, t = x.shape

    # anti-alias/anti-image cutoff at the tighter of the two Nyquists,
    # relative to the UPSAMPLED rate; gain `up` restores amplitude
    num_taps = taps_per_phase * up + 1
    h = design_kaiser_lowpass(
        num_taps, 0.5 / max(up, down), beta
    ) * np.float32(up)
    rhs = jnp.asarray(h)[None, None, :]  # [out=1, in=1, L]

    pad = (num_taps - 1) // 2  # center the group delay

    def conv(real_part):
        lhs = real_part[:, None, :]  # [C, 1, T]
        out = jax.lax.conv_general_dilated(
            lhs, rhs,
            window_strides=(down,),
            padding=((pad, pad),),
            lhs_dilation=(up,),
            dimension_numbers=("NCH", "OIH", "NCH"),
            # float32 taps: DEFAULT would round to TF32 on the GPU
            precision=jax.lax.Precision.HIGHEST,
        )
        return out[:, 0, :]

    y = jax.lax.complex(
        conv(jnp.real(x).astype(jnp.float32)),
        conv(jnp.imag(x).astype(jnp.float32)),
    )
    return y[0] if squeeze else y


def common_rate(streams, widths, target_width: int, blocksize: int = None,
                **kw):
    """Bring per-channel streams (rate ∝ their slice widths) to one rate.

    Args:
      streams: list of [T_i] complex arrays (ProcessResult.throughput).
      widths: each stream's extraction width (channel geometry `.width`).
      target_width: the width whose rate to resample everything to.

    Returns list of streams all at rate fs * target_width / blocksize.
    """
    del blocksize  # rates are proportional to widths; blocksize cancels
    out = []
    for s, w in zip(streams, widths):
        out.append(rational_resample(s, target_width, w, **kw))
    return out
