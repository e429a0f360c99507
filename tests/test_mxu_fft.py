"""Matmul-DFT subband transforms == FFT path (use_mxu_fft knob)."""

import numpy as np
import pytest

from fdc_tpu import ChannelizerConfig, FrequencyDomainChannelizer


def test_mxu_dft_matches_fft_ops():
    import jax.numpy as jnp

    from fdc_tpu.ops.fft import (
        interp_subband_ifft,
        interp_subband_ifft_mxu,
        subband_ifft,
        subband_ifft_mxu,
    )

    rng = np.random.default_rng(0)
    z = (rng.standard_normal((3, 5, 64))
         + 1j * rng.standard_normal((3, 5, 64))).astype(np.complex64)
    a = np.asarray(subband_ifft(jnp.asarray(z)))
    b = np.asarray(subband_ifft_mxu(jnp.asarray(z)))
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)

    zp = (rng.standard_normal((4, 3, 128))
          + 1j * rng.standard_normal((4, 3, 128))).astype(np.complex64)
    a = np.asarray(interp_subband_ifft(jnp.asarray(zp), 128))
    b = np.asarray(interp_subband_ifft_mxu(jnp.asarray(zp), 128))
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=3e-4)


def test_use_mxu_fft_end_to_end():
    """The knob flips every subband transform (throughput, burst bank,
    detection slots) onto the matmul path with equal results."""
    def build(use_mxu):
        return FrequencyDomainChannelizer(
            ChannelizerConfig(
                blocksize=512,
                relinvovl=4,
                throughput_channels=[(-0.2, 0.05), (0.1, 0.05)],
                activity_controlled_channels=[(0.3, 0.05)],
                activity_detection_segments=[(-0.45, -0.3)],
                act_contr_threshold=10.0,
                act_det_threshold=8.0,
                minchandist=0.02,
                freqmode="basebandfs",
                batch_blocks=8,
                max_slots=8,
                use_mxu_fft=use_mxu,
            )
        )

    n = 24 * build(False).config.inplen
    t = np.arange(n)
    rng = np.random.default_rng(4)
    x = (0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    for lo, hi, f in ((4, 14, 0.3), (8, 18, -0.38)):
        m = np.zeros(n)
        m[lo * 384: hi * 384] = 1.0
        x += (2.0 * m * np.exp(2j * np.pi * f * t)).astype(np.complex64)

    r_fft = build(False).process(x)
    r_mxu = build(True).process(x)

    for a, b in zip(r_fft.throughput, r_mxu.throughput):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)
    assert len(r_fft.events) == len(r_mxu.events)
    assert len(r_fft.events) > 0
    for ea, eb in zip(r_fft.events, r_mxu.events):
        assert ea.blockstart == eb.blockstart
        assert ea.blockend == eb.blockend
        assert ea.data.shape == eb.data.shape
        np.testing.assert_allclose(ea.data, eb.data, rtol=2e-3, atol=2e-3)
