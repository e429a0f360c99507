"""Unit tests for windows, framing and subband IFFT helpers vs the golden model."""

import numpy as np
import pytest

import jax.numpy as jnp

from fdc_tpu.config import WindowType
from fdc_tpu.ops.windows import (
    window_bank,
    flank_window_bank,
    sine_flank_window_bank,
)
from fdc_tpu.ops.framing import frame_blocks, initial_history
from fdc_tpu.ops.fft import forward_spectrum, subband_ifft, comb_subband_ifft

from golden import golden_window_bank, golden_overlap_save, golden_forward_fft

RNG = np.random.default_rng(0)


def crandn(*shape):
    return (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)).astype(
        np.complex64
    )


@pytest.mark.parametrize("wintype", [0, 1, 2])
@pytest.mark.parametrize(
    "l,pbw,sbw", [(64, 0.5, 0.8), (128, 0.77, 1.0), (256, 1.2, 1.5), (32, 0.69, 0.94)]
)
@pytest.mark.parametrize("step", [0, 1, 3])
def test_window_bank_matches_golden(wintype, l, pbw, sbw, step):
    r = 4
    ours = window_bank(WindowType(wintype), l, pbw, sbw, r, step=step)
    ref = golden_window_bank(wintype, l, pbw, sbw, r, step)
    np.testing.assert_allclose(ours, ref, atol=1e-7)


def test_flank_window_bank_properties():
    r, w, puffer = 4, 128, 0.2
    bank = flank_window_bank(w, r, puffer)
    assert bank.shape == (r, w)
    p = int(puffer * w)
    # first flank sample is exactly zero, center is unit amplitude
    assert abs(bank[0, 0]) == 0.0
    np.testing.assert_allclose(abs(bank[0, w // 2]), 1.0, atol=1e-7)
    np.testing.assert_allclose(abs(bank[0, p]), 1.0, atol=1e-7)
    # symmetric flanks
    np.testing.assert_allclose(
        np.abs(bank[2, :p]), np.abs(bank[2, -p:][::-1]), atol=1e-7
    )
    # phase states
    for i in range(r):
        np.testing.assert_allclose(
            bank[i, w // 2], np.exp(2j * np.pi * i / r), atol=1e-6
        )


def test_sine_flank_window_symmetric():
    bank = sine_flank_window_bank(64, 40, 4)
    w = bank[0]
    ramp = (64 - 40) // 3
    assert ramp > 0
    np.testing.assert_allclose(np.abs(w[:ramp]), np.abs(w[-ramp:][::-1]), atol=1e-7)
    np.testing.assert_allclose(np.abs(w[ramp : 64 - ramp]), 1.0, atol=1e-7)


def test_frame_blocks_matches_golden_and_carries_history():
    n, r = 256, 4
    ovl = n // r
    inplen = n - ovl
    x = crandn(10 * inplen)

    ref_blocks, ref_hist = golden_overlap_save(x, n, ovl)

    hist = initial_history(ovl)
    # run in two chunks to exercise the carry
    b1, hist = frame_blocks(jnp.asarray(x[: 4 * inplen]), hist, n)
    b2, hist = frame_blocks(jnp.asarray(x[4 * inplen :]), hist, n)
    ours = np.concatenate([np.asarray(b1), np.asarray(b2)])

    np.testing.assert_allclose(ours, ref_blocks, atol=1e-7)
    np.testing.assert_allclose(np.asarray(hist), ref_hist, atol=1e-7)


def test_forward_spectrum_matches_golden():
    blocks = crandn(6, 512)
    ours = np.asarray(forward_spectrum(jnp.asarray(blocks)))
    ref = golden_forward_fft(blocks)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_forward_spectrum_mxu_matches_fft_path(n):
    """Four-step matmul formulation == FFT lowering (the use_mxu_fft front-end,
    reference front-end: python/FrequencyDomainChannelizer.py:206,214-216)."""
    from fdc_tpu.ops.fft import forward_spectrum_mxu

    blocks = crandn(5, n)
    ref = np.asarray(forward_spectrum(jnp.asarray(blocks)))
    got = np.asarray(forward_spectrum_mxu(jnp.asarray(blocks)))
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 1e-5

    # routed variant engages only at N >= 256
    routed = np.asarray(forward_spectrum(jnp.asarray(blocks), use_mxu=True))
    np.testing.assert_allclose(routed, got, atol=0)


@pytest.mark.parametrize("l", [8, 64, 256])
def test_subband_ifft_equals_fftshift_then_unnormalized_ifft(l):
    z = crandn(5, l)
    ours = np.asarray(subband_ifft(jnp.asarray(z)))
    zs = np.roll(z, -l // 2, axis=-1)  # fftshift for even l
    ref = np.fft.ifft(zs, axis=-1) * l
    np.testing.assert_allclose(ours, ref, atol=1e-4)


@pytest.mark.parametrize("w", [8, 32, 128, 512])
def test_comb_subband_ifft_matches_direct_small_ifft(w):
    w_max = 512
    z = np.zeros((3, w_max), np.complex64)
    z[:, :w] = crandn(3, w)
    wl2 = np.full((3,), int(np.log2(w)), np.int32)

    ours = np.asarray(comb_subband_ifft(jnp.asarray(z), jnp.asarray(wl2), w_max))

    zs = np.roll(z[:, :w], -w // 2, axis=-1)
    ref = np.fft.ifft(zs, axis=-1) * w
    # leading w samples match the direct w-point transform
    np.testing.assert_allclose(ours[:, :w], ref, atol=1e-3)
    # and the tail is w-periodic
    if w < w_max:
        np.testing.assert_allclose(ours[:, w : 2 * w], ours[:, :w], atol=1e-3)


def test_comb_subband_ifft_mixed_widths():
    w_max = 256
    widths = [16, 256, 64]
    z = np.zeros((3, w_max), np.complex64)
    for i, w in enumerate(widths):
        z[i, :w] = crandn(w)
    wl2 = np.asarray([int(np.log2(w)) for w in widths], np.int32)
    ours = np.asarray(comb_subband_ifft(jnp.asarray(z), jnp.asarray(wl2), w_max))
    for i, w in enumerate(widths):
        zs = np.roll(z[i, :w], -w // 2)
        ref = np.fft.ifft(zs) * w
        np.testing.assert_allclose(ours[i, :w], ref, atol=1e-3)


def test_config_json_roundtrip():
    from fdc_tpu.config import ChannelizerConfig, FreqMode, WindowType

    cfg = ChannelizerConfig(
        blocksize=1024,
        throughput_channels=[(0.1, 0.02)],
        activity_detection_segments=[(0.3, 0.4)],
        freqmode="basebandfs",
        windowtype="hann",
        fs=2e6,
    )
    cfg2 = ChannelizerConfig.from_json(cfg.to_json())
    assert cfg2 == cfg
    assert cfg2.freqmode == FreqMode.basebandfs
    assert cfg2.windowtype == WindowType.HANN


def test_frame_blocks_type_generic():
    """overlap_save is type-generic in the reference (itemsize bytes);
    frame_blocks must handle real dtypes identically."""
    import jax.numpy as jnp
    from fdc_tpu.ops.framing import frame_blocks

    x = jnp.arange(24.0, dtype=jnp.float32)
    hist = jnp.full((4,), -1.0, jnp.float32)
    blocks, new_hist = frame_blocks(x, hist, 12)
    assert blocks.shape == (3, 12)
    np.testing.assert_array_equal(np.asarray(blocks[0][:4]), -np.ones(4))
    np.testing.assert_array_equal(
        np.asarray(blocks[1]), np.arange(4.0, 16.0)
    )
    np.testing.assert_array_equal(np.asarray(new_hist), np.arange(20.0, 24.0))


def test_profiling_utils_cpu():
    from fdc_tpu.config import ChannelizerConfig
    from fdc_tpu.models.channelizer import FrequencyDomainChannelizer
    from fdc_tpu.utils.profiling import measure_samples_per_sec

    fdc = FrequencyDomainChannelizer(ChannelizerConfig(
        blocksize=128, relinvovl=4,
        throughput_channels=[(0.2, 0.05)],
        batch_blocks=2,
    ))
    sps = measure_samples_per_sec(fdc, k=2)
    assert sps > 0


def test_vector_cut():
    import jax.numpy as jnp
    from fdc_tpu.ops.framing import vector_cut

    x = jnp.arange(24)
    y = np.asarray(vector_cut(x, veclen=8, offset=2, blocklen=3))
    np.testing.assert_array_equal(y, [2, 3, 4, 10, 11, 12, 18, 19, 20])
    with pytest.raises(ValueError):
        vector_cut(x, 8, 6, 3)


def test_centerfreqfs_mode_end_to_end():
    """centerfreqfs frequency mode: absolute RF frequencies with fs + center
    (reference: python/FrequencyDomainChannelizer.py:84-89)."""
    from fdc_tpu.config import ChannelizerConfig
    from fdc_tpu.models.channelizer import FrequencyDomainChannelizer

    fs = 2_000_000.0
    fc = 433_000_000.0
    f_rf = fc + 250_000.0  # +0.125 of fs
    cfg = ChannelizerConfig(
        blocksize=256,
        relinvovl=4,
        throughput_channels=[(f_rf, 80_000.0)],
        freqmode="centerfreqfs",
        fs=fs,
        centerfrequency=fc,
        batch_blocks=4,
    )
    fdc = FrequencyDomainChannelizer(cfg)
    n = 4 * fdc.batch_samples
    t = np.arange(n)
    rng = np.random.default_rng(0)
    x = (np.exp(2j * np.pi * 0.125 * t)  # baseband-equivalent of f_rf
         + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    y = fdc.process(x).throughput[0]
    assert np.abs(y[len(y) // 4:]).mean() == pytest.approx(1.0, abs=0.07)


@pytest.mark.parametrize("wlog2", [2, 4, 6, 9])
def test_interp_identity_matches_comb(wlog2):
    """interp_subband_ifft sampled at stride q with (-1)^m compensation ==
    comb_subband_ifft's first w outputs (the identity behind the gather-free
    extraction hot path)."""
    import jax.numpy as jnp
    from fdc_tpu.ops.fft import comb_subband_ifft, interp_subband_ifft

    w_max = 512
    w = 1 << wlog2
    q = w_max // w
    rng = np.random.default_rng(wlog2)
    z = np.zeros((3, w_max), np.complex64)
    z[:, :w] = (rng.standard_normal((3, w))
                + 1j * rng.standard_normal((3, w))).astype(np.complex64)

    ref = np.asarray(comb_subband_ifft(
        jnp.asarray(z), jnp.full((3,), wlog2, jnp.int32), w_max
    ))[:, :w]
    p = np.asarray(interp_subband_ifft(jnp.asarray(z), w_max))
    signs = np.where(np.arange(w) % 2 == 0, 1.0, -1.0)
    ours = p[:, ::q][:, :w] * signs
    np.testing.assert_allclose(ours, ref, rtol=2e-5, atol=1e-5)


def test_frame_blocks_single_block():
    import jax.numpy as jnp
    from fdc_tpu.ops.framing import frame_blocks

    x = jnp.arange(6.0)
    hist = jnp.full((2,), -1.0)
    blocks, new_hist = frame_blocks(x, hist, 8)
    assert blocks.shape == (1, 8)
    np.testing.assert_array_equal(
        np.asarray(blocks[0]), [-1, -1, 0, 1, 2, 3, 4, 5]
    )
    np.testing.assert_array_equal(np.asarray(new_hist), [4, 5])


def test_waterfall_handles_nonfinite_power():
    from fdc_tpu.utils.waterfall import Waterfall

    wf = Waterfall(blocklen=16, width=16, height=4, db_range=(-20.0, 20.0))
    p = np.full((2, 16), np.nan)
    p[1] = np.inf
    wf.feed_power(np.nan_to_num(p, nan=0.0, posinf=1e30))
    img = wf.render()
    assert img.shape == (4, 16, 3)


@pytest.mark.parametrize("use_mxu", [True, False])
def test_extract_pairs_layout_bit_identical(use_mxu):
    """pairs=True ships the float-pair host layout with values identical to
    complexify + c2f (matmul path: interleaved matrix columns, same dot
    products; FFT path: literal c2f)."""
    from fdc_tpu.ops.extract import (
        apply_phase, apply_phase_pairs, extract_bucket, extract_dynamic,
    )
    from fdc_tpu.utils.cplx import c2f

    spec = jnp.asarray(crandn(7, 256))
    starts = jnp.asarray(np.array([3, 40, 100], np.int32))
    wins = jnp.asarray(np.random.default_rng(1).uniform(
        0.1, 1.0, (3, 64)).astype(np.float32))

    yc = extract_bucket(spec, starts, wins, gain=2.0, use_mxu=use_mxu,
                        keep_from=16)
    yp = extract_bucket(spec, starts, wins, gain=2.0, use_mxu=use_mxu,
                        keep_from=16, pairs=True)
    np.testing.assert_array_equal(np.asarray(c2f(yc)), np.asarray(yp))

    # phase rotation on pairs == phase rotation on complex
    pidx = jnp.asarray((np.arange(7)[None, :] * np.array(
        [1, 2, 3])[:, None]).astype(np.int32) % 4)
    rc = apply_phase(yc, pidx, 4)
    rp = apply_phase_pairs(yp, pidx, 4)
    np.testing.assert_allclose(np.asarray(c2f(rc)), np.asarray(rp),
                               atol=1e-6)

    wl2 = jnp.asarray(np.array([5, 6, 4], np.int32))
    wpad = jnp.asarray(np.random.default_rng(2).uniform(
        0.1, 1.0, (3, 64)).astype(np.float32))
    dc = extract_dynamic(spec, starts, wl2, wpad, 64, use_mxu=use_mxu)
    dp = extract_dynamic(spec, starts, wl2, wpad, 64, use_mxu=use_mxu,
                         pairs=True)
    np.testing.assert_array_equal(np.asarray(c2f(dc)), np.asarray(dp))


# ---------------------------------------------------------------------------
# round 4: type-generic framing/cut + standalone phased windowing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "dtype",
    # the reference blocks are itemsize-generic and declare all five GRC IO
    # types (reference: lib/overlap_save_impl.cc:62-81 memcpy on itemsize;
    # grc/FDC_overlap_save.xml, FDC_vector_cut_vxx.xml)
    [np.uint8, np.int16, np.int32, np.float32, np.complex64],
)
def test_frame_blocks_and_vector_cut_dtype_generic(dtype):
    from fdc_tpu.ops.framing import frame_blocks, initial_history, vector_cut

    rng = np.random.default_rng(5)
    n, r = 32, 4
    ovl = n // r
    inplen = n - ovl
    nb = 6
    raw = rng.integers(1, 100, nb * inplen)
    x = (
        (raw + 1j * raw[::-1]).astype(dtype)
        if np.issubdtype(dtype, np.complexfloating)
        else raw.astype(dtype)
    )

    blocks, hist = frame_blocks(
        jnp.asarray(x), initial_history(ovl, dtype=dtype), n
    )
    blocks = np.asarray(blocks)
    assert blocks.dtype == dtype and blocks.shape == (nb, n)
    # golden: per-block memcpy semantics
    ext = np.concatenate([np.zeros(ovl, dtype), x])
    for b in range(nb):
        np.testing.assert_array_equal(
            blocks[b], ext[b * inplen: b * inplen + n]
        )
    np.testing.assert_array_equal(np.asarray(hist), x[-ovl:])

    cut = np.asarray(vector_cut(jnp.asarray(x), inplen, 3, 7))
    assert cut.dtype == dtype
    ref = x.reshape(nb, inplen)[:, 3:10].reshape(-1)
    np.testing.assert_array_equal(cut, ref)


@pytest.mark.parametrize("shifts", [1, 3, -1, 0])
def test_phase_shifting_windowing_matches_reference_loop(shifts):
    """Standalone cycling-window op == the reference block's per-vector
    multiply loop (window bank x advancing counter,
    reference: lib/phase_shifting_windowing_vcc_impl.cc:73-85)."""
    from fdc_tpu.config import WindowType
    from fdc_tpu.ops.extract import phase_shifting_windowing
    from fdc_tpu.ops.windows import window_bank

    rng = np.random.default_rng(9)
    l, r, b = 64, 4, 11
    x = (
        rng.standard_normal((b, l)) + 1j * rng.standard_normal((b, l))
    ).astype(np.complex64)

    y1, ctr = phase_shifting_windowing(
        jnp.asarray(x), WindowType.HANN, l, r, shifts, 0.5, 0.7
    )
    # continue the stream: a second batch must pick up the counter
    y2, _ = phase_shifting_windowing(
        jnp.asarray(x), WindowType.HANN, l, r, shifts, 0.5, 0.7,
        counter0=ctr,
    )

    bank = window_bank(WindowType.HANN, l, 0.5, 0.7, r)  # [R, L] step 1
    shift = ((shifts % r) + r) % r
    ref = np.empty((2 * b, l), np.complex64)
    counter = 0
    for i in range(2 * b):
        ref[i] = x[i % b] * bank[counter]
        counter = (counter + shift) % r
    got = np.concatenate([np.asarray(y1), np.asarray(y2)])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
