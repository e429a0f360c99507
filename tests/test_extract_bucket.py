"""Static-bucket and dynamic extraction == float64 NumPy reference.

The reference for a channel starting at bin ``s`` with window ``w`` is the
unnormalized subband IFFT of the windowed slice with the fftshift sign
compensation, ``gain * l * ifft(spec[s:s+l] * w)[m] * (-1)^m`` for
``m >= keep_from`` (reference: lib/SegmentDetection_impl.cc:399-429,
python/FrequencyDomainChannelizer.py:218-231).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fdc_tpu.ops.detect import band_power, cell_power
from fdc_tpu.ops.extract import (
    apply_phase_pairs,
    extract_bucket,
    extract_bucket_phased,
    extract_dynamic,
)


def golden_bucket(spec, starts, wins, gain, keep_from):
    """[C, B, l - keep_from] complex128 reference extraction."""
    spec = np.asarray(spec, np.complex128)
    l = wins.shape[1]
    signs = np.where(np.arange(l) % 2 == 0, 1.0, -1.0)
    out = []
    for s, w in zip(starts, wins):
        z = spec[:, s:s + l] * w.astype(np.float64)
        y = np.fft.ifft(z, axis=-1) * l * gain * signs
        out.append(y[:, keep_from:])
    return np.stack(out)


def golden_phased(spec, starts, wins, gain, keep_from, r):
    y = golden_bucket(spec, starts, wins, gain, keep_from)
    b = y.shape[1]
    p = (np.arange(b)[None, :] * np.asarray(starts)[:, None]) % r
    return y * np.exp(2j * np.pi * p / r)[..., None]


def pairs_to_complex(y):
    y = np.asarray(y)
    return y[..., 0] + 1j * y[..., 1]


def rel_rms(got, ref):
    return np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2))


def random_case(rng, b, n, l, c, equal_windows=False):
    spec = (
        rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    ).astype(np.complex64)
    starts = np.sort(rng.choice(n - l, size=c, replace=False)).astype(
        np.int32
    )
    if equal_windows:
        wins = np.tile(rng.random(l).astype(np.float32) + 0.1, (c, 1))
    else:
        wins = rng.random((c, l)).astype(np.float32) + 0.1
    return spec, starts, wins


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize(
    "b,n,l,c,keep_from,gain",
    [
        (13, 512, 64, 5, 16, 64.0),
        (64, 1024, 128, 3, 32, 1.0),
        (7, 256, 32, 1, 0, 32.0),
    ],
)
def test_extract_bucket_matches_golden(seed, b, n, l, c, keep_from, gain):
    """Per-channel windows fold into per-channel DFT matrices."""
    rng = np.random.default_rng(seed)
    spec, starts, wins = random_case(rng, b, n, l, c)
    got = extract_bucket(
        jnp.asarray(spec), starts, wins, gain=gain, use_mxu=True,
        keep_from=keep_from, pairs=True,
    )
    ref = golden_bucket(spec, starts, wins, gain, keep_from)
    assert got.shape == ref.shape + (2,)
    assert rel_rms(pairs_to_complex(got), ref) < 1e-5


@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize(
    "b,n,l,c,keep_from,gain",
    [
        (13, 512, 64, 5, 16, 64.0),
        (64, 1024, 128, 3, 32, 1.0),
    ],
)
def test_extract_bucket_equal_windows_matches_golden(
    seed, b, n, l, c, keep_from, gain
):
    """Equal-window bucket: one flat [C*B, 2l] @ [2l, 2k] matmul."""
    rng = np.random.default_rng(seed)
    spec, starts, wins = random_case(rng, b, n, l, c, equal_windows=True)
    got = extract_bucket(
        jnp.asarray(spec), starts, wins, gain=gain, use_mxu=True,
        keep_from=keep_from, pairs=True,
    )
    ref = golden_bucket(spec, starts, wins, gain, keep_from)
    assert rel_rms(pairs_to_complex(got), ref) < 1e-5


@pytest.mark.parametrize("r", [1, 2, 4])
def test_extract_bucket_phased_matches_golden(r):
    """Phase compensation e^{j 2 pi (b * start mod R) / R} per row."""
    rng = np.random.default_rng(7)
    b, n, l, c, keep_from = 21, 512, 64, 5, 16
    spec, starts, wins = random_case(rng, b, n, l, c, equal_windows=True)
    got = extract_bucket_phased(
        jnp.asarray(spec), starts, wins, r, gain=float(l), use_mxu=True,
        keep_from=keep_from,
    )
    ref = golden_phased(spec, starts, wins, float(l), keep_from, r)
    assert rel_rms(pairs_to_complex(got), ref) < 1e-5


@pytest.mark.parametrize("seed", range(6))
def test_extract_bucket_phased_fuzz(seed):
    """Random (B, l, keep_from, R) with starts covering every residue
    class mod R."""
    rng = np.random.default_rng(100 + seed)
    r = int(rng.choice([2, 4]))
    b = int(rng.integers(5, 40) | 1)
    l = int(rng.choice([32, 64]))
    n = 512
    keep_from = int(rng.choice([0, l // 4]))
    c = 2 * r  # two starts per residue class
    spec = (
        rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    ).astype(np.complex64)
    base = rng.choice((n - l) // r, size=c, replace=False) * r
    starts = np.sort(base + np.arange(c) % r).astype(np.int32)
    wins = np.tile(rng.random(l).astype(np.float32) + 0.1, (c, 1))
    got = extract_bucket_phased(
        jnp.asarray(spec), starts, wins, r, gain=float(l), use_mxu=True,
        keep_from=keep_from,
    )
    ref = golden_phased(spec, starts, wins, float(l), keep_from, r)
    assert rel_rms(pairs_to_complex(got), ref) < 1e-5, (r, b, l, keep_from)


def test_extract_bucket_phased_fallback_matches():
    """The phased wrapper is extract + apply_phase_pairs (bit-equal)."""
    rng = np.random.default_rng(11)
    b, n, l, c, keep_from, r = 12, 512, 64, 4, 16, 4
    spec, starts, wins = random_case(rng, b, n, l, c, equal_windows=True)
    y = extract_bucket(
        jnp.asarray(spec), starts, wins, gain=float(l), use_mxu=True,
        keep_from=keep_from, pairs=True,
    )
    phase_idx = (
        jnp.arange(b, dtype=jnp.int32)[None, :]
        * jnp.asarray(starts)[:, None]
    ) % r
    ref = np.asarray(apply_phase_pairs(y, phase_idx, r))
    got = np.asarray(
        extract_bucket_phased(
            jnp.asarray(spec), starts, wins, r, gain=float(l),
            use_mxu=True, keep_from=keep_from,
        )
    )
    np.testing.assert_array_equal(ref, got)


def test_extract_bucket_complex_output():
    rng = np.random.default_rng(3)
    b, n, l, c = 9, 256, 32, 2
    spec = (
        rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    ).astype(np.complex64)
    starts = np.asarray([10, 100], np.int32)
    wins = rng.random((c, l)).astype(np.float32) + 0.1
    got = extract_bucket(
        jnp.asarray(spec), starts, wins, use_mxu=True, keep_from=8,
        pairs=False,
    )
    assert np.iscomplexobj(np.asarray(got))
    ref = golden_bucket(spec, starts, wins, 1.0, 8)
    assert rel_rms(np.asarray(got), ref) < 1e-5


def test_extract_fft_and_matmul_paths_agree():
    """use_mxu_fft=False (FFT lowering) == the matmul-DFT route."""
    rng = np.random.default_rng(5)
    spec, starts, wins = random_case(rng, 16, 512, 64, 4)
    kw = dict(gain=64.0, keep_from=16, pairs=True)
    a = extract_bucket(jnp.asarray(spec), starts, wins, use_mxu=True, **kw)
    b = extract_bucket(jnp.asarray(spec), starts, wins, use_mxu=False, **kw)
    ref = golden_bucket(spec, starts, wins, 64.0, 16)
    assert rel_rms(pairs_to_complex(a), ref) < 1e-5
    assert rel_rms(pairs_to_complex(b), ref) < 1e-5


def test_extract_traced_tables_match_static():
    """Traced starts/windows (the sharded per-rank views) take the
    multiply-then-matmul route; it must agree with the static fold."""
    rng = np.random.default_rng(9)
    spec, starts, wins = random_case(rng, 10, 512, 64, 3)
    kw = dict(gain=2.0, use_mxu=True, keep_from=16, pairs=True)
    a = extract_bucket(jnp.asarray(spec), starts, wins, **kw)
    b = extract_bucket(
        jnp.asarray(spec), jnp.asarray(starts), jnp.asarray(wins), **kw
    )
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("seed", [0, 3])
def test_power_measures_match_golden(seed):
    """band_power (mask matmul at full float32 precision) and cell_power
    (decimated sums) against float64 sums of |X|^2."""
    b, n = 13, 512
    rng = np.random.default_rng(seed)
    spec = (
        rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    ).astype(np.complex64)
    masks = np.zeros((n, 2), np.float32)
    masks[40:90, 0] = 1.0
    masks[300:310, 1] = 1.0
    sq64 = np.abs(spec.astype(np.complex128)) ** 2
    sq = jnp.abs(jnp.asarray(spec)) ** 2
    np.testing.assert_allclose(
        np.asarray(band_power(sq, jnp.asarray(masks))), sq64 @ masks,
        rtol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(cell_power(sq, 100, 16, 8)),
        sq64[:, 100:228].reshape(b, 16, 8).sum(axis=-1),
        rtol=1e-5,
    )


def test_extract_dynamic_matches_golden():
    """Variable-width slot extraction at one static width: sample m*q of
    the interpolated output is the w-point unnormalized IFFT of the
    windowed slice (the host emitter strides by q, applies (-1)^m)."""
    rng = np.random.default_rng(1)
    b, n, w_max = 6, 256, 32
    spec = (
        rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    ).astype(np.complex64)
    starts = np.array([10, 100, 240], np.int32)
    wlog2 = np.array([5, 3, 4], np.int32)
    wins = np.zeros((3, w_max), np.float32)
    for i, wl in enumerate(wlog2):
        wins[i, :1 << wl] = rng.random(1 << wl) + 0.1
    for use_mxu in (True, False):
        got = np.asarray(extract_dynamic(
            jnp.asarray(spec), jnp.asarray(starts), jnp.asarray(wlog2),
            jnp.asarray(wins), w_max, use_mxu=use_mxu,
        ))
        for i, (s, wl) in enumerate(zip(starts, wlog2)):
            w = 1 << wl
            z = np.zeros((b, w), np.complex128)
            seg = spec[:, s:s + w].astype(np.complex128)
            z[:, :seg.shape[1]] = seg
            ref = np.fft.ifft(z * wins[i, :w], axis=-1) * w
            assert rel_rms(got[i, :, ::w_max // w], ref) < 1e-5, (i, use_mxu)
