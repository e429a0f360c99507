"""Scaled-down versions of the five BASELINE.json benchmark configs.

Each config from BASELINE.json ("configs") gets a CPU-sized functional
test: same structure, smaller sample counts. These are the judged
scenarios; the full-size versions run on the GPU via bench.py / examples.
"""

import numpy as np
import pytest

from fdc_tpu.config import ChannelizerConfig
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer
from fdc_tpu.parallel.mesh import make_mesh
from fdc_tpu.parallel.sharded import ShardedChannelizer


def tone_snr(y, skip=200):
    """SNR of a unit tone fit against the stream (dB)."""
    core = y[skip:]
    ph = np.unwrap(np.angle(core))
    fit = np.polyfit(np.arange(len(ph)), ph, 1)
    tone = np.exp(1j * np.polyval(fit, np.arange(len(ph))))
    amp = np.abs(core).mean()
    resid = core / amp - tone
    return amp, -10 * np.log10(np.mean(np.abs(resid) ** 2) + 1e-30)


def test_config1_single_static_channel_4096():
    """Config 1: tone+noise capture, 4096-pt overlap-save FFT, one fixed
    carrier; amplitude ~1 and clean extraction."""
    f0 = -0.2001953125  # exact bin at N=4096
    cfg = ChannelizerConfig(
        blocksize=4096,
        relinvovl=4,
        throughput_channels=[(f0, 0.02)],
        freqmode="basebandfs",
        batch_blocks=4,
    )
    fdc = FrequencyDomainChannelizer(cfg)
    rng = np.random.default_rng(0)
    n = 2 * fdc.batch_samples
    t = np.arange(n)
    x = (np.exp(2j * np.pi * f0 * t)
         + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    r1 = fdc.process(x[: n // 2])
    r2 = fdc.process(x[n // 2:])
    y = np.concatenate([r1.throughput[0], r2.throughput[0]])
    amp, snr = tone_snr(y)
    assert amp == pytest.approx(1.0, abs=0.05)
    assert snr > 25.0, snr


def test_config2_16_channel_static_dama():
    """Config 2: 16 equally spaced fixed channels; per-channel SNR."""
    chans = [(-0.4 + 0.05 * i, 0.03) for i in range(16)]
    cfg = ChannelizerConfig(
        blocksize=1024,
        relinvovl=4,
        throughput_channels=chans,
        freqmode="basebandfs",
        batch_blocks=8,
    )
    fdc = FrequencyDomainChannelizer(cfg)
    rng = np.random.default_rng(1)
    n = 4 * fdc.batch_samples
    t = np.arange(n)
    x = (0.005 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    for f, _ in chans:
        x += np.exp(2j * np.pi * f * t).astype(np.complex64)
    res = fdc.process(x)
    assert len(res.throughput) == 16
    for i, y in enumerate(res.throughput):
        amp, snr = tone_snr(y)
        assert amp == pytest.approx(1.0, abs=0.1), f"ch{i} amp {amp}"
        assert snr > 20.0, f"ch{i} snr {snr}"


def test_config3_32_power_activation_channels():
    """Config 3: 32 defined channels with hysteresis activation on bursty
    input; every scripted burst must produce one finalized event on its
    channel with the right span."""
    n_ch = 32
    chans = [(-0.45 + 0.9 * (i + 0.5) / n_ch, 0.8 / n_ch) for i in range(n_ch)]
    cfg = ChannelizerConfig(
        blocksize=1024,
        relinvovl=4,
        activity_controlled_channels=chans,
        act_contr_threshold=10.0,
        freqmode="basebandfs",
        batch_blocks=8,
        pow_act_maxblocks=128,
    )
    fdc = FrequencyDomainChannelizer(cfg)
    rng = np.random.default_rng(2)
    n_blocks = 48
    n = n_blocks * cfg.inplen
    t = np.arange(n)
    # noise floor high enough that off-bin spectral leakage of the strong
    # carriers stays below it (leakage-triggered activations are correct
    # behavior but not what this test scripts)
    x = (0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    bursts = {}  # channel -> (on_block, off_block)
    for i in range(0, n_ch, 4):  # 8 bursting channels
        on = 5 + (i // 4) * 4
        off = on + 10
        bursts[i] = (on, off)
        m = np.zeros(n)
        m[on * cfg.inplen: off * cfg.inplen] = 1.0
        # smooth on/off ramps: rectangular gating splatters sinc sidelobes
        # across the whole band and (correctly) trips other channels
        ramp = np.hanning(256)
        m = np.convolve(m, ramp / ramp.sum(), mode="same")
        x += (2.0 * m * np.exp(2j * np.pi * chans[i][0] * t)).astype(
            np.complex64
        )
    events = fdc.process(x).events
    fin = [e for e in events if e.finalized and len(e.data)]
    conv = cfg.converter
    for i, (on, off) in bursts.items():
        f_fdc = conv.to_fdc_freq(chans[i][0])
        match = [e for e in fin if abs(e.rel_cfreq - f_fdc) < 0.015]
        assert match, f"burst on ch{i} (fdc {f_fdc:.3f}) not reported"
        e = match[0]
        assert abs(e.blockstart - on) <= 3, (i, e.blockstart, on)
        assert abs(e.blockend - off) <= 3, (i, e.blockend, off)


def test_config4_dynamic_activity_detection():
    """Config 4: variable-width channels spawned from carrier detection —
    two simultaneous carriers of very different widths must come back with
    fitted power-of-2 widths."""
    cfg = ChannelizerConfig(
        blocksize=2048,
        relinvovl=4,
        activity_detection_segments=[(-0.45, 0.45)],
        act_det_threshold=8.0,
        minchandist=0.01,
        minchanflankpuffer=0.2,
        freqmode="basebandfs",
        batch_blocks=8,
        max_slots=16,
        max_candidates=8,
    )
    fdc = FrequencyDomainChannelizer(cfg)
    rng = np.random.default_rng(3)
    n_blocks = 40
    n = n_blocks * cfg.inplen
    t = np.arange(n)
    x = (0.002 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    # narrow tone and a wide band-limited signal, on blocks 8..30
    m = np.zeros(n)
    m[8 * cfg.inplen: 30 * cfg.inplen] = 1.0
    x += (1.5 * m * np.exp(2j * np.pi * -0.3 * t)).astype(np.complex64)
    wide = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    k = 24  # ~1/24 bandwidth moving average
    wide = np.convolve(wide, np.ones(k) / np.sqrt(k), mode="same")
    x += (1.2 * m * wide * np.exp(2j * np.pi * 0.25 * t)).astype(np.complex64)

    events = fdc.process(x).events
    fin = [e for e in events if e.finalized and len(e.data)]
    narrow = [e for e in fin if abs(e.rel_cfreq - 0.2) < 0.03]
    wide_ev = [e for e in fin if abs(e.rel_cfreq - 0.75) < 0.04]
    assert narrow, [round(e.rel_cfreq, 3) for e in fin]
    assert wide_ev, [round(e.rel_cfreq, 3) for e in fin]
    # width fitting: wide channel gets a wider power-of-2 extraction
    assert max(e.rel_bw for e in wide_ev) > max(e.rel_bw for e in narrow)


def test_config5_pod_scale_burst_hunter_scaled():
    """Config 5 (scaled): many dynamic slots + time/chan sharding on the
    8-device CPU mesh; sharded == single-device on a busy burst scene."""
    cfg = ChannelizerConfig(
        blocksize=512,
        relinvovl=4,
        activity_detection_segments=[(-0.45, -0.05), (0.05, 0.45)],
        act_det_threshold=8.0,
        minchandist=0.02,
        freqmode="basebandfs",
        batch_blocks=8,
        max_slots=32,  # scaled-down "512+ dynamic channels"
        max_candidates=16,
    )
    rng = np.random.default_rng(4)
    n = 4 * cfg.batch_blocks * cfg.inplen
    t = np.arange(n)
    x = (0.003 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    for i in range(10):  # many short bursts
        f = float(rng.uniform(-0.43, 0.43))
        if abs(f) < 0.06:
            continue
        on = int(rng.integers(0, 24))
        off = on + int(rng.integers(3, 8))
        m = np.zeros(n)
        m[on * cfg.inplen: off * cfg.inplen] = 1.0
        x += (2.0 * m * np.exp(2j * np.pi * f * t)).astype(np.complex64)

    ref = FrequencyDomainChannelizer(cfg)
    sh = ShardedChannelizer(cfg, mesh=make_mesh(n_time=4, n_chan=2))
    ev_a = ref.process(x).events
    ev_b = sh.process(x).events
    assert len(ev_a) >= 5, "busy burst scene expected"
    assert len(ev_a) == len(ev_b)
    for a, b in zip(ev_a, ev_b):
        assert a.ID.split(".", 1)[1] == b.ID.split(".", 1)[1]
        assert a.blockstart == b.blockstart and a.blockend == b.blockend
        np.testing.assert_allclose(a.data, b.data, rtol=3e-4, atol=3e-5)


def test_config5_512_slot_table_smoke():
    """Full-scale slot table (512 dynamic channels, the config-5 number):
    one streaming step must construct and run with finite outputs."""
    cfg = ChannelizerConfig(
        blocksize=1024,
        relinvovl=4,
        activity_detection_segments=[(-0.45, 0.45)],
        act_det_threshold=8.0,
        minchandist=0.002,
        freqmode="basebandfs",
        batch_blocks=2,
        max_slots=512,
        max_candidates=32,
        max_extract_width=128,
    )
    fdc = FrequencyDomainChannelizer(cfg)
    rng = np.random.default_rng(0)
    n = 2 * fdc.batch_samples
    t = np.arange(n)
    x = (0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    for i in range(40):  # a crowded band
        f = -0.44 + 0.88 * (i + 0.5) / 40
        x += (1.5 * np.exp(2j * np.pi * f * t)).astype(np.complex64)
    res = fdc.process(x)
    assert res.blocks_processed == 4
    st = fdc._carry["seg0"]
    # shape smoke: the 512-slot table allocates and tracks (edge pairing in
    # a crowded band merges neighbors, so exact counts are signal-dependent)
    assert int(np.asarray(st["active"]).sum()) >= 8
    assert int(np.asarray(st["alloc_counter"])) >= 8
    assert np.all(np.isfinite(np.asarray(res.segment_power[0])))
