"""Multi-segment activity-detection channelizer (vcm equivalent) end-to-end."""

import numpy as np
import pytest

from fdc_tpu.config import solve_segment_vcm
from fdc_tpu.models.activity_detection import ActivityDetectionChannelizer
from fdc_tpu.ops.fft import forward_spectrum
from fdc_tpu.ops.framing import frame_blocks

import jax
import jax.numpy as jnp


def make_spectra(n_blocks, blocklen, relinvovl, carriers):
    """Overlap-save front-end on a synthetic capture; carriers is a list of
    (fdc_freq, amplitude, on_block, off_block)."""
    inplen = blocklen - blocklen // relinvovl
    n = n_blocks * inplen
    t = np.arange(n)
    rng = np.random.default_rng(2)
    x = (0.005 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    for f, a, on, off in carriers:
        m = np.zeros(n)
        m[on * inplen: off * inplen] = 1.0
        x = x + a * m * np.exp(2j * np.pi * (f - 0.5) * t)
    x = x.astype(np.complex64)

    @jax.jit
    def fe(xx):
        blocks, _ = frame_blocks(
            xx, jnp.zeros((blocklen // relinvovl,), jnp.complex64), blocklen
        )
        return forward_spectrum(blocks)

    return np.asarray(fe(jnp.asarray(x)))


def test_vcm_geometry_rules():
    g = solve_segment_vcm(1024, 0.1, 0.3, 0.02)
    assert g.width % g.decimation == 0
    assert 0 <= g.start < g.stop <= 1024
    with pytest.raises(ValueError):
        solve_segment_vcm(1024, 0.4, 0.2, 0.02)


def test_multi_segment_independent_detection():
    blocklen, r = 512, 4
    adc = ActivityDetectionChannelizer(
        blocklen=blocklen,
        segments=[[0.05, 0.3], [0.6, 0.9]],
        thresh_db=8.0,
        relinvovl=r,
        minchandist=0.02,
        channel_deactivation_delay=1,
        window_flank_puffer=0.1,
        max_slots=8,
        max_candidates=8,
    )
    runner = adc.make_runner(maxblocks=256)

    # carrier in segment 0 only (blocks 10..30), then one in segment 1
    spectra = make_spectra(
        48, blocklen, r,
        [(0.15, 2.0, 10, 30), (0.75, 2.0, 20, 40)],
    )
    events = []
    for lo in range(0, len(spectra), 8):
        events.extend(runner.process_spectra(spectra[lo: lo + 8]))

    fin = [e for e in events if e.finalized]
    assert len(fin) >= 2
    seg0 = [e for e in fin if ".DETECTED.0." in e.ID]
    seg1 = [e for e in fin if ".DETECTED.1." in e.ID]
    assert seg0 and seg1
    # frequencies land on the respective carriers
    assert any(abs(e.rel_cfreq - 0.15) < 0.03 for e in seg0)
    assert any(abs(e.rel_cfreq - 0.75) < 0.03 for e in seg1)
    # burst extents match the scripted on/off blocks (within delay slack)
    e0 = max(seg0, key=lambda e: e.blockend - e.blockstart)
    assert 8 <= e0.blockstart <= 12
    assert 29 <= e0.blockend <= 34
    e1 = max(seg1, key=lambda e: e.blockend - e.blockstart)
    assert 18 <= e1.blockstart <= 22
    assert 39 <= e1.blockend <= 44


def test_extracted_burst_snr():
    """The reconstructed burst samples must be a clean tone."""
    blocklen, r = 512, 4
    adc = ActivityDetectionChannelizer(
        blocklen=blocklen,
        segments=[[0.05, 0.45]],
        thresh_db=8.0,
        relinvovl=r,
        minchandist=0.02,
        channel_deactivation_delay=1,
        window_flank_puffer=0.1,
        max_slots=8,
        max_candidates=8,
    )
    runner = adc.make_runner()
    f0 = 0.25
    spectra = make_spectra(40, blocklen, r, [(f0, 1.0, 8, 32)])
    events = []
    for lo in range(0, len(spectra), 8):
        events.extend(runner.process_spectra(spectra[lo: lo + 8]))
    fin = [e for e in events if e.finalized and len(e.data)]
    assert fin
    # pick the event on the scripted carrier (noise can legitimately spawn
    # spurious wide channels, as in the reference's edge pairing)
    e = min(fin, key=lambda ev: abs(ev.rel_cfreq - f0))
    assert abs(e.rel_cfreq - f0) < 0.03
    y = e.data
    # drop edge blocks (burst ramp in/out), measure tone purity
    core = y[len(y) // 4: -len(y) // 4]
    ph = np.unwrap(np.angle(core))
    fit = np.polyfit(np.arange(len(ph)), ph, 1)
    tone = np.exp(1j * np.polyval(fit, np.arange(len(ph))))
    amp = np.abs(core).mean()
    resid = core / amp - tone
    snr_db = -10 * np.log10(np.mean(np.abs(resid) ** 2) + 1e-30)
    assert amp == pytest.approx(1.0, abs=0.1)
    assert snr_db > 20.0, snr_db


@pytest.mark.parametrize("native_emission", [False, True])
def test_vcm_matches_golden(native_emission):
    """vcm-SPECIFIC sequential golden replay: the
    multi-segment runner must reproduce the reference vcm block's event
    stream including its deltas vs SegmentDetection — 1/dec power
    normalization, FLT_MIN zero-ratio handling, blockcount-from-1, and
    inline maxblocks partial emission
    (reference: lib/activity_detection_channelizer_vcm_impl.cc:598-841).
    Cross-segment event interleaving is compared per segment: the reference
    walks segments per block, the batched runner per batch."""
    from golden import golden_activity_detection_vcm

    if native_emission:
        from fdc_tpu.runtime import native as native_mod

        if not native_mod.available():
            pytest.skip("native toolchain unavailable")

    blocklen, r = 512, 4
    segments = [[0.05, 0.45], [0.55, 0.95]]
    thresh_db, mcd, puffer, maxblocks, delay = 8.0, 0.02, 0.2, 5, 1
    spectra = make_spectra(
        40, blocklen, r,
        [(0.25, 1.0, 6, 16), (0.62, 0.9, 10, 24), (0.82, 1.2, 12, 20)],
    )

    adc = ActivityDetectionChannelizer(
        blocklen=blocklen, segments=segments, thresh_db=thresh_db,
        relinvovl=r, minchandist=mcd, channel_deactivation_delay=delay,
        window_flank_puffer=puffer, max_slots=8,
    )
    runner = adc.make_runner(maxblocks=maxblocks,
                             native_emission=native_emission)
    events = []
    for lo in range(0, len(spectra), 8):
        events.extend(runner.process_spectra(spectra[lo: lo + 8]))

    ref = golden_activity_detection_vcm(
        spectra.astype(np.complex128), blocklen, r, segments, thresh_db,
        mcd, puffer, maxblocks, delay,
    )
    assert len([g for g in ref if not g["finalized"]]) > 0, "need partials"
    assert len(events) == len(ref), (
        f"{len(events)} vs golden {len(ref)}"
    )
    for sid in range(len(segments)):
        ours = [e for e in events if f".DETECTED.{sid}." in e.ID]
        gold = [g for g in ref if g["seg_id"] == sid]
        assert len(ours) == len(gold)
        for ev, g in zip(ours, gold):
            assert ev.finalized == g["finalized"]
            assert ev.blockstart == g["blockstart"], (
                ev.blockstart, g["blockstart"],
            )
            assert ev.blockend == g["blockend"]
            assert ev.vectorstart == g["vectorstart"]
            assert ev.vectorend == g["vectorend"]
            if g["part"] is not None:
                assert ev.part == g["part"]
            assert int(ev.ID.split(".")[-1]) == g["chan_id"]
            np.testing.assert_allclose(ev.rel_cfreq, g["rel_cfreq"])
            np.testing.assert_allclose(ev.rel_bw, g["rel_bw"])
            assert ev.data.shape == g["data"].shape
            np.testing.assert_allclose(ev.data, g["data"], atol=3e-4)


def test_vcm_split_bucket_matches_single_bucket():
    """Two-tier extraction on the vcm runner is event-identical to the
    default single-bucket path."""
    blocklen, r = 512, 4
    kw = dict(
        blocklen=blocklen, segments=[[0.05, 0.45]], thresh_db=8.0,
        relinvovl=r, minchandist=0.02, channel_deactivation_delay=1,
        window_flank_puffer=0.1, max_slots=8, max_extract_width=256,
    )
    spectra = make_spectra(40, blocklen, r, [(0.25, 1.0, 8, 32)])

    def run(**extra):
        runner = ActivityDetectionChannelizer(**kw, **extra).make_runner()
        events = []
        for lo in range(0, len(spectra), 8):
            events.extend(runner.process_spectra(spectra[lo: lo + 8]))
        return events

    ev_a = run()
    ev_b = run(extract_budget=2, extract_width_split=64,
               extract_budget_narrow=4)
    assert len(ev_a) == len(ev_b) > 0
    for a, b in zip(ev_a, ev_b):
        assert a.blockstart == b.blockstart and a.blockend == b.blockend
        np.testing.assert_allclose(a.data, b.data, rtol=1e-5, atol=1e-6)


def test_runner_native_matches_python_emission():
    from fdc_tpu.runtime import native as native_mod

    if not native_mod.available():
        import pytest as _pytest

        _pytest.skip("native toolchain unavailable")

    blocklen, r = 512, 4
    kw = dict(
        blocklen=blocklen, segments=[[0.05, 0.45]], thresh_db=8.0,
        relinvovl=r, minchandist=0.02, channel_deactivation_delay=1,
        window_flank_puffer=0.1, max_slots=8, max_candidates=8,
    )
    spectra = make_spectra(40, blocklen, r, [(0.25, 1.0, 8, 32)])

    ev = {}
    for mode in (False, True):
        runner = ActivityDetectionChannelizer(**kw).make_runner(
            native_emission=mode
        )
        events = []
        for lo in range(0, len(spectra), 8):
            events.extend(runner.process_spectra(spectra[lo: lo + 8]))
        ev[mode] = events

    assert len(ev[False]) == len(ev[True])
    for a, b in zip(ev[False], ev[True]):
        assert a.ID.split(".", 1)[1] == b.ID.split(".", 1)[1]
        assert a.blockstart == b.blockstart and a.blockend == b.blockend
        np.testing.assert_allclose(a.data, b.data, rtol=1e-5, atol=1e-7)
