"""End-to-end tests of the power-activation and segment-detection paths:
the full FrequencyDomainChannelizer (device scan + host emission) must
reproduce the golden sequential reference model's event stream — same
events, same metadata, same data — including bursts crossing jitted-step
boundaries."""

import numpy as np
import pytest

from fdc_tpu import ChannelizerConfig, FrequencyDomainChannelizer

from golden import (
    golden_overlap_save,
    golden_forward_fft,
    golden_power_activation,
    golden_segment_detection,
)

RNG = np.random.default_rng(11)


def burst_signal(n_blocks, inplen, bursts, noise_amp=1e-3):
    """bursts: [(block_on, block_off, fdc_freq, amp)] — tone active for
    blocks in [on, off)."""
    n = n_blocks * inplen
    t = np.arange(n)
    x = (
        RNG.standard_normal(n) + 1j * RNG.standard_normal(n)
    ) * noise_amp
    for on, off, fdc_freq, amp in bursts:
        gate = np.zeros(n)
        gate[on * inplen : off * inplen] = 1.0
        x = x + amp * gate * np.exp(2j * np.pi * (fdc_freq - 0.5) * t)
    return x.astype(np.complex64)


def spectra_of(x, n, r):
    blocks, _ = golden_overlap_save(x.astype(np.complex128), n, n // r)
    return golden_forward_fft(blocks)


def check_events(ours, ref, atol, check_vector=False):
    assert len(ours) == len(ref), (
        f"{len(ours)} events vs golden {len(ref)}:\n"
        f"ours: {[(e.ID, e.blockstart, e.blockend, e.finalized) for e in ours]}\n"
        f"ref:  {[(d['blockstart'], d['blockend'], d['finalized']) for d in ref]}"
    )
    for i, (ev, g) in enumerate(zip(ours, ref)):
        assert ev.finalized == g["finalized"], i
        assert ev.blockstart == g["blockstart"], (i, ev.blockstart, g["blockstart"])
        assert ev.blockend == g["blockend"], (i, ev.blockend, g["blockend"])
        np.testing.assert_allclose(ev.rel_cfreq, g["rel_cfreq"], atol=1e-9)
        np.testing.assert_allclose(ev.rel_bw, g["rel_bw"], atol=1e-9)
        if g["part"] is not None:
            assert ev.part == g["part"], i
        if check_vector:
            assert ev.vectorstart == g["vectorstart"], i
            assert ev.vectorend == g["vectorend"], i
        assert ev.data.shape == g["data"].shape, (
            i, ev.data.shape, g["data"].shape,
        )
        np.testing.assert_allclose(ev.data, g["data"], atol=atol, err_msg=str(i))


@pytest.mark.parametrize("batch_blocks", [8, 32])
def test_power_activation_matches_golden(batch_blocks):
    n, r = 1024, 4
    inplen = n - n // r
    n_blocks = 32
    cfreq_fdc = 0.75
    bw = 0.05
    # two bursts; the first crosses the 8-block step boundary
    x = burst_signal(
        n_blocks, inplen,
        [(5, 13, cfreq_fdc, 1.0), (20, 24, cfreq_fdc, 0.7)],
    )

    fdc = FrequencyDomainChannelizer(
        ChannelizerConfig(
            blocksize=n,
            relinvovl=r,
            activity_controlled_channels=[(cfreq_fdc - 0.5, bw)],
            act_contr_threshold=10.0,
            pow_act_maxblocks=5,  # exercise partial emission
            batch_blocks=batch_blocks,
        )
    )
    res = fdc.process(x)
    assert res.blocks_processed == n_blocks

    ref = golden_power_activation(
        spectra_of(x, n, r), n, r, cfreq_fdc, bw, 10.0, 5
    )
    assert len(ref) >= 4  # 2 fins + partials — sanity of the scenario
    check_events(res.events, ref, atol=2e-4)
    # ID convention: timestamp.PowActChan.<chan>.<burst counter>
    for ev in res.events:
        parts = ev.ID.split(".")
        assert parts[1] == "PowActChan"


@pytest.mark.parametrize("batch_blocks", [8, 16])
def test_segment_detection_matches_golden(batch_blocks):
    n, r = 1024, 4
    inplen = n - n // r
    n_blocks = 32
    seg = (0.1, 0.9)  # FDC coords
    mcd = 0.04  # -> decimation 20
    thresh_db = 8.0
    puffer = 0.2
    maxblocks = 6
    delay = 1

    # carrier A spans a batch boundary; carrier B is short; C is wider
    x = burst_signal(
        n_blocks, inplen,
        [
            (4, 14, 0.30, 1.0),
            (8, 12, 0.60, 0.8),
            (18, 26, 0.45, 0.9),
        ],
        noise_amp=2e-3,
    )

    fdc = FrequencyDomainChannelizer(
        ChannelizerConfig(
            blocksize=n,
            relinvovl=r,
            activity_detection_segments=[(seg[0] - 0.5, seg[1] - 0.5)],
            act_det_threshold=thresh_db,
            minchandist=mcd,
            minchanflankpuffer=puffer,
            act_det_maxblocks=maxblocks,
            act_det_deactivation_delay=delay,
            batch_blocks=batch_blocks,
        )
    )
    res = fdc.process(x)

    ref = golden_segment_detection(
        spectra_of(x, n, r), n, r, seg[0], seg[1], thresh_db, mcd,
        puffer, maxblocks, delay,
    )
    assert len(ref) >= 3, f"weak scenario: only {len(ref)} golden events"
    check_events(res.events, ref, atol=3e-4, check_vector=True)
    # ID convention: timestamp.DETECTED.<segment>.<channel counter>
    for ev, g in zip(res.events, ref):
        parts = ev.ID.split(".")
        assert parts[-2] == "0" and parts[-3] == "DETECTED"
        assert int(parts[-1]) == g["chan_id"]


def test_segment_detection_crowded_band_matches_golden():
    """A dense DAMA-style band: 12 carriers rising in the SAME block — more
    simultaneous rising edges than any small strongest-K cap. With
    max_candidates=0 (exact mode, the default) every edge must be considered
    and the event stream must match the golden reference replay
    (reference: lib/SegmentDetection_impl.cc:208-243)."""
    n, r = 1024, 4
    inplen = n - n // r
    n_blocks = 24
    seg = (0.05, 0.95)
    mcd = 0.02  # -> decimation 10, ~90 cells
    thresh_db = 8.0

    carriers = [0.10 + 0.07 * i for i in range(12)]  # 12 simultaneous rises
    bursts = [(4, 12, f, 0.9 + 0.02 * (i % 3)) for i, f in enumerate(carriers)]
    x = burst_signal(n_blocks, inplen, bursts, noise_amp=2e-3)

    fdc = FrequencyDomainChannelizer(
        ChannelizerConfig(
            blocksize=n,
            relinvovl=r,
            activity_detection_segments=[(seg[0] - 0.5, seg[1] - 0.5)],
            act_det_threshold=thresh_db,
            minchandist=mcd,
            act_det_maxblocks=256,
            batch_blocks=8,
            max_slots=24,
        )
    )
    assert fdc.segments[0].max_candidates == 0  # exact mode engaged
    res = fdc.process(x)

    ref = golden_segment_detection(
        spectra_of(x, n, r), n, r, seg[0], seg[1], thresh_db, mcd,
        0.2, 256, 1,
    )
    # every carrier must produce (at least) its finalized burst — with a
    # strongest-8 cap several would be silently dropped
    assert len([g for g in ref if g["finalized"]]) >= 12
    check_events(res.events, ref, atol=3e-4, check_vector=True)


def test_segment_detection_extract_budget_bit_exact():
    """Device-side output compaction (extract_budget < max_slots) must be
    invisible when the budget covers the concurrent channel count: same
    events, same data, and an order-of-magnitude smaller extraction tensor
    shipped per step."""
    n, r = 1024, 4
    inplen = n - n // r
    n_blocks = 32
    seg, mcd, thresh_db = (0.1, 0.9), 0.04, 8.0
    x = burst_signal(
        n_blocks, inplen,
        [(4, 14, 0.30, 1.0), (8, 12, 0.60, 0.8), (18, 26, 0.45, 0.9)],
        noise_amp=2e-3,
    )

    def build(budget):
        return FrequencyDomainChannelizer(
            ChannelizerConfig(
                blocksize=n,
                relinvovl=r,
                activity_detection_segments=[(seg[0] - 0.5, seg[1] - 0.5)],
                act_det_threshold=thresh_db,
                minchandist=mcd,
                act_det_maxblocks=6,
                batch_blocks=8,
                max_slots=16,
                extract_budget=budget,
            )
        )

    ref = golden_segment_detection(
        spectra_of(x, n, r), n, r, seg[0], seg[1], thresh_db, mcd,
        0.2, 6, 1,
    )
    fdc = build(4)  # at most 2 channels concurrent in this scenario
    res = fdc.process(x)
    check_events(res.events, ref, atol=3e-4, check_vector=True)
    assert fdc.segment_emitters[0].lost_rows == 0

    # budget 1 with 2 concurrent channels: same event stream shape/metadata,
    # but overflowed slots' samples are zeroed and counted (clamp/skip+log)
    fdc1 = build(1)
    res1 = fdc1.process(x)
    assert len(res1.events) == len(ref)
    for ev, g in zip(res1.events, ref):
        assert ev.blockstart == g["blockstart"]
        assert ev.blockend == g["blockend"]
        assert ev.data.shape == g["data"].shape
    assert fdc1.segment_emitters[0].lost_rows > 0
    # the device-side overflow counter is surfaced (counted + loggable),
    # not silently dropped
    assert fdc1.segment_emitters[0].overflow_slots > 0
    assert fdc.segment_emitters[0].overflow_slots == 0


@pytest.mark.parametrize("native", [False, True])
def test_segment_detection_split_bucket_bit_exact(native):
    """Two-tier extraction (extract_width_split): narrow slots ship from a
    [E_n, B+1, W_split] tensor, wide ones (and narrow overflow) from the
    w_cap bucket — events must be identical to the single-bucket path."""
    from fdc_tpu.runtime import native as native_mod

    if native and not native_mod.available():
        pytest.skip("native toolchain unavailable")

    n, r = 1024, 4
    inplen = n - n // r
    n_blocks = 32
    seg, mcd, thresh_db = (0.1, 0.9), 0.04, 8.0
    # narrow carriers (-> small widths) + one wide carrier
    x = burst_signal(
        n_blocks, inplen,
        [
            (4, 14, 0.30, 1.0),          # narrow
            (8, 12, 0.60, 0.8),          # narrow
            (18, 26, 0.45, 0.9),         # wider band
        ],
        noise_amp=2e-3,
    )

    def build(**kw):
        return FrequencyDomainChannelizer(
            ChannelizerConfig(
                blocksize=n,
                relinvovl=r,
                activity_detection_segments=[(seg[0] - 0.5, seg[1] - 0.5)],
                act_det_threshold=thresh_db,
                minchandist=mcd,
                act_det_maxblocks=6,
                batch_blocks=8,
                max_slots=16,
                max_extract_width=512,
                native_emission=native,
                **kw,
            )
        )

    ref = build(extract_budget=8).process(x)
    fdc = build(extract_budget=4, extract_width_split=128,
                extract_budget_narrow=4)
    res = fdc.process(x)

    assert len(ref.events) == len(res.events) > 0
    for a, b in zip(ref.events, res.events):
        assert a.blockstart == b.blockstart
        assert a.blockend == b.blockend
        assert a.vectorstart == b.vectorstart
        assert a.data.shape == b.data.shape
        np.testing.assert_allclose(a.data, b.data, rtol=1e-5, atol=1e-6)
    if not native:
        assert fdc.segment_emitters[0].lost_rows == 0
    else:
        assert fdc.segment_emitters[0].lost_rows == 0


def test_segment_detection_silence_has_no_events():
    n, r = 512, 4
    inplen = n - n // r
    x = (RNG.standard_normal(16 * inplen) * 1e-3).astype(np.complex64)
    fdc = FrequencyDomainChannelizer(
        ChannelizerConfig(
            blocksize=n,
            relinvovl=r,
            activity_detection_segments=[(-0.3, 0.3)],
            act_det_threshold=10.0,
            minchandist=0.05,
            batch_blocks=8,
        )
    )
    res = fdc.process(x)
    assert res.events == []


def test_file_output_roundtrip(tmp_path):
    """fileoutput mode writes reference-format burst files that the reader
    utilities reassemble into the emitted sample stream."""
    import numpy as np
    from fdc_tpu.config import ChannelizerConfig
    from fdc_tpu.models.channelizer import FrequencyDomainChannelizer
    from fdc_tpu.utils.events import read_event_file, scan_output_dir

    cfg = ChannelizerConfig(
        blocksize=256,
        relinvovl=4,
        activity_controlled_channels=[(0.2, 0.05)],
        act_contr_threshold=10.0,
        freqmode="basebandfs",
        batch_blocks=4,
        pow_act_maxblocks=4,  # force parted files
        fileoutput=True,
        msgoutput=True,
        outputpath=str(tmp_path),
    )
    fdc = FrequencyDomainChannelizer(cfg)
    n = 24 * cfg.inplen
    t = np.arange(n)
    rng = np.random.default_rng(0)
    x = (0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    m = np.zeros(n)
    m[6 * cfg.inplen: 18 * cfg.inplen] = 1.0
    x += (2.0 * m * np.exp(2j * np.pi * 0.2 * t)).astype(np.complex64)
    events = fdc.process(x).events
    assert any(not e.finalized for e in events), "need parted files"

    entries = scan_output_dir(str(tmp_path))
    assert entries
    assert any(e["finalized"] for e in entries)
    assert any(not e["finalized"] for e in entries)
    # reassembled file data == concatenated event data for the burst ID
    by_id = {}
    for e in entries:
        by_id.setdefault(e["ID"], []).append(e)
    ev_by_id = {}
    for ev in events:
        ev_by_id.setdefault(ev.ID.rsplit(".", 1)[0], []).append(ev)
    for event_id, files in by_id.items():
        data = np.concatenate([read_event_file(f["path"]) for f in files])
        ref = np.concatenate([e.data for e in ev_by_id[event_id]])
        np.testing.assert_array_equal(data, ref)
