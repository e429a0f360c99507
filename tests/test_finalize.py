"""flush(finalize=True): event sets no longer depend on capture length mod batch.

A capture ending exactly on a batch boundary left
open bursts open while a ragged tail zero-pad-finalized them. The unified
contract: flush() (default finalize=True) feeds silence batches until
every burst channel and detection slot deactivates, so both boundary
cases emit the same finalize events; finalize=False restores the
tail-only behavior.
"""

import numpy as np
import pytest

from fdc_tpu.config import ChannelizerConfig
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer


def config(**kw):
    base = dict(
        blocksize=256,
        relinvovl=4,
        activity_controlled_channels=[(0.3, 0.05)],
        activity_detection_segments=[(-0.47, -0.3)],
        act_contr_threshold=10.0,
        act_det_threshold=8.0,
        minchandist=0.02,
        freqmode="basebandfs",
        batch_blocks=8,
        max_slots=8,
        max_candidates=8,
    )
    base.update(kw)
    return ChannelizerConfig(**base)


def burst_to_end(n, start_frac=0.6):
    """Capture with bursts (one PA carrier + one detection carrier) that
    stay ON through the final sample — open at end-of-capture."""
    t = np.arange(n)
    rng = np.random.default_rng(5)
    x = (0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(
        np.complex64
    )
    m = np.zeros(n)
    m[int(n * start_frac):] = 1.0
    x += (2.0 * m * np.exp(2j * np.pi * 0.3 * t)).astype(np.complex64)
    x += (2.0 * m * np.exp(2j * np.pi * -0.4 * t)).astype(np.complex64)
    return x


def key(ev):
    return (ev.ID.split(".", 1)[1], ev.blockstart, ev.blockend,
            ev.finalized, ev.part)


@pytest.mark.parametrize("extra_samples", [0, 1, 37])
def test_finalize_closes_open_bursts_both_boundary_cases(extra_samples):
    cfg = config()
    fdc = FrequencyDomainChannelizer(cfg)
    n = 4 * fdc.batch_samples + extra_samples  # 0 => exact batch boundary
    x = burst_to_end(n)
    events = list(fdc.process(x).events)
    res = fdc.flush()
    events += res.events

    fins = [e for e in events if e.finalized]
    ids = {e.ID.split(".", 1)[1].rsplit(".", 1)[0] for e in events}
    # both the PA burst and the detected channel must finalize, boundary
    # aligned or not
    assert any("PowActChan" in i for i in ids)
    assert any("DETECTED" in i for i in ids)
    assert sum("PowActChan" in e.ID for e in fins) == 1
    # the detection burst open at capture end finalized in the padded
    # silence (its blockend lies at/after the last real block)
    n_blocks = -(-len(x) // cfg.inplen)
    det_fins = [e for e in fins if "DETECTED" in e.ID]
    assert det_fins and max(e.blockend for e in det_fins) >= n_blocks
    # no open bursts remain; a second flush is a no-op
    assert not fdc._open_bursts()
    res2 = fdc.flush()
    assert res2.events == [] and res2.blocks_processed == 0


def test_finalize_event_set_invariant_across_boundary():
    """Aligned and ragged captures of the same burst scenario produce the
    same event sequence (modulo the block span growth from the extra
    real blocks of the longer capture)."""
    cfg = config()
    fdc_a = FrequencyDomainChannelizer(cfg)
    n = 4 * fdc_a.batch_samples

    ev_a = list(fdc_a.process(burst_to_end(n)).events)
    ev_a += fdc_a.flush().events

    # same scenario, one extra silent block => ragged tail path
    fdc_b = FrequencyDomainChannelizer(cfg)
    x_b = np.concatenate(
        [burst_to_end(n), np.zeros(cfg.inplen, np.complex64)]
    )
    ev_b = list(fdc_b.process(x_b).events)
    ev_b += fdc_b.flush().events

    assert len(ev_a) == len(ev_b) > 0
    for a, b in zip(ev_a, ev_b):
        # IDs modulo timestamp; spans equal (the burst ends at the same
        # global block either way — silence is silence)
        assert a.ID.split(".", 1)[1] == b.ID.split(".", 1)[1]
        assert a.blockstart == b.blockstart
        assert a.blockend == b.blockend
        assert a.finalized == b.finalized


def test_finalize_false_keeps_tail_only_contract():
    cfg = config()
    fdc = FrequencyDomainChannelizer(cfg)
    x = burst_to_end(4 * fdc.batch_samples)  # aligned
    fdc.process(x)
    res = fdc.flush(finalize=False)
    assert res.events == []  # nothing pending, nothing finalized
    assert fdc._open_bursts()  # bursts stay open (historic behavior)


def test_finalize_stream_outputs_untouched():
    """Silence-only finalize batches add no stream samples/blocks."""
    cfg = config(throughput_channels=[(-0.25, 0.04)])
    fdc = FrequencyDomainChannelizer(cfg)
    x = burst_to_end(4 * fdc.batch_samples)
    r1 = fdc.process(x)
    n_tp = len(r1.throughput[0])
    res = fdc.flush()
    assert res.blocks_processed == 0
    assert len(res.throughput[0]) == 0
    assert all(p.shape[0] == 0 for p in res.segment_power)
    assert n_tp == 4 * cfg.batch_blocks * fdc.throughput.buckets[0].out_len
