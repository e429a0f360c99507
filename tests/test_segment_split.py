"""Segment partitioning (config.split_segment_geometry): sub-segments with
overlapping scan margins must reproduce the unsplit segment's detections —
including carriers sitting exactly on a cut — with no double-spawn and no
lost carrier (the churn remedy "more segments = more
scan owners" as a supported transform).

Semantics at the cut mirror the reference's own adjacent-segment borders
(lib/activity_detection_channelizer_vcm_impl.cc segments are independent
automata): a candidate is OWNED by the part whose half-open core contains
its extraction midpoint bin; the overlap margin only widens what each part
scans so edge ratios and the greedy acceptance see the unsplit
neighborhood. Deviation bound (see config.split_segment_geometry):
detections wider than the margin at a cut, acceptance interaction of
carriers within each other's width across a cut, and carriers below the
minchandist cell resolution straddling a cut; the adversarial
no-discipline sweep is tools/sweep_split_parity.py.
"""

import numpy as np
import pytest

from fdc_tpu.config import (
    ChannelizerConfig,
    solve_segment,
    split_segment_geometry,
)
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer


def _mk_cfg(blocksize=512, splits=(), max_slots=8, batch_blocks=8):
    return ChannelizerConfig(
        blocksize=blocksize,
        relinvovl=4,
        activity_detection_segments=[(0.1, 0.9)],
        act_det_threshold=8.0,
        minchandist=0.03,
        act_det_deactivation_delay=1,
        minchanflankpuffer=0.1,
        batch_blocks=batch_blocks,
        max_slots=max_slots,
        segment_splits=splits,
    )


def _capture(cfg, carriers, n_blocks=40, seed=3, noise=0.004):
    """carriers: (freq_normalized_0..1, amp, on_block, off_block)."""
    n = n_blocks * cfg.inplen
    t = np.arange(n)
    rng = np.random.default_rng(seed)
    x = noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for f, a, on, off in carriers:
        m = np.zeros(n)
        m[on * cfg.inplen: off * cfg.inplen] = 1.0
        x = x + a * m * np.exp(2j * np.pi * (f - 0.5) * t)
    return x.astype(np.complex64)


def _events(cfg, x):
    fdc = FrequencyDomainChannelizer(cfg)
    res = fdc.process(x)
    events = list(res.events)
    events.extend(fdc.flush(finalize=True).events)
    return events


def _sig(events):
    """Order/segment-number independent event signature: the ID's segment
    number legitimately differs between split and unsplit configs."""
    return sorted(
        (
            e.blockstart,
            e.blockend,
            round(e.rel_cfreq, 6),
            round(e.rel_bw, 6),
            bool(e.finalized),
            round(float(np.abs(e.data).sum()), 2),
        )
        for e in events
        if e.finalized
    )


def test_split_geometry_tiles_parent():
    parent = solve_segment(1024, 0.1, 0.9, 0.02)
    parts = split_segment_geometry(parent, 4, 2)
    assert len(parts) == 4
    dec = parent.decimation
    # cores tile the parent exactly, half-open, in order
    assert parts[0][1][0] == parent.start
    assert parts[-1][1][1] == parent.stop
    for (ga, ca), (gb, cb) in zip(parts, parts[1:]):
        assert ca[1] == cb[0]
    for g, core in parts:
        # scan region = core +/- overlap, clamped; same decimation grid
        assert g.decimation == dec
        assert (g.start - parent.start) % dec == 0
        assert g.start <= core[0] < core[1] <= g.stop
        assert core[0] - g.start <= 2 * dec
        assert g.stop - core[1] <= 2 * dec
        assert g.start >= parent.start and g.stop <= parent.stop


def test_split_validation():
    parent = solve_segment(1024, 0.1, 0.9, 0.02)
    with pytest.raises(ValueError):
        split_segment_geometry(parent, 1, 2)
    with pytest.raises(ValueError):
        split_segment_geometry(parent, 4, -1)
    with pytest.raises(ValueError):
        split_segment_geometry(parent, parent.n_cells + 1, 0)
    with pytest.raises(ValueError):
        _mk_cfg(splits=[(1, 2, 2)])  # index out of range
    with pytest.raises(ValueError):
        _mk_cfg(splits=[(0, 2, 2), (0, 4, 2)])  # duplicate index
    # JSON roundtrip keeps the split spec
    cfg = _mk_cfg(splits=[(0, 4, 2)])
    assert ChannelizerConfig.from_json(cfg.to_json()).segment_splits == (
        (0, 4, 2),
    )


def test_split_expands_segments_with_cores():
    cfg = _mk_cfg(splits=[(0, 4, 2)])
    fdc = FrequencyDomainChannelizer(cfg)
    assert len(fdc.segments) == 4
    assert [sd.segment_id for sd in fdc.segments] == [0, 1, 2, 3]
    cores = [sd.core_bins for sd in fdc.segments]
    assert all(c is not None for c in cores)
    for (a, b), (c, d) in zip(cores, cores[1:]):
        assert b == c  # cores tile


def test_split_matches_unsplit_interior_carriers():
    """Carriers well inside part cores: split == unsplit, event-exact."""
    cfg_u = _mk_cfg()
    cfg_s = _mk_cfg(splits=[(0, 4, 2)])
    fdc_s = FrequencyDomainChannelizer(cfg_s)
    # one carrier centered in every other part's core
    carriers = []
    for p, blk in [(0, 4), (2, 12), (3, 20)]:
        lo, hi = fdc_s.segments[p].core_bins
        carriers.append(
            ((lo + hi) // 2 / cfg_u.blocksize, 2.0, blk, blk + 8)
        )
    x = _capture(cfg_u, carriers)
    su, ss = _sig(_events(cfg_u, x)), _sig(_events(cfg_s, x))
    assert len(su) >= 3
    assert su == ss


def test_split_carrier_on_cut_detected_once():
    """A narrow carrier centered exactly on a part cut: exactly one part
    owns it (no double-spawn, no loss) and the event matches unsplit."""
    cfg_u = _mk_cfg()
    cfg_s = _mk_cfg(splits=[(0, 4, 2)])
    fdc_s = FrequencyDomainChannelizer(cfg_s)
    # frequency at the bin where part 0's core ends (the first cut)
    cut_bin = fdc_s.segments[0].core_bins[1]
    f_cut = cut_bin / cfg_u.blocksize
    x = _capture(cfg_u, [(f_cut, 2.0, 8, 20)])
    su, ss = _sig(_events(cfg_u, x)), _sig(_events(cfg_s, x))
    assert len(su) >= 1
    assert su == ss


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_split_boundary_fuzz(seed):
    """Randomized carriers biased toward the cuts: split events equal
    unsplit events (carriers sized under the overlap-margin bound)."""
    cfg_u = _mk_cfg()
    cfg_s = _mk_cfg(splits=[(0, 4, 3)])
    fdc_s = FrequencyDomainChannelizer(cfg_s)
    cuts = [sd.core_bins[1] for sd in fdc_s.segments[:-1]]
    g = fdc_s.segments[0].geometry
    rng = np.random.default_rng(seed)
    carriers = []
    blk = 4
    for i, cut in enumerate(cuts):
        # land near (within a couple of cells of) each cut
        b = cut + int(rng.integers(-2 * g.decimation, 2 * g.decimation))
        carriers.append(
            (b / cfg_u.blocksize, float(rng.uniform(1.5, 2.5)), blk,
             blk + int(rng.integers(6, 12)))
        )
        blk += 8
    x = _capture(cfg_u, carriers, n_blocks=48, seed=seed)
    su, ss = _sig(_events(cfg_u, x)), _sig(_events(cfg_s, x))
    assert su == ss
    assert len(su) >= 1


def test_split_same_batch_race_kill(monkeypatch):
    """A burst rising mid-batch at a cut double-spawns for one batch
    (midpoint jitter); the lagged KILL must silently discard the
    duplicate — event parity with unsplit, and the kill path actually
    fires (Python emitter backend, so the killed handling is pinned)."""
    import fdc_tpu.runtime.emission as em

    kills = {"n": 0}
    orig = em.SegmentDetectionEmitter.process_step

    def patched(self, outputs, slot_meta, t0):
        k = outputs.get("killed")
        if k is not None:
            kills["n"] += int(np.asarray(k).sum())
        return orig(self, outputs, slot_meta, t0)

    monkeypatch.setattr(em.SegmentDetectionEmitter, "process_step", patched)

    cfg_u = _mk_cfg()
    cfg_s = _mk_cfg(splits=[(0, 4, 2)]).replace(native_emission=False)
    fdc_s = FrequencyDomainChannelizer(cfg_s)
    cut = fdc_s.segments[0].core_bins[1]
    x = _capture(cfg_u, [(cut / cfg_u.blocksize, 2.0, 11, 20)], n_blocks=40)
    su, ss = _sig(_events(cfg_u, x)), _sig(_events(cfg_s, x))
    assert su == ss
    assert kills["n"] >= 1  # the duplicate really existed and was killed


def test_split_native_emitter_matches_python():
    """The native engine's kill_unit path produces the same events as the
    Python emitter's killed handling."""
    from fdc_tpu.runtime import native

    if not native.available():
        pytest.skip("native toolchain unavailable")
    cfg_u = _mk_cfg()
    base = _mk_cfg(splits=[(0, 4, 2)])
    fdc_tmp = FrequencyDomainChannelizer(base)
    cut = fdc_tmp.segments[0].core_bins[1]
    x = _capture(cfg_u, [(cut / cfg_u.blocksize, 2.0, 11, 20)], n_blocks=40)
    s_py = _sig(_events(base.replace(native_emission=False), x))
    s_nat = _sig(_events(base.replace(native_emission=True), x))
    assert s_py == s_nat
    assert len(s_py) >= 1


def test_split_pipeline_multiowner_parity():
    """Split parts spread over pipeline scan owners (the transform's
    purpose): event parity with the plain split channelizer — the
    cross-owner foreign-view plumbing must reproduce the in-jit
    reconciliation exactly."""
    import jax

    from fdc_tpu.parallel.pipeline import PipelineChannelizer

    cfg_s = _mk_cfg(splits=[(0, 4, 2)])
    fdc_s = FrequencyDomainChannelizer(cfg_s)
    cut = fdc_s.segments[0].core_bins[1]
    lo2, hi2 = fdc_s.segments[2].core_bins
    x = _capture(
        cfg_s,
        [(cut / cfg_s.blocksize, 2.0, 11, 19),
         (((lo2 + hi2) // 2) / cfg_s.blocksize, 2.0, 6, 30)],
        n_blocks=40,
    )
    ref = _sig(_events(cfg_s, x))
    pl = PipelineChannelizer(
        cfg_s, devices=jax.devices()[:5], dedicated_owner=True,
        scan_owners=4,
    )
    res = pl.process(x)
    ev = list(res.events)
    ev.extend(pl.flush(finalize=True).events)
    assert _sig(ev) == ref
    assert len(ref) >= 2


def test_split_sharded_parity():
    """ShardedChannelizer with a split segment equals the plain split
    channelizer (replicated reconciliation on the mesh)."""
    import jax

    from fdc_tpu.parallel.multihost import global_mesh
    from fdc_tpu.parallel.sharded import ShardedChannelizer

    cfg_s = _mk_cfg(splits=[(0, 4, 2)])
    fdc_s = FrequencyDomainChannelizer(cfg_s)
    cut = fdc_s.segments[0].core_bins[1]
    x = _capture(
        cfg_s, [(cut / cfg_s.blocksize, 2.0, 11, 19)], n_blocks=40
    )
    ref = _sig(_events(cfg_s, x))
    sh = ShardedChannelizer(
        cfg_s, mesh=global_mesh(n_chan=2, devices=jax.devices())
    )
    res = sh.process(x)
    ev = list(res.events)
    ev.extend(sh.flush(finalize=True).events)
    assert _sig(ev) == ref
    assert len(ref) >= 1


@pytest.mark.parametrize("seed", list(range(20, 30)))
def test_split_random_config_fuzz(seed):
    """Randomized splits (n_parts, overlap, threshold, batch size) and
    randomized carriers (interior AND near-cut, on/off block scripts):
    split events must equal unsplit events whenever carriers respect the
    overlap-margin bound. Carrier widths here are single tones (det
    width ~1-2 cells), far under any margin >= 2."""
    rng = np.random.default_rng(seed)
    n_parts = int(rng.integers(2, 5))
    ovl = int(rng.integers(2, 5))
    thresh = float(rng.uniform(6.0, 10.0))
    bb = int(rng.choice([4, 8, 16]))

    delay = int(rng.integers(0, 3))

    def cfg_with(splits):
        return ChannelizerConfig(
            blocksize=512, relinvovl=4,
            activity_detection_segments=[(0.1, 0.9)],
            act_det_threshold=thresh, minchandist=0.03,
            act_det_deactivation_delay=delay, minchanflankpuffer=0.1,
            batch_blocks=bb, max_slots=8, segment_splits=splits,
        )

    cfg_u = cfg_with(())
    cfg_s = cfg_with(((0, n_parts, ovl),))
    fdc_s = FrequencyDomainChannelizer(cfg_s)
    g = fdc_s.segments[0].geometry
    cuts = [sd.core_bins[1] for sd in fdc_s.segments[:-1]]
    lo_bin = fdc_s.segments[0].core_bins[0]
    hi_bin = fdc_s.segments[-1].core_bins[1]

    carriers = []
    n_car = int(rng.integers(2, 5))
    for c in range(n_car):
        if cuts and rng.random() < 0.5:
            b = int(rng.choice(cuts)) + int(
                rng.integers(-g.decimation, g.decimation)
            )
        else:
            b = int(rng.integers(lo_bin + 8, hi_bin - 8))
        on = int(rng.integers(2, 30))
        off = on + int(rng.integers(4, 14))
        carriers.append(
            (b / cfg_u.blocksize, float(rng.uniform(1.5, 3.0)), on, off)
        )
    x = _capture(cfg_u, carriers, n_blocks=44, seed=seed + 100)
    su, ss = _sig(_events(cfg_u, x)), _sig(_events(cfg_s, x))
    assert su == ss


def test_split_checkpoint_resume(tmp_path):
    """Checkpoint/resume with a split segment and an OPEN carrier at a
    cut: resumed run == uninterrupted run (the split parts' slot states
    + cross-part duplicate bookkeeping all live in the standard carry /
    emitter state)."""
    from fdc_tpu.runtime.checkpoint import load_checkpoint, save_checkpoint

    cfg = _mk_cfg(splits=[(0, 4, 2)])
    fdc_a = FrequencyDomainChannelizer(cfg)
    cut = fdc_a.segments[0].core_bins[1]
    # burst spans the checkpoint cut (blocks 11-30; checkpoint mid-burst)
    x = _capture(cfg, [(cut / cfg.blocksize, 2.0, 11, 30)], n_blocks=48)

    def run(fdc, chunks):
        ev, n = [], 0
        for c in chunks:
            ev.extend(fdc.process(c).events)
        ev.extend(fdc.flush(finalize=True).events)
        return ev

    ref = run(FrequencyDomainChannelizer(cfg), [x])
    half = len(x) // 2 + 13

    fdc_b = FrequencyDomainChannelizer(cfg)
    ev1 = list(fdc_b.process(x[:half]).events)
    ckpt = str(tmp_path / "split.ckpt")
    save_checkpoint(fdc_b, ckpt)

    fdc_c = FrequencyDomainChannelizer(cfg)
    load_checkpoint(fdc_c, ckpt)
    ev2 = list(fdc_c.process(x[half:]).events)
    ev2.extend(fdc_c.flush(finalize=True).events)

    assert _sig(ref) == _sig(ev1 + ev2)
    assert len(_sig(ref)) >= 1


def _cfg_two_tier(splits):
    return ChannelizerConfig(
        blocksize=512, relinvovl=4,
        activity_detection_segments=[(0.1, 0.9)],
        act_det_threshold=8.0, minchandist=0.03,
        act_det_deactivation_delay=1, minchanflankpuffer=0.1,
        batch_blocks=8, max_slots=8,
        max_extract_width=128,
        extract_budget=2, extract_width_split=32,
        extract_budget_narrow=4,
        segment_splits=splits,
    )


def test_split_with_two_tier_extraction():
    """Splits compose with the two-tier narrow extraction bucket
    (extract_width_split — the cfg5-style pod configuration): split
    events equal unsplit events with both buckets live. The overlap
    margin (5 cells = 35 bins here) is sized to cover the 32-bin
    extraction widths of two carriers COMPETING across the cut — the
    documented margin rule covers acceptance interaction, not just a
    single carrier's own edges."""
    cfg_u, cfg_s = _cfg_two_tier(()), _cfg_two_tier(((0, 3, 5),))
    fdc_s = FrequencyDomainChannelizer(cfg_s)
    cut = fdc_s.segments[0].core_bins[1]
    lo1, hi1 = fdc_s.segments[1].core_bins
    x = _capture(
        cfg_u,
        [(cut / cfg_u.blocksize, 2.0, 9, 18),      # narrow, on the cut
         (((lo1 + hi1) // 2) / cfg_u.blocksize, 2.0, 14, 26)],
        n_blocks=40,
    )
    su, ss = _sig(_events(cfg_u, x)), _sig(_events(cfg_s, x))
    assert su == ss
    assert len(su) >= 2


def test_split_under_margin_deviation_is_bounded():
    """An UNDER-SIZED margin (2 cells < the 32-bin candidate widths of
    two carriers interacting across a cut) is the documented deviation
    regime: greedy-acceptance competition differs near the cut. The
    deviation must stay bounded — same carrier count, same frequencies,
    burst extents within one deactivation period — never a lost or
    duplicated carrier."""
    cfg_u, cfg_s = _cfg_two_tier(()), _cfg_two_tier(((0, 3, 2),))
    fdc_s = FrequencyDomainChannelizer(cfg_s)
    cut = fdc_s.segments[0].core_bins[1]
    lo1, hi1 = fdc_s.segments[1].core_bins
    x = _capture(
        cfg_u,
        [(cut / cfg_u.blocksize, 2.0, 9, 18),
         (((lo1 + hi1) // 2) / cfg_u.blocksize, 2.0, 14, 26)],
        n_blocks=40,
    )
    su, ss = _sig(_events(cfg_u, x)), _sig(_events(cfg_s, x))
    assert len(su) == len(ss)  # no lost, no duplicated carrier
    slack = cfg_u.act_det_deactivation_delay + 1
    for a, b in zip(su, ss):
        assert a[2] == b[2] and a[3] == b[3]  # same cfreq/bw
        assert abs(a[0] - b[0]) <= slack
        assert abs(a[1] - b[1]) <= slack


def test_two_split_segments_parity():
    """Multiple segment_splits entries at once (two bands each split in
    two): events equal the unsplit two-segment config."""
    def cfg_with(splits):
        return ChannelizerConfig(
            blocksize=512, relinvovl=4,
            activity_detection_segments=[(0.15, 0.45), (0.55, 0.85)],
            act_det_threshold=8.0, minchandist=0.03,
            act_det_deactivation_delay=1, minchanflankpuffer=0.1,
            batch_blocks=8, max_slots=8, segment_splits=splits,
        )

    cfg_u = cfg_with(())
    cfg_s = cfg_with(((0, 2, 2), (1, 2, 2)))
    fdc_s = FrequencyDomainChannelizer(cfg_s)
    assert len(fdc_s.segments) == 4
    # adjacency must NOT link parts of different parents
    assert fdc_s._split_neighbors == {
        0: (None, 1), 1: (0, None), 2: (None, 3), 3: (2, None),
    }
    cut0 = fdc_s.segments[0].core_bins[1]
    cut1 = fdc_s.segments[2].core_bins[1]
    x = _capture(
        cfg_u,
        [(cut0 / cfg_u.blocksize, 2.0, 6, 16),
         (cut1 / cfg_u.blocksize, 2.0, 12, 24)],
        n_blocks=40,
    )
    su, ss = _sig(_events(cfg_u, x)), _sig(_events(cfg_s, x))
    assert su == ss
    assert len(su) >= 2
