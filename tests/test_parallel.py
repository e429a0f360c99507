"""Multi-device semantics: ShardedChannelizer == FrequencyDomainChannelizer.

Runs the full three-mode system on a forced 8-device CPU mesh and checks the
sharded step reproduces the single-device outputs exactly (same fp32 op
order modulo collective layout — tolerances are tight): throughput streams,
burst/detection events (including bursts spanning time-shard boundaries),
and segment power observability.
"""

import numpy as np
import pytest

from fdc_tpu.config import ChannelizerConfig
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer
from fdc_tpu.parallel.mesh import make_mesh
from fdc_tpu.parallel.sharded import ShardedChannelizer


def make_signal(rng, n_samples):
    """Wideband test capture: 2 always-on tones, 1 long burst crossing batch
    and shard boundaries, 1 short burst, plus noise floor."""
    t = np.arange(n_samples)
    x = np.zeros(n_samples, np.complex64)
    # throughput carriers at FDC 0.25 and 0.625 (baseband -0.25, +0.125)
    x += 1.0 * np.exp(2j * np.pi * (-0.25) * t)
    x += 0.8 * np.exp(2j * np.pi * 0.125 * t)
    # burst carrier at baseband +0.3 (FDC 0.8), on in the middle
    burst = np.zeros(n_samples)
    burst[n_samples // 4: (3 * n_samples) // 4] = 1.0
    x += (2.0 * burst) * np.exp(2j * np.pi * 0.3 * t)
    # detection-segment carrier at baseband -0.4 (FDC 0.1)
    det = np.zeros(n_samples)
    det[n_samples // 3: n_samples // 2] = 1.0
    x += (2.5 * det) * np.exp(2j * np.pi * (-0.4) * t)
    x += (
        0.01
        * (rng.standard_normal(n_samples) + 1j * rng.standard_normal(n_samples))
    ).astype(np.complex64)
    return x.astype(np.complex64)


def config(**kw):
    base = dict(
        blocksize=256,
        relinvovl=4,
        throughput_channels=[(-0.25, 0.04), (0.125, 0.08)],
        activity_controlled_channels=[(0.3, 0.05)],
        activity_detection_segments=[(-0.47, -0.3)],
        act_contr_threshold=10.0,
        act_det_threshold=8.0,
        minchandist=0.02,
        freqmode="basebandfs",
        fs=1.0,
        batch_blocks=8,
        max_slots=8,
        max_candidates=8,
    )
    base.update(kw)
    return ChannelizerConfig(**base)


def run(model, x, chunk):
    events, streams, segpow = [], None, None
    for lo in range(0, len(x), chunk):
        r = model.process(x[lo: lo + chunk])
        events.extend(r.events)
        if streams is None:
            streams = [list() for _ in r.throughput]
            segpow = [list() for _ in r.segment_power]
        for i, s in enumerate(r.throughput):
            streams[i].append(s)
        for i, p in enumerate(r.segment_power):
            segpow[i].append(p)
    return (
        events,
        [np.concatenate(s) for s in streams],
        [np.concatenate(p) for p in segpow],
    )


def assert_events_match(ev_a, ev_b):
    assert len(ev_a) == len(ev_b)
    for a, b in zip(ev_a, ev_b):
        # IDs carry a wall-clock timestamp; compare the stable tail
        assert a.ID.split(".", 1)[1] == b.ID.split(".", 1)[1]
        assert a.finalized == b.finalized
        assert a.part == b.part
        assert a.blockstart == b.blockstart
        assert a.blockend == b.blockend
        assert a.rel_cfreq == pytest.approx(b.rel_cfreq)
        assert a.rel_bw == pytest.approx(b.rel_bw)
        assert a.vectorstart == b.vectorstart
        assert a.vectorend == b.vectorend
        assert a.data.shape == b.data.shape
        np.testing.assert_allclose(a.data, b.data, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize(
    "n_time,n_chan",
    # (1, 1) pins the degenerate-axis short circuits (skipped psum /
    # all_gather / chan slice) to the single-device outputs
    [(4, 2), (8, 1), (1, 2), (2, 2), (1, 1)],
)
def test_sharded_matches_single_device(n_time, n_chan):
    cfg = config()
    rng = np.random.default_rng(7)
    n_batches = 6
    x = make_signal(rng, n_batches * cfg.batch_blocks * cfg.inplen)

    ref = FrequencyDomainChannelizer(cfg)
    mesh = make_mesh(n_time=n_time, n_chan=n_chan)
    sh = ShardedChannelizer(cfg, mesh=mesh)

    chunk = 2 * cfg.batch_blocks * cfg.inplen  # 2 batches per process() call
    ev_ref, tp_ref, pw_ref = run(ref, x, chunk)
    ev_sh, tp_sh, pw_sh = run(sh, x, chunk)

    assert len(ev_ref) > 0, "test signal must trigger burst + detection events"
    assert any(e.vectorstart is not None for e in ev_ref), "need detection events"
    assert_events_match(ev_ref, ev_sh)

    for a, b in zip(tp_ref, tp_sh):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    for a, b in zip(pw_ref, pw_sh):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=0)


@pytest.mark.parametrize("n_time,n_chan", [(4, 2), (8, 1), (1, 2)])
def test_sharded_process_spectra_matches_single(n_time, n_chan):
    """process_spectra on a ShardedChannelizer runs the SHARDED step
    (spectrum rows time-sharded, prev-spec ppermute, chan-sharded
    extraction): results must equal the plain
    channelizer's vector mode within the standard sharded tolerances."""
    import dataclasses

    cfg = config()
    rng = np.random.default_rng(11)
    x = make_signal(rng, 2 * cfg.batch_blocks * cfg.inplen)
    dbg = FrequencyDomainChannelizer(dataclasses.replace(cfg, debug=True))
    spec = dbg.process(x).debug_spectrum

    r_ref = FrequencyDomainChannelizer(cfg).process_spectra(spec)
    sh = ShardedChannelizer(cfg, mesh=make_mesh(n_time=n_time,
                                                n_chan=n_chan))
    r_sh = sh.process_spectra(spec)

    assert len(r_ref.events) > 0
    assert_events_match(r_ref.events, r_sh.events)
    for a, b in zip(r_ref.throughput, r_sh.throughput):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    for a, b in zip(r_ref.segment_power, r_sh.segment_power):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=0)


def test_process_spectra_ragged_batches_buffered():
    """Vector mode consumes ANY number of spectrum rows (the reference
    consumes any number of input vectors); remainders buffer across
    calls and flush() pads + trims the tail."""
    import dataclasses

    cfg = config()
    rng = np.random.default_rng(13)
    x = make_signal(rng, 3 * cfg.batch_blocks * cfg.inplen)
    dbg = FrequencyDomainChannelizer(dataclasses.replace(cfg, debug=True))
    spec = dbg.process(x).debug_spectrum  # [24, N]

    one = FrequencyDomainChannelizer(cfg)
    r_one = one.process_spectra(spec)
    ev_one = list(r_one.events) + one.flush().events

    ragged = FrequencyDomainChannelizer(cfg)
    ev_r, tp_r = [], None
    for lo, hi in ((0, 3), (3, 10), (10, 11), (11, 24)):  # ragged splits
        r = ragged.process_spectra(spec[lo:hi])
        ev_r.extend(r.events)
        tp_r = (
            [list() for _ in r.throughput] if tp_r is None else tp_r
        )
        for i, s in enumerate(r.throughput):
            tp_r[i].append(s)
    fr = ragged.flush()
    ev_r.extend(fr.events)
    for i, s in enumerate(fr.throughput):
        tp_r[i].append(s)

    assert len(ev_one) > 0
    assert_events_match(ev_one, ev_r)
    for a, b in zip(r_one.throughput, [np.concatenate(s) for s in tp_r]):
        np.testing.assert_array_equal(a, b)

    # a tail that does not fill a batch: flush pads with silence rows
    # and trims back to the real rows
    tail = FrequencyDomainChannelizer(cfg)
    r1 = tail.process_spectra(spec[:11])
    assert r1.blocks_processed == 8  # one whole batch, 3 rows buffered
    rf = tail.flush()
    assert rf.blocks_processed == 3
    for bucket in tail.throughput.buckets:
        for chan in bucket.channel_ids:
            assert len(rf.throughput[chan]) == 3 * bucket.out_len


def test_sharded_matches_single_device_with_extract_budget():
    """Compacted extraction (each chan rank extracts its slice of the
    replicated plan) must keep sharded == single-device bit-level parity."""
    cfg = config(max_slots=8, extract_budget=4)
    rng = np.random.default_rng(7)
    x = make_signal(rng, 6 * cfg.batch_blocks * cfg.inplen)

    ref = FrequencyDomainChannelizer(cfg)
    sh = ShardedChannelizer(cfg, mesh=make_mesh(n_time=4, n_chan=2))

    chunk = 2 * cfg.batch_blocks * cfg.inplen
    ev_ref, tp_ref, _ = run(ref, x, chunk)
    ev_sh, tp_sh, _ = run(sh, x, chunk)

    assert any(e.vectorstart is not None for e in ev_ref)
    assert ref.segment_emitters[0].lost_rows == 0
    assert sh.segment_emitters[0].lost_rows == 0
    assert_events_match(ev_ref, ev_sh)
    for a, b in zip(tp_ref, tp_sh):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_sharded_matches_single_device_with_split_bucket():
    """Two-tier extraction sharded: each chan rank slices BOTH replicated
    plans; parity with the single-device split path."""
    cfg = config(max_slots=8, extract_budget=2, extract_width_split=64,
                 extract_budget_narrow=4, max_extract_width=256)
    rng = np.random.default_rng(7)
    x = make_signal(rng, 6 * cfg.batch_blocks * cfg.inplen)

    ref = FrequencyDomainChannelizer(cfg)
    sh = ShardedChannelizer(cfg, mesh=make_mesh(n_time=2, n_chan=2))

    chunk = 2 * cfg.batch_blocks * cfg.inplen
    ev_ref, tp_ref, _ = run(ref, x, chunk)
    ev_sh, tp_sh, _ = run(sh, x, chunk)

    assert any(e.vectorstart is not None for e in ev_ref)
    assert_events_match(ev_ref, ev_sh)
    for a, b in zip(tp_ref, tp_sh):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n_time,n_chan", [(2, 2), (1, 4), (4, 2)])
def test_multi_segment_scans_sharded_over_chan(n_time, n_chan):
    """Multi-segment configs assign each segment's lifecycle scan to chan
    rank (i % n_chan) and broadcast the flags/state;
    events and streams must stay identical to single-device. Three
    segments on 2/4 chan ranks exercises both the uneven assignment and
    the owner != 0 broadcast."""
    cfg = config(
        activity_detection_segments=[(-0.47, -0.3), (-0.25, -0.05),
                                     (0.15, 0.35)],
        throughput_channels=[(-0.25, 0.04)],
        activity_controlled_channels=[],
    )
    rng = np.random.default_rng(19)
    n = 6 * cfg.batch_blocks * cfg.inplen
    t = np.arange(n)
    x = (0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(
        np.complex64
    )
    # one burst per segment, staggered spans (some crossing batch bounds)
    for lo, hi, f in ((n // 5, n // 2, -0.4), (n // 3, 2 * n // 3, -0.15),
                      (n // 2, 4 * n // 5, 0.25)):
        m = np.zeros(n)
        m[lo:hi] = 1.0
        x += (2.5 * m * np.exp(2j * np.pi * f * t)).astype(np.complex64)

    ref = FrequencyDomainChannelizer(cfg)
    sh = ShardedChannelizer(
        cfg, mesh=make_mesh(n_time=n_time, n_chan=n_chan)
    )
    chunk = 2 * cfg.batch_blocks * cfg.inplen
    ev_ref, tp_ref, pw_ref = run(ref, x, chunk)
    ev_sh, tp_sh, pw_sh = run(sh, x, chunk)

    segs = {e.ID.split(".")[-2] for e in ev_ref if "DETECTED" in e.ID}
    assert len(segs) == 3, "every segment must emit events"
    assert_events_match(ev_ref, ev_sh)
    for a, b in zip(tp_ref, tp_sh):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    for a, b in zip(pw_ref, pw_sh):
        # atol floors the noise-floor cells (~1e-6): different FFT batch
        # shapes round differently at n_time=4
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-9)


def test_chan_sharded_tables_stay_static(monkeypatch):
    """Every chan rank's extraction branch must receive STATIC numpy
    starts/windows (the trace-time precondition for folding the windows
    into the DFT matrices): this test pins that the chan-sharded call
    sites keep satisfying it."""
    import fdc_tpu.ops.extract as ex
    import fdc_tpu.parallel.sharded as sh_mod

    seen = []
    real_bucket = ex.extract_bucket
    real_phased = ex.extract_bucket_phased

    def spy_bucket(spectrum, starts, base_windows, **kw):
        seen.append(
            isinstance(starts, np.ndarray)
            and isinstance(base_windows, np.ndarray)
        )
        return real_bucket(spectrum, starts, base_windows, **kw)

    def spy_phased(spectrum, starts, base_windows, relinvovl, **kw):
        seen.append(
            isinstance(starts, np.ndarray)
            and isinstance(base_windows, np.ndarray)
        )
        return real_phased(spectrum, starts, base_windows, relinvovl, **kw)

    monkeypatch.setattr(sh_mod, "extract_bucket", spy_bucket)
    monkeypatch.setattr(sh_mod, "extract_bucket_phased", spy_phased)

    cfg = config()
    sh = ShardedChannelizer(cfg, mesh=make_mesh(n_time=2, n_chan=2))
    rng = np.random.default_rng(3)
    sh.process(make_signal(rng, cfg.batch_blocks * cfg.inplen))

    # 2 chan ranks x (1 tp bucket + 1 pa bucket) at least; all static
    assert len(seen) >= 4
    assert all(seen), "chan-rank extraction must see static numpy tables"


def test_sharded_4x4_sixteen_devices():
    """16-virtual-device 4x4 mesh: the suite's
    conftest pins 8 CPU devices, so this runs in a subprocess with 16.
    Full three-mode config, sharded == single events + streams."""
    import os
    import subprocess
    import sys
    import textwrap

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    script = textwrap.dedent(
        """
        import numpy as np
        import sys
        sys.path.insert(0, %r)
        from test_parallel import assert_events_match, config, make_signal, run
        from fdc_tpu.models.channelizer import FrequencyDomainChannelizer
        from fdc_tpu.parallel.mesh import make_mesh
        from fdc_tpu.parallel.sharded import ShardedChannelizer

        cfg = config(
            activity_detection_segments=[(-0.47, -0.3), (-0.25, -0.05)],
        )
        rng = np.random.default_rng(7)
        x = make_signal(rng, 4 * cfg.batch_blocks * cfg.inplen)
        ref = FrequencyDomainChannelizer(cfg)
        sh = ShardedChannelizer(cfg, mesh=make_mesh(n_time=4, n_chan=4))
        chunk = 2 * cfg.batch_blocks * cfg.inplen
        ev_ref, tp_ref, _ = run(ref, x, chunk)
        ev_sh, tp_sh, _ = run(sh, x, chunk)
        assert len(ev_ref) > 0
        assert_events_match(ev_ref, ev_sh)
        for a, b in zip(tp_ref, tp_sh):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
        print("4x4 OK", len(ev_ref))
        """
        % os.path.dirname(os.path.abspath(__file__))
    )
    r = subprocess.run(
        [sys.executable, "-c", script], env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "4x4 OK" in r.stdout


def test_slot_rounding_and_batch_divisibility():
    mesh = make_mesh(n_time=2, n_chan=4)
    sh = ShardedChannelizer(config(max_slots=6), mesh=mesh)
    assert sh.config.max_slots == 8  # rounded up to n_chan multiple
    with pytest.raises(ValueError):
        ShardedChannelizer(config(batch_blocks=9), mesh=mesh)


def test_multihost_helpers_single_process():
    """Single-process path of the multi-host helpers (pod path needs real
    multi-process; the sharding/feeding logic is identical)."""
    import jax
    import numpy as np
    from fdc_tpu.parallel.multihost import (
        global_mesh,
        host_local_batch,
        initialize_multihost,
    )

    assert initialize_multihost() == 0
    mesh = global_mesh(n_chan=2)
    assert mesh.shape == {"time": 4, "chan": 2}

    cfg = config(batch_blocks=8)
    sh = ShardedChannelizer(cfg, mesh=mesh)
    xf = np.zeros((cfg.batch_blocks * cfg.inplen, 2), np.float32)
    arr = host_local_batch(mesh, xf)
    assert arr.shape == xf.shape
    # feeds straight into the sharded step
    carry = sh._jit_init()
    carry2, out = sh._jit_step(carry, arr, 0)
    jax.block_until_ready(out)


@pytest.mark.parametrize("n_time,n_chan", [(1, 2), (2, 2)])
def test_chan_sharded_fused_measures(n_time, n_chan):
    """Multi-chan ranks measure the detection powers on their own time
    rows while each rank extracts only its channel rows (matmul-DFT
    extraction with the windows folded per rank): the sharded step must
    produce the same events/streams/powers as the plain channelizer."""
    cfg = config(
        use_mxu_fft=True,
        # equal-bandwidth tp channels -> equal-window bucket on every
        # rank; widths differ from the burst channel's so the tp bucket
        # stays unfused
        throughput_channels=[(-0.25, 0.08), (0.125, 0.08)],
    )
    rng = np.random.default_rng(7)
    n_batches = 4
    x = make_signal(rng, n_batches * cfg.batch_blocks * cfg.inplen)

    ref = FrequencyDomainChannelizer(cfg)
    mesh = make_mesh(n_time=n_time, n_chan=n_chan)
    sh = ShardedChannelizer(cfg, mesh=mesh)

    chunk = 2 * cfg.batch_blocks * cfg.inplen
    ev_ref, tp_ref, pw_ref = run(ref, x, chunk)
    ev_sh, tp_sh, pw_sh = run(sh, x, chunk)

    assert len(ev_ref) > 0
    assert_events_match(ev_ref, ev_sh)
    for a, b in zip(tp_ref, tp_sh):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    for a, b in zip(pw_ref, pw_sh):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=0)
