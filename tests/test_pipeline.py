"""Pipeline-parallel semantics: PipelineChannelizer == single-device.

The MPMD batch pipeline (parallel/pipeline.py) must reproduce the plain
channelizer exactly: stage A recomputes the reach-back spectrum row from
the host-fed sample tail (bit-identical to the carried prev_spec), stage
B runs the identical scans on identical powers, stage C the identical
slot extraction. Runs on the forced 8-device CPU mesh.
"""

import numpy as np
import pytest

import jax

from fdc_tpu.config import ChannelizerConfig
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer
from fdc_tpu.parallel.pipeline import PipelineChannelizer

from test_parallel import (
    assert_events_match,
    config,
    make_signal,
    run,
)


@pytest.mark.parametrize("n_devices", [1, 3, 8])
def test_pipeline_matches_single_device(n_devices):
    cfg = config()
    rng = np.random.default_rng(7)
    n_batches = 6
    x = make_signal(rng, n_batches * cfg.batch_blocks * cfg.inplen)

    ref = FrequencyDomainChannelizer(cfg)
    pipe = PipelineChannelizer(cfg, devices=jax.devices()[:n_devices])

    chunk = 2 * cfg.batch_blocks * cfg.inplen
    ev_ref, tp_ref, pw_ref = run(ref, x, chunk)
    ev_p, tp_p, pw_p = run(pipe, x, chunk)

    assert len(ev_ref) > 0, "test signal must trigger burst + detection"
    assert_events_match(ev_ref, ev_p)
    for a, b in zip(tp_ref, tp_p):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    for a, b in zip(pw_ref, pw_p):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=0)


def test_pipeline_chunking_invariance():
    """Ragged process() chunk sizes must not change the pipeline's
    outputs (host buffering + tail bookkeeping across calls)."""
    cfg = config()
    rng = np.random.default_rng(11)
    n_batches = 5
    x = make_signal(rng, n_batches * cfg.batch_blocks * cfg.inplen)

    a = PipelineChannelizer(cfg, devices=jax.devices())
    b = PipelineChannelizer(cfg, devices=jax.devices())

    ra = a.process(x)
    ra.events.extend(a.flush().events)
    ev_b, tp_b, _ = run(b, x, 3000)  # ragged chunks
    ev_b = list(ev_b) + b.flush().events

    ev_a = ra.events
    assert_events_match(ev_a, ev_b)
    for s_a, s_b in zip(ra.throughput, tp_b):
        np.testing.assert_allclose(s_a, s_b, rtol=2e-4, atol=2e-5)


def test_pipeline_flush_finalizes():
    """flush() on the pipeline finalizes open bursts like the plain path
    (the base flush drives the overridden process)."""
    cfg = config()
    rng = np.random.default_rng(3)
    n = 4 * cfg.batch_blocks * cfg.inplen
    t = np.arange(n)
    x = (
        2.5 * np.exp(2j * np.pi * (-0.4) * t)  # always-on detection carrier
        + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    ).astype(np.complex64)

    ref = FrequencyDomainChannelizer(cfg)
    pipe = PipelineChannelizer(cfg, devices=jax.devices())
    ev_ref = ref.process(x).events + ref.flush().events
    ev_p = pipe.process(x).events + pipe.flush().events
    assert any(e.finalized for e in ev_ref)
    assert_events_match(ev_ref, ev_p)


def test_pipeline_debug_spectrum():
    cfg = config(debug=True)
    rng = np.random.default_rng(5)
    x = make_signal(rng, 2 * cfg.batch_blocks * cfg.inplen)
    ref = FrequencyDomainChannelizer(cfg)
    pipe = PipelineChannelizer(cfg, devices=jax.devices()[:4])
    da = ref.process(x).debug_spectrum
    db = pipe.process(x).debug_spectrum
    assert da.shape == db.shape
    np.testing.assert_allclose(da, db, rtol=2e-4, atol=2e-5)


def test_pipeline_dedicated_owner_matches():
    """dedicated_owner=True (scan device does no extraction) must be
    output-identical — it only changes batch placement."""
    cfg = config()
    rng = np.random.default_rng(13)
    x = make_signal(rng, 4 * cfg.batch_blocks * cfg.inplen)
    ref = FrequencyDomainChannelizer(cfg)
    pipe = PipelineChannelizer(
        cfg, devices=jax.devices()[:4], dedicated_owner=True
    )
    assert len(pipe.workers) == 3 and pipe.owner not in pipe.workers
    ev_ref, tp_ref, _ = run(ref, x, 2 * cfg.batch_blocks * cfg.inplen)
    ev_p, tp_p, _ = run(pipe, x, 2 * cfg.batch_blocks * cfg.inplen)
    assert_events_match(ev_ref, ev_p)
    for a, b in zip(tp_ref, tp_p):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n_devices", [1, 3, 8])
def test_pipeline_process_spectra_matches(n_devices):
    """Vector mode pipelines too: batches farm over workers with the
    previous batch's last spectrum row prepended by the HOST (exact, no
    recompute). Ragged chunk sizes exercise the row buffering."""
    import dataclasses

    cfg = config()
    rng = np.random.default_rng(17)
    x = make_signal(rng, 5 * cfg.batch_blocks * cfg.inplen)
    dbg = FrequencyDomainChannelizer(dataclasses.replace(cfg, debug=True))
    spec = dbg.process(x).debug_spectrum  # [5*B, N]

    ref = FrequencyDomainChannelizer(cfg)
    r_ref = ref.process_spectra(spec)
    ev_ref = list(r_ref.events) + ref.flush().events

    pipe = PipelineChannelizer(cfg, devices=jax.devices()[:n_devices])
    ev_p, tp_p = [], [list() for _ in r_ref.throughput]
    rows = spec.shape[0]
    for lo, hi in ((0, 5), (5, 19), (19, rows)):  # ragged splits
        r = pipe.process_spectra(spec[lo:hi])
        ev_p.extend(r.events)
        for i, s in enumerate(r.throughput):
            tp_p[i].append(s)
    fp = pipe.flush()
    ev_p.extend(fp.events)
    for i, s in enumerate(fp.throughput):
        tp_p[i].append(s)

    assert len(ev_ref) > 0, "test signal must trigger burst + detection"
    assert_events_match(ev_ref, ev_p)
    for a, b in zip(r_ref.throughput, [np.concatenate(s) for s in tp_p]):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("save_kind,load_kind", [
    ("pipe", "plain"), ("plain", "pipe"), ("pipe", "pipe"),
])
def test_pipeline_spectra_checkpoint_cross_topology(
    save_kind, load_kind, tmp_path
):
    """Checkpoint/resume in VECTOR mode across pipeline <-> plain: the
    pipelined vector step never advances carry['prev_spec'] (the host
    holds the reach-back row), so saving must sync the host row into the
    carry — without it, a plain resume would see the spectrum of silence
    as its reach-back row."""
    import dataclasses

    from fdc_tpu.runtime.checkpoint import load_checkpoint, save_checkpoint

    cfg = config()
    rng = np.random.default_rng(23)
    x = make_signal(rng, 6 * cfg.batch_blocks * cfg.inplen)
    dbg = FrequencyDomainChannelizer(dataclasses.replace(cfg, debug=True))
    spec = dbg.process(x).debug_spectrum

    def make(kind):
        if kind == "pipe":
            return PipelineChannelizer(cfg, devices=jax.devices()[:3])
        return FrequencyDomainChannelizer(cfg)

    ref = FrequencyDomainChannelizer(cfg)
    r_full = ref.process_spectra(spec)
    ev_full = r_full.events + ref.flush().events
    assert len(ev_full) > 0

    half = 3 * cfg.batch_blocks
    a = make(save_kind)
    ra = a.process_spectra(spec[:half])
    ck = str(tmp_path / "pipe_spec.ckpt")
    save_checkpoint(a, ck)
    b = make(load_kind)
    load_checkpoint(b, ck)
    rb = b.process_spectra(spec[half:])
    resumed = ra.events + rb.events + b.flush().events

    assert_events_match(ev_full, resumed)
    for s_full, s_a, s_b in zip(
        r_full.throughput, ra.throughput, rb.throughput
    ):
        np.testing.assert_allclose(
            s_full, np.concatenate([s_a, s_b]), rtol=2e-4, atol=2e-5
        )


@pytest.mark.parametrize("save_kind,load_kind", [
    ("pipe", "pipe"), ("pipe", "plain"), ("plain", "pipe"),
])
def test_pipeline_checkpoint_cross_topology(save_kind, load_kind, tmp_path):
    """Checkpoint/resume across pipeline <-> plain: the pipeline's real
    framing state is the host tail; saving syncs it into the carry (so a
    plain model can resume), and a pipeline resuming a plain checkpoint
    substitutes the carried reach-back row for its first batch. Resumed
    runs must equal the uninterrupted run."""
    from fdc_tpu.runtime.checkpoint import load_checkpoint, save_checkpoint

    cfg = config()
    rng = np.random.default_rng(21)
    n_batches = 6
    x = make_signal(rng, n_batches * cfg.batch_blocks * cfg.inplen)

    def make(kind):
        if kind == "pipe":
            return PipelineChannelizer(cfg, devices=jax.devices()[:3])
        return FrequencyDomainChannelizer(cfg)

    ref = FrequencyDomainChannelizer(cfg)
    r_full = ref.process(x)
    ev_full = r_full.events + ref.flush().events

    half = 3 * make("plain").batch_samples
    a = make(save_kind)
    ra = a.process(x[:half])
    ck = str(tmp_path / "pipe.ckpt")
    save_checkpoint(a, ck)
    b = make(load_kind)
    load_checkpoint(b, ck)
    rb = b.process(x[half:])
    resumed = ra.events + rb.events + b.flush().events

    assert_events_match(ev_full, resumed)
    for s_full, s_a, s_b in zip(
        r_full.throughput, ra.throughput, rb.throughput
    ):
        np.testing.assert_allclose(
            s_full, np.concatenate([s_a, s_b]), rtol=2e-4, atol=2e-5
        )


# ---------------------------------------------------------------------------
# round 4: pipeline x SPMD composition + multi-owner scans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shard_time,n_devices,dedicated", [
    (2, 4, False),   # 2 groups of 2
    (4, 4, False),   # 1 group of 4
    (2, 5, True),    # dedicated owner + 2 groups of 2
])
def test_pipeline_composed_matches_single_device(shard_time, n_devices,
                                                 dedicated):
    """Pipeline x SPMD composition (each worker = a time-shard group):
    events/streams must equal the plain channelizer — stage A's per-shard
    reach-back recomputation and the canonical row merging are exact."""
    # b_local must stay a multiple of relinvovl (phase-fold contract)
    cfg = config(batch_blocks=4 * shard_time)
    rng = np.random.default_rng(7)
    n_batches = 6
    x = make_signal(rng, n_batches * cfg.batch_blocks * cfg.inplen)

    ref = FrequencyDomainChannelizer(cfg)
    pipe = PipelineChannelizer(
        cfg, devices=jax.devices()[:n_devices], shard_time=shard_time,
        dedicated_owner=dedicated,
    )
    assert len(pipe.group_meshes) >= 1

    chunk = 2 * cfg.batch_blocks * cfg.inplen
    ev_ref, tp_ref, pw_ref = run(ref, x, chunk)
    ev_p, tp_p, pw_p = run(pipe, x, chunk)

    assert len(ev_ref) > 0
    assert_events_match(ev_ref, ev_p)
    for a, b in zip(tp_ref, tp_p):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    for a, b in zip(pw_ref, pw_p):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=0)


def test_pipeline_composed_process_spectra_matches():
    """Vector mode through the composed pipeline: per-shard overlapping
    spectrum rows are exact (host-owned, no recompute)."""
    import dataclasses

    cfg = config()
    rng = np.random.default_rng(13)
    n_batches = 4
    x = make_signal(rng, n_batches * cfg.batch_blocks * cfg.inplen)

    ref = FrequencyDomainChannelizer(cfg)
    pipe = PipelineChannelizer(cfg, devices=jax.devices()[:4],
                               shard_time=2)

    # front-end the samples once, feed both vector modes
    import jax.numpy as jnp
    from fdc_tpu.ops.fft import forward_spectrum
    from fdc_tpu.ops.framing import frame_blocks

    @jax.jit
    def fe(xx):
        blocks, _ = frame_blocks(
            xx, jnp.zeros((cfg.ovllen,), jnp.complex64), cfg.blocksize
        )
        return forward_spectrum(blocks)

    spectra = np.asarray(fe(jnp.asarray(x)))
    ra = ref.process_spectra(spectra)
    rb = pipe.process_spectra(spectra)
    assert_events_match(ra.events, rb.events)
    for a, b in zip(ra.throughput, rb.throughput):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_pipeline_multi_owner_scans_match():
    """Multi-owner stage B (segment scans spread over owner devices) is
    event-identical to the single-owner pipeline and the plain path."""
    cfg = config(
        activity_detection_segments=[(-0.47, -0.3), (-0.28, -0.12),
                                     (0.03, 0.2)],
    )
    rng = np.random.default_rng(5)
    n_batches = 5
    n = n_batches * cfg.batch_blocks * cfg.inplen
    x = make_signal(rng, n)
    # extra carriers so every segment detects something
    t = np.arange(n)
    for f, lo, hi in [(-0.2, n // 5, n // 2), (0.1, n // 3, 4 * n // 5)]:
        m = np.zeros(n)
        m[lo:hi] = 1.0
        x = (x + 2.5 * m * np.exp(2j * np.pi * f * t)).astype(np.complex64)

    ref = FrequencyDomainChannelizer(cfg)
    pipe = PipelineChannelizer(cfg, devices=jax.devices(), scan_owners=3)
    assert len(pipe._owner_groups) == 3

    chunk = 2 * cfg.batch_blocks * cfg.inplen
    ev_ref, tp_ref, _ = run(ref, x, chunk)
    ev_p, tp_p, _ = run(pipe, x, chunk)
    assert sum(e.vectorstart is not None for e in ev_ref) > 2
    assert_events_match(ev_ref, ev_p)
    for a, b in zip(tp_ref, tp_p):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_pipeline_composed_multi_owner_checkpoint(tmp_path):
    """Composition + multi-owner + checkpoint mid-stream: resume into a
    PLAIN channelizer reproduces the uninterrupted event stream."""
    from fdc_tpu.runtime.checkpoint import load_checkpoint, save_checkpoint

    cfg = config(
        activity_detection_segments=[(-0.47, -0.3), (0.03, 0.2)],
    )
    rng = np.random.default_rng(23)
    n_batches = 6
    n = n_batches * cfg.batch_blocks * cfg.inplen
    x = make_signal(rng, n)
    half = n // 2 + 3 * cfg.inplen

    ref = FrequencyDomainChannelizer(cfg)
    ev_ref, _, _ = run(ref, x, len(x))

    a = PipelineChannelizer(cfg, devices=jax.devices(), shard_time=2,
                            scan_owners=2)
    ev1 = a.process(x[:half]).events
    ck = str(tmp_path / "comp.ckpt")
    save_checkpoint(a, ck)
    b = FrequencyDomainChannelizer(cfg)
    load_checkpoint(b, ck)
    ev2 = b.process(x[half:]).events

    assert len(ev_ref) == len(ev1) + len(ev2)
    assert_events_match(ev_ref, ev1 + ev2)
