"""Native C++ emission engine == pure-Python emitters, end to end."""

import numpy as np
import pytest

from fdc_tpu.config import ChannelizerConfig
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer
from fdc_tpu.runtime import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def config(**kw):
    base = dict(
        blocksize=256,
        relinvovl=4,
        throughput_channels=[(-0.25, 0.04)],
        activity_controlled_channels=[(0.3, 0.05), (0.1, 0.04)],
        activity_detection_segments=[(-0.47, -0.3)],
        act_contr_threshold=10.0,
        act_det_threshold=8.0,
        minchandist=0.02,
        freqmode="basebandfs",
        batch_blocks=8,
        max_slots=8,
        max_candidates=8,
        pow_act_maxblocks=6,   # force partial emissions
        act_det_maxblocks=5,
    )
    base.update(kw)
    return ChannelizerConfig(**base)


def make_signal(n):
    t = np.arange(n)
    rng = np.random.default_rng(3)
    x = (0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(
        np.complex64
    )
    # two bursts on channel 0; one on channel 1; one detection carrier
    for lo, hi, f in (
        (n // 8, n // 3, 0.3),
        (n // 2, 3 * n // 4, 0.3),
        (n // 4, 2 * n // 3, 0.1),
        (n // 3, n // 2, -0.4),
    ):
        m = np.zeros(n)
        m[lo:hi] = 1.0
        x += (2.0 * m * np.exp(2j * np.pi * f * t)).astype(np.complex64)
    return x


def run(fdc, x, chunk):
    events = []
    for lo in range(0, len(x), chunk):
        events.extend(fdc.process(x[lo: lo + chunk]).events)
    return events


def test_native_emission_matches_python():
    cfg_py = config(native_emission=False)
    cfg_nat = config(native_emission=True)
    n = 16 * cfg_py.batch_blocks * (cfg_py.blocksize - cfg_py.ovllen)
    x = make_signal(n)

    ev_py = run(FrequencyDomainChannelizer(cfg_py), x, n // 4)
    ev_nat = run(FrequencyDomainChannelizer(cfg_nat), x, n // 4)

    assert len(ev_py) > 4, "need bursts, partials, and detections"
    assert any(not e.finalized for e in ev_py), "need partial emissions"
    assert len(ev_py) == len(ev_nat)
    for a, b in zip(ev_py, ev_nat):
        assert a.ID.split(".", 1)[1] == b.ID.split(".", 1)[1], (a.ID, b.ID)
        assert a.finalized == b.finalized
        assert a.part == b.part
        assert a.blockstart == b.blockstart
        assert a.blockend == b.blockend
        assert a.rel_cfreq == pytest.approx(b.rel_cfreq)
        assert a.rel_bw == pytest.approx(b.rel_bw)
        assert a.vectorstart == b.vectorstart
        assert a.vectorend == b.vectorend
        assert a.data.shape == b.data.shape
        np.testing.assert_allclose(a.data, b.data, rtol=1e-5, atol=1e-7)


def test_native_emission_file_output(tmp_path):
    cfg = config(native_emission=True, fileoutput=True, msgoutput=True,
                 outputpath=str(tmp_path))
    n = 8 * cfg.batch_blocks * cfg.inplen
    x = make_signal(n)
    events = run(FrequencyDomainChannelizer(cfg), x, n)
    fin = [e for e in events if e.finalized]
    assert fin
    files = list(tmp_path.iterdir())
    assert files, "file sink must write burst files"
    # finalized burst files hold the event data verbatim
    for e in fin:
        base = e.ID.rsplit(".", 1)[0] if e.ID.endswith((".fin", ".part")) \
            else e.ID
        matches = [f for f in files if f.name == f"{base}.fin"]
        if matches:
            data = np.fromfile(matches[0], np.complex64)
            np.testing.assert_allclose(data, e.data, rtol=1e-6)


def test_native_checkpoint_roundtrip(tmp_path):
    from fdc_tpu.runtime.checkpoint import load_checkpoint, save_checkpoint

    cfg = config(native_emission=True)
    n = 16 * cfg.batch_blocks * cfg.inplen
    x = make_signal(n)
    half = n // 2 + 17

    ev_ref = run(FrequencyDomainChannelizer(cfg), x, len(x))

    a = FrequencyDomainChannelizer(cfg)
    ev1 = run(a, x[:half], len(x))
    ck = str(tmp_path / "s.ckpt")
    save_checkpoint(a, ck)
    b = FrequencyDomainChannelizer(cfg)
    load_checkpoint(b, ck)
    ev2 = run(b, x[half:], len(x))

    assert len(ev_ref) == len(ev1) + len(ev2)
    for p, q in zip(ev_ref, ev1 + ev2):
        assert p.ID.split(".", 1)[1] == q.ID.split(".", 1)[1]
        assert p.blockstart == q.blockstart
        assert p.blockend == q.blockend
        np.testing.assert_allclose(p.data, q.data, rtol=1e-5, atol=1e-7)


def test_native_emission_scale_stress():
    """256 slots x 64 blocks of churn: native == Python, event for event."""
    from fdc_tpu.models.segment_detection import SegmentDetector
    from fdc_tpu.runtime.emission import (
        NativeSegmentDetectionEmitter,
        SegmentDetectionEmitter,
    )

    S, B, l_cap = 256, 64, 256
    rng = np.random.default_rng(0)
    det = SegmentDetector(
        0, 1024, 4, 0.05, 0.95, 6.0, 0.002, 0.2,
        max_slots=S, max_candidates=32, max_extract_width=l_cap,
        lifecycle_backend="scan",
    )
    state = {
        "ext_start": rng.integers(0, 700, S).astype(np.int32),
        "wlog2": rng.integers(3, 8, S).astype(np.int32),
        "order": np.arange(S, dtype=np.int32),
        "active": np.ones(S, bool),
        "tomb": np.zeros(S, bool),
    }
    activated = np.zeros((S, B), bool)
    processed = np.zeros((S, B), bool)
    emit = np.zeros((S, B), bool)
    phase_used = rng.integers(0, 4, (S, B)).astype(np.int32)
    for s in range(S):
        on = int(rng.integers(0, B // 2))
        off = on + int(rng.integers(2, B // 2))
        activated[s, on] = True
        processed[s, on + 1: off] = True
        if off < B:
            emit[s, off] = True
    extract = (
        rng.standard_normal((S, B + 1, l_cap))
        + 1j * rng.standard_normal((S, B + 1, l_cap))
    ).astype(np.complex64)
    outputs = {
        "activated": activated, "processed": processed, "emit": emit,
        "phase_used": phase_used, "extract": extract,
    }

    ev_py = SegmentDetectionEmitter(det, 8).process_step(
        outputs, dict(state), 0
    )
    ev_nat = NativeSegmentDetectionEmitter(det, 8).process_step(
        outputs, dict(state), 0
    )
    assert len(ev_py) == len(ev_nat) > 400
    for a, b in zip(ev_py, ev_nat):
        assert a.ID.split(".", 1)[1] == b.ID.split(".", 1)[1]
        assert a.blockstart == b.blockstart and a.blockend == b.blockend
        assert a.part == b.part and a.finalized == b.finalized
        np.testing.assert_allclose(a.data, b.data, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("vcm", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 7])
def test_native_emission_multistep_fuzz(seed, vcm):
    """Differential fuzz across STEPS: bursts spanning step boundaries,
    budget-compacted rows (slot_ids with sentinels), a narrow second
    bucket, rows beyond both budgets (zeroed + lost counter), and a tiny
    maxblocks forcing partial emission — native must equal Python event
    for event with state carried across process_step calls."""
    from fdc_tpu.models.segment_detection import SegmentDetector
    from fdc_tpu.runtime.emission import (
        NativeSegmentDetectionEmitter,
        SegmentDetectionEmitter,
    )

    S, B, steps = 24, 16, 5
    w_cap, w_split = 128, 16
    e_wide, e_narrow = 6, 4
    rng = np.random.default_rng(seed)
    det = SegmentDetector(
        0, 1024, 4, 0.05, 0.95, 6.0, 0.002, 0.2,
        max_slots=S, max_candidates=8, max_extract_width=w_cap,
        lifecycle_backend="scan", vcm=vcm,
        extract_budget=e_wide, extract_width_split=w_split,
        extract_budget_narrow=e_narrow,
    )
    total = steps * B
    # one burst per slot, spans crossing step boundaries
    act = rng.integers(0, total - 4, S)
    length = rng.integers(2, total // 2, S)
    wlog2 = rng.integers(3, 8, S).astype(np.int32)  # widths 8..128
    meta = {
        "ext_start": rng.integers(0, 800, S).astype(np.int32),
        "wlog2": wlog2,
        "order": np.arange(S, dtype=np.int32),
    }
    em_py = SegmentDetectionEmitter(det, 5)
    em_nat = NativeSegmentDetectionEmitter(det, 5)
    ev_py, ev_nat = [], []
    split_log2 = int(np.log2(w_split))
    for step in range(steps):
        lo = step * B
        activated = np.zeros((S, B), bool)
        processed = np.zeros((S, B), bool)
        emit = np.zeros((S, B), bool)
        for s in range(S):
            a, e = act[s], act[s] + length[s]
            for b in range(B):
                g = lo + b
                if g == a:
                    activated[s, b] = True
                elif a < g < e:
                    processed[s, b] = True
                elif g == e:
                    emit[s, b] = True
        phase_used = rng.integers(0, 4, (S, B)).astype(np.int32)
        touched = activated.any(1) | processed.any(1) | emit.any(1)
        narrow_pool = np.flatnonzero(touched & (wlog2 <= split_log2))
        wide_pool = np.flatnonzero(touched & (wlog2 > split_log2))
        ids_n = np.full(e_narrow, S, np.int32)
        ids_n[: min(e_narrow, len(narrow_pool))] = narrow_pool[:e_narrow]
        # narrow overflow spills into the wide list (device plan rule)
        spill = narrow_pool[e_narrow:]
        wide_all = np.concatenate([wide_pool, spill])
        ids_w = np.full(e_wide, S, np.int32)
        ids_w[: min(e_wide, len(wide_all))] = wide_all[:e_wide]
        extract = (
            rng.standard_normal((e_wide, B + 1, w_cap))
            + 1j * rng.standard_normal((e_wide, B + 1, w_cap))
        ).astype(np.complex64)
        extract_n = (
            rng.standard_normal((e_narrow, B + 1, w_split))
            + 1j * rng.standard_normal((e_narrow, B + 1, w_split))
        ).astype(np.complex64)
        outputs = {
            "activated": activated, "processed": processed, "emit": emit,
            "phase_used": phase_used, "extract": extract,
            "slot_ids": ids_w, "extract_narrow": extract_n,
            "slot_ids_narrow": ids_n,
            "ext_overflow": np.int32(max(0, len(wide_all) - e_wide)),
        }
        ev_py.extend(em_py.process_step(dict(outputs), dict(meta), lo))
        ev_nat.extend(em_nat.process_step(dict(outputs), dict(meta), lo))

    assert len(ev_py) == len(ev_nat) > 0
    for a, b in zip(ev_py, ev_nat):
        assert a.ID.split(".", 1)[1] == b.ID.split(".", 1)[1]
        assert a.blockstart == b.blockstart and a.blockend == b.blockend
        assert a.part == b.part and a.finalized == b.finalized
        assert a.vectorstart == b.vectorstart
        assert a.rel_bw == pytest.approx(b.rel_bw)
        assert a.data.shape == b.data.shape
        np.testing.assert_allclose(a.data, b.data, rtol=1e-5, atol=1e-6)
    assert em_py.lost_rows == em_nat.lost_rows
    assert em_py.overflow_slots == em_nat.overflow_slots


@pytest.mark.parametrize("save_native,load_native", [(True, False),
                                                     (False, True)])
def test_checkpoint_cross_emitter_backend(tmp_path, save_native,
                                          load_native):
    """A checkpoint written with one emitter backend restores into the
    OTHER, with post-resume events identical to the uninterrupted run
    : the native engines' get_state/set_state speak
    the Python emitters' structured schema."""
    from fdc_tpu.runtime.checkpoint import load_checkpoint, save_checkpoint

    cfg_save = config(native_emission=save_native)
    cfg_load = config(native_emission=load_native)
    n = 16 * cfg_save.batch_blocks * cfg_save.inplen
    x = make_signal(n)
    half = n // 2 + 17  # split mid-burst so open buffers cross backends

    ev_ref = run(FrequencyDomainChannelizer(cfg_save), x, len(x))

    a = FrequencyDomainChannelizer(cfg_save)
    ev1 = run(a, x[:half], len(x))
    ck = str(tmp_path / "cross.ckpt")
    save_checkpoint(a, ck)
    b = FrequencyDomainChannelizer(cfg_load)
    load_checkpoint(b, ck)
    ev2 = run(b, x[half:], len(x))

    assert len(ev_ref) == len(ev1) + len(ev2)
    assert any(not e.finalized for e in ev_ref), "need open-burst partials"
    for p, q in zip(ev_ref, ev1 + ev2):
        assert p.ID.split(".", 1)[1] == q.ID.split(".", 1)[1]
        assert p.finalized == q.finalized
        assert p.part == q.part
        assert p.blockstart == q.blockstart
        assert p.blockend == q.blockend
        assert p.data.shape == q.data.shape
        np.testing.assert_allclose(p.data, q.data, rtol=1e-5, atol=1e-7)


def test_native_state_blob_schema_roundtrip():
    """The structured schema is a faithful image of the engine blob:
    blob -> schema -> blob is byte-identical mid-burst."""
    from fdc_tpu.runtime.emission import (
        _build_native_blob,
        _parse_native_blob,
    )

    cfg = config(native_emission=True)
    fdc = FrequencyDomainChannelizer(cfg)
    n = 4 * cfg.batch_blocks * cfg.inplen
    run(fdc, make_signal(n)[: n // 2 + 31], len(x := np.zeros(1)))
    for em in [fdc.power_emitter] + fdc.segment_emitters:
        blob = em.engine.save_state()
        n_units = (
            em.bank.num_channels if hasattr(em, "bank")
            else em.det.max_slots
        )
        assert _build_native_blob(_parse_native_blob(blob, n_units)) == blob
