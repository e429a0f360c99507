"""Lifecycle and burst kernels (interpret mode) == lax.scan reference."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fdc_tpu.models.segment_detection import SegmentDetector


def make_detector(backend, max_slots=16, max_candidates=8):
    return SegmentDetector(
        0, 1024, 4, 0.1, 0.6, 6.0, 0.02, 0.2,
        channel_deactivation_delay=1,
        max_slots=max_slots,
        max_candidates=max_candidates,
        max_extract_width=256,
        lifecycle_backend=backend,
    )


def random_state(sd, rng, occupancy=0.3):
    s = sd.max_slots
    active = rng.random(s) < occupancy
    wlog2 = rng.integers(2, sd.w_cap_log2 + 1, s)
    ext_start = rng.integers(sd.geometry.start, sd.geometry.stop - 256, s)
    det_start = ext_start + 5
    det_stop = det_start + rng.integers(5, 50, s)
    return {
        "active": jnp.asarray(active),
        "tomb": jnp.zeros((s,), bool),
        "det_start": jnp.asarray(det_start, jnp.int32),
        "det_stop": jnp.asarray(det_stop, jnp.int32),
        "ext_start": jnp.asarray(ext_start, jnp.int32),
        "wlog2": jnp.asarray(wlog2, jnp.int32),
        "phase": jnp.asarray(rng.integers(0, 4, s), jnp.int32),
        "phase_inc": jnp.asarray(rng.integers(0, 4, s), jnp.int32),
        "inactive": jnp.asarray(rng.integers(0, 3, s), jnp.int32),
        "order": jnp.asarray(np.arange(s), jnp.int32),
        "alloc_counter": jnp.int32(s),
        "dropped": jnp.int32(0),
    }


def random_power(sd, rng, nb=24, n_carriers=3):
    """Power spectra with moving random carriers so candidates/slots churn."""
    nc = sd.geometry.n_cells
    p = np.full((nb, nc), 1e-6)
    for _ in range(n_carriers):
        c = rng.integers(2, nc - 10)
        w = rng.integers(1, 6)
        on = rng.integers(0, nb - 2)
        off = rng.integers(on + 1, nb)
        p[on:off, c: c + w] += rng.random() * 2.0
    p += rng.random((nb, nc)) * 2e-6
    return jnp.asarray(p, jnp.float32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("occupancy", [0.0, 0.4, 1.0])
def test_pallas_matches_scan(seed, occupancy):
    rng = np.random.default_rng(seed)
    sd_scan = make_detector("scan")
    sd_pal = make_detector("pallas_interpret")
    state = random_state(sd_scan, rng, occupancy)
    power = random_power(sd_scan, rng)

    ns_a, fl_a = jax.jit(sd_scan.scan_slots)(power, state)
    ns_b, fl_b = sd_pal.scan_slots(power, state)

    for k in ns_a:
        np.testing.assert_array_equal(
            np.asarray(ns_a[k]), np.asarray(ns_b[k]), err_msg=f"state[{k}]"
        )
    names = ("got", "processed", "emit", "phase_used")
    for nm, a, b in zip(names, fl_a, fl_b):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b), err_msg=f"flags[{nm}]"
        )


def test_pallas_slot_exhaustion():
    """More simultaneous carriers than slots -> dropped counter matches."""
    rng = np.random.default_rng(9)
    sd_scan = make_detector("scan", max_slots=4)
    sd_pal = make_detector("pallas_interpret", max_slots=4)
    state_a = sd_scan.init_state()
    state_b = sd_pal.init_state()
    power = random_power(sd_scan, rng, nb=16, n_carriers=8)

    ns_a, _ = jax.jit(sd_scan.scan_slots)(power, state_a)
    ns_b, _ = sd_pal.scan_slots(power, state_b)
    assert int(ns_a["dropped"]) == int(ns_b["dropped"])
    assert int(ns_a["alloc_counter"]) == int(ns_b["alloc_counter"])


def idle_until(sd, rng, nb, first_on):
    """Power with no candidates before block ``first_on`` (chunk-idle runs)."""
    nc = sd.geometry.n_cells
    p = np.full((nb, nc), 1e-6) + rng.random((nb, nc)) * 2e-7
    c = rng.integers(2, nc - 10)
    p[first_on:, c:c + 3] += 2.0
    return jnp.asarray(p, jnp.float32)


@pytest.mark.parametrize("occupancy", [0.3, 1.0])
def test_pallas_age_only_dwell_matches_scan(occupancy):
    """Live slots aging across many candidate-free blocks (the kernel's
    age-only middle path) retire identically to the scan reference."""
    rng = np.random.default_rng(17)
    sd_scan = make_detector("scan")
    sd_pal = make_detector("pallas_interpret")
    state = random_state(sd_scan, rng, occupancy)
    nc = sd_scan.geometry.n_cells
    # flat noise floor: no candidates anywhere; live slots only age out
    power = jnp.asarray(
        np.full((64, nc), 1e-6) + rng.random((64, nc)) * 1e-7, jnp.float32
    )
    ns_a, fl_a = jax.jit(sd_scan.scan_slots)(power, state)
    ns_b, fl_b = sd_pal.scan_slots(power, state)
    for k in ns_a:
        np.testing.assert_array_equal(
            np.asarray(ns_a[k]), np.asarray(ns_b[k]), err_msg=f"state[{k}]"
        )
    for nm, a, b in zip(("got", "processed", "emit", "phase_used"),
                        fl_a, fl_b):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b), err_msg=f"flags[{nm}]"
        )


@pytest.mark.parametrize("delay", [0, 5, 31, 32, 33, 100])
def test_pallas_age_chunk_retirement_offsets(delay):
    """Dwell retirement at every chunk-relative offset (the closed-form
    chunked age path): a carrier turns on, the band then goes flat, and
    the slot must age out at exactly block on_end + delay + 1 regardless
    of where that lands relative to the 32-block chunk grid."""
    rng = np.random.default_rng(5)

    def det(backend):
        return SegmentDetector(
            0, 1024, 4, 0.1, 0.6, 6.0, 0.02, 0.2,
            channel_deactivation_delay=delay,
            max_slots=16, max_candidates=8, max_extract_width=256,
            lifecycle_backend=backend,
        )

    sd_scan, sd_pal = det("scan"), det("pallas_interpret")
    nc = sd_scan.geometry.n_cells
    nb = 192
    p = np.full((nb, nc), 1e-6) + rng.random((nb, nc)) * 1e-7
    p[3:9, 10:13] += 2.0  # carrier on blocks 3..8; flat afterwards
    power = jnp.asarray(p, jnp.float32)
    state = sd_scan.init_state()

    ns_a, fl_a = jax.jit(sd_scan.scan_slots)(power, state)
    ns_b, fl_b = sd_pal.scan_slots(power, state)
    for k in ns_a:
        np.testing.assert_array_equal(
            np.asarray(ns_a[k]), np.asarray(ns_b[k]), err_msg=f"state[{k}]"
        )
    for nm, a, b in zip(("got", "processed", "emit", "phase_used"),
                        fl_a, fl_b):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b), err_msg=f"flags[{nm}]"
        )
    # the slot must actually have lived and retired (when delay allows)
    emits = np.asarray(fl_a[2])
    if delay <= nb - 12:
        assert emits.any(), "expected a retirement inside the batch"


@pytest.mark.parametrize("chunk", [1, 4, 8, 32])
@pytest.mark.parametrize("first_on", [0, 7, 31, 32, 33, 63, 64])
def test_pallas_chunked_idle_matches_scan(chunk, first_on):
    """Chunked idle fast path == scan across chunk-boundary activity.

    first_on=64 (nb=64) is the fully-idle batch; 31/32/33 straddle the
    32-chunk boundary; chunk sizes not dividing nb fall back per-block.
    """
    from fdc_tpu.ops.lifecycle_pallas import slot_lifecycle

    rng = np.random.default_rng(first_on * 7 + chunk)
    sd_scan = make_detector("scan")
    sd_pal = make_detector("pallas_interpret")
    nb = 64
    power = idle_until(sd_scan, rng, nb, first_on)
    state = sd_scan.init_state()  # empty table: chunk idling reachable

    ns_a, fl_a = jax.jit(sd_scan.scan_slots)(power, state)

    # drive the kernel at the requested chunk size directly (scan_slots
    # uses the default); reuse its candidate packing via the detector
    import fdc_tpu.ops.lifecycle_pallas as lp

    orig = lp.slot_lifecycle

    def patched(cand_packed, st, **kw):
        kw["chunk"] = chunk
        return orig(cand_packed, st, **kw)

    lp.slot_lifecycle = patched
    try:
        ns_b, fl_b = sd_pal.scan_slots(power, sd_pal.init_state())
    finally:
        lp.slot_lifecycle = orig

    for k in ns_a:
        np.testing.assert_array_equal(
            np.asarray(ns_a[k]), np.asarray(ns_b[k]), err_msg=f"state[{k}]"
        )
    for nm, a, b in zip(("got", "processed", "emit", "phase_used"),
                        fl_a, fl_b):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b), err_msg=f"flags[{nm}]"
        )


# ---------------------------------------------------------------------------
# powact automaton kernel
# ---------------------------------------------------------------------------

from fdc_tpu.models.power_activation import PowerActivationBank


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_powact_pallas_matches_scan(seed):
    rng = np.random.default_rng(seed)
    chans = [(0.2, 0.03), (0.45, 0.05), (0.7, 0.02), (0.85, 0.04)]
    pa_scan = PowerActivationBank(1024, 4, chans, 10.0, "scan")
    pa_pal = PowerActivationBank(1024, 4, chans, 10.0, "pallas_interpret")

    c = pa_scan.num_channels
    nb = 32
    # powers that rise/fall by factors straddling the threshold
    powers = np.exp(rng.normal(0, 2.0, (nb, c))).astype(np.float32)
    powers = jnp.asarray(powers)
    state = {
        "active": jnp.asarray(rng.random(c) < 0.5),
        "lastpower": jnp.asarray(
            np.exp(rng.normal(0, 2.0, c)).astype(np.float32)
        ),
        "phase": jnp.asarray(rng.integers(0, 4, c), jnp.int32),
    }

    ns_a, fl_a = jax.jit(pa_scan.scan_flags)(powers, state)
    ns_b, fl_b = pa_pal.scan_flags(powers, state)
    for k in ns_a:
        np.testing.assert_array_equal(
            np.asarray(ns_a[k]), np.asarray(ns_b[k]), err_msg=f"state[{k}]"
        )
    for nm, a, b in zip(("rise", "fall", "proc", "pu"), fl_a, fl_b):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b), err_msg=nm
        )


@pytest.mark.parametrize("seed", list(range(8)))
def test_powact_pallas_chunked_matches_scan(seed):
    """The kernel's closed-form quiet chunks == lax.scan, bit-exact.

    Powers hold still for whole 32-block chunks (no ratio edge, so the
    chunk is closed form) between chunks of random steps straddling the
    threshold; random carried state exercises bursts continuing through
    the quiet chunks."""
    rng = np.random.default_rng(seed)
    chans = [(0.2, 0.03), (0.45, 0.05), (0.7, 0.02), (0.85, 0.04)]
    pa_scan = PowerActivationBank(1024, 4, chans, 10.0, "scan")
    pa_pal = PowerActivationBank(1024, 4, chans, 10.0, "pallas_interpret")

    c = pa_scan.num_channels
    nb = 128
    p = np.exp(rng.normal(0, 2.0, (nb, c))).astype(np.float32)
    for chunk in rng.choice(nb // 32, size=2, replace=False):
        lo = chunk * 32
        p[lo:lo + 32] = p[max(lo - 1, 0)]  # quiet: equal to the block before
    powers = jnp.asarray(p)
    state = {
        "active": jnp.asarray(rng.random(c) < 0.5),
        "lastpower": jnp.asarray(
            np.exp(rng.normal(0, 2.0, c)).astype(np.float32)
        ),
        "phase": jnp.asarray(rng.integers(0, 4, c), jnp.int32),
    }

    ns_a, fl_a = jax.jit(pa_scan.scan_flags)(powers, state)
    ns_b, fl_b = pa_pal.scan_flags(powers, state)
    for k in ns_a:
        np.testing.assert_array_equal(
            np.asarray(ns_a[k]), np.asarray(ns_b[k]), err_msg=f"state[{k}]"
        )
    for nm, a, b in zip(("rise", "fall", "proc", "pu"), fl_a, fl_b):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b), err_msg=nm
        )


# ---------------------------------------------------------------------------
# fused multi-segment lifecycle kernel
# ---------------------------------------------------------------------------

from fdc_tpu.models.segment_detection import scan_slots_multi


def make_detector_at(backend, band, max_slots=16, max_candidates=8,
                     delay=1):
    lo, hi = band
    return SegmentDetector(
        0, 1024, 4, lo, hi, 6.0, 0.02, 0.2,
        channel_deactivation_delay=delay,
        max_slots=max_slots,
        max_candidates=max_candidates,
        max_extract_width=256,
        lifecycle_backend=backend,
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multi_segment_fused_matches_per_segment(seed):
    """G segments fused in one kernel == per-segment scan_slots, bit-exact
    — heterogeneous slot counts, candidate caps, and delays."""
    rng = np.random.default_rng(seed)
    shapes = [
        dict(band=(0.05, 0.3), max_slots=16, max_candidates=8, delay=1),
        dict(band=(0.3, 0.55), max_slots=8, max_candidates=4, delay=0),
        dict(band=(0.55, 0.8), max_slots=32, max_candidates=8, delay=3),
    ]
    sds_scan = [make_detector_at("scan", **s) for s in shapes]
    sds_pal = [make_detector_at("pallas_interpret", **s) for s in shapes]
    states = [random_state(sd, rng, occupancy=0.3) for sd in sds_scan]
    powers = [random_power(sd, rng) for sd in sds_scan]

    ref = [
        jax.jit(sd.scan_slots)(p, st)
        for sd, p, st in zip(sds_scan, powers, states)
    ]
    fused = scan_slots_multi(sds_pal, powers, states)

    for g, ((ns_a, fl_a), (ns_b, fl_b)) in enumerate(zip(ref, fused)):
        for k in ns_a:
            np.testing.assert_array_equal(
                np.asarray(ns_a[k]), np.asarray(ns_b[k]),
                err_msg=f"seg{g} state[{k}]",
            )
        for nm, a, b in zip(("got", "processed", "emit", "phase_used"),
                            fl_a, fl_b):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b), err_msg=f"seg{g} {nm}"
            )


@pytest.mark.parametrize("first_on", [0, 31, 33, 64])
def test_multi_segment_fused_chunked_paths(first_on):
    """One busy segment forces the per-block walk while the other two are
    idle / age-only; a fully idle batch (first_on=64) takes the fused
    closed-form chunk path. All must stay bit-exact vs per-segment."""
    rng = np.random.default_rng(first_on + 1)
    shapes = [
        dict(band=(0.05, 0.3)),
        dict(band=(0.3, 0.55)),
        dict(band=(0.55, 0.8)),
    ]
    sds_scan = [make_detector_at("scan", **s) for s in shapes]
    sds_pal = [make_detector_at("pallas_interpret", **s) for s in shapes]
    nb = 64
    # seg0: candidates from first_on; seg1: empty band (idle); seg2: live
    # slots but a flat band (age-only path)
    powers = [
        idle_until(sds_scan[0], rng, nb, first_on),
        jnp.asarray(
            np.full((nb, sds_scan[1].geometry.n_cells), 1e-6), jnp.float32
        ),
        jnp.asarray(
            np.full((nb, sds_scan[2].geometry.n_cells), 1e-6), jnp.float32
        ),
    ]
    states = [
        sds_scan[0].init_state(),
        sds_scan[1].init_state(),
        random_state(sds_scan[2], rng, occupancy=0.5),
    ]
    ref = [
        jax.jit(sd.scan_slots)(p, st)
        for sd, p, st in zip(sds_scan, powers, states)
    ]
    fused = scan_slots_multi(sds_pal, powers, states)
    for g, ((ns_a, fl_a), (ns_b, fl_b)) in enumerate(zip(ref, fused)):
        for k in ns_a:
            np.testing.assert_array_equal(
                np.asarray(ns_a[k]), np.asarray(ns_b[k]),
                err_msg=f"seg{g} state[{k}]",
            )
        for nm, a, b in zip(("got", "processed", "emit", "phase_used"),
                            fl_a, fl_b):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b), err_msg=f"seg{g} {nm}"
            )


def test_scan_slots_multi_cpu_fallback():
    """On the scan backend the multi entry point must defer per segment."""
    rng = np.random.default_rng(3)
    sds = [
        make_detector_at("scan", band=(0.05, 0.3)),
        make_detector_at("scan", band=(0.3, 0.55)),
    ]
    states = [random_state(sd, rng) for sd in sds]
    powers = [random_power(sd, rng) for sd in sds]
    ref = [sd.scan_slots(p, st) for sd, p, st in zip(sds, powers, states)]
    multi = scan_slots_multi(sds, powers, states)
    for (ns_a, _), (ns_b, _) in zip(ref, multi):
        for k in ns_a:
            np.testing.assert_array_equal(
                np.asarray(ns_a[k]), np.asarray(ns_b[k])
            )


# ---------------------------------------------------------------------------
# powact automaton fused into the lifecycle kernel
# ---------------------------------------------------------------------------


def _random_pa(rng, c, nb):
    powers = jnp.asarray(
        np.exp(rng.normal(0, 2.0, (nb, c))).astype(np.float32)
    )
    state = {
        "active": jnp.asarray(rng.random(c) < 0.5),
        "lastpower": jnp.asarray(
            np.exp(rng.normal(0, 2.0, c)).astype(np.float32)
        ),
        "phase": jnp.asarray(rng.integers(0, 4, c), jnp.int32),
    }
    return powers, state


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("nb", [24, 64])  # per-block and chunked paths
def test_fused_powact_matches_separate(seed, nb):
    """powact riding the multi-segment kernel == separate scan_flags +
    per-segment scan_slots, bit-exact (nb=64 exercises the chunked quiet
    path, nb=24 the per-block fallback)."""
    rng = np.random.default_rng(seed)
    shapes = [
        dict(band=(0.05, 0.3), max_slots=16, max_candidates=8, delay=1),
        dict(band=(0.3, 0.55), max_slots=8, max_candidates=4, delay=0),
    ]
    chans = [(0.2, 0.03), (0.45, 0.05), (0.7, 0.02), (0.85, 0.04)]
    sds_scan = [make_detector_at("scan", **s) for s in shapes]
    sds_pal = [make_detector_at("pallas_interpret", **s) for s in shapes]
    pa_scan = PowerActivationBank(1024, 4, chans, 10.0, "scan")
    pa_pal = PowerActivationBank(1024, 4, chans, 10.0, "pallas_interpret")

    states = [random_state(sd, rng, occupancy=0.3) for sd in sds_scan]
    powers = [random_power(sd, rng, nb=nb) for sd in sds_scan]
    pa_powers, pa_state = _random_pa(rng, pa_scan.num_channels, nb)

    ref = [
        jax.jit(sd.scan_slots)(p, st)
        for sd, p, st in zip(sds_scan, powers, states)
    ]
    pa_ref = jax.jit(pa_scan.scan_flags)(pa_powers, pa_state)

    fused, pa_fused = scan_slots_multi(
        sds_pal, powers, states, powact=(pa_pal, pa_powers, pa_state)
    )

    for g, ((ns_a, fl_a), (ns_b, fl_b)) in enumerate(zip(ref, fused)):
        for k in ns_a:
            np.testing.assert_array_equal(
                np.asarray(ns_a[k]), np.asarray(ns_b[k]),
                err_msg=f"seg{g} state[{k}]",
            )
        for nm, a, b in zip(("got", "processed", "emit", "phase_used"),
                            fl_a, fl_b):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b), err_msg=f"seg{g} {nm}"
            )
    ns_a, fl_a = pa_ref
    ns_b, fl_b = pa_fused
    for k in ns_a:
        np.testing.assert_array_equal(
            np.asarray(ns_a[k]), np.asarray(ns_b[k]),
            err_msg=f"pa state[{k}]",
        )
    for nm, a, b in zip(("rise", "fall", "proc", "pu"), fl_a, fl_b):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b), err_msg=f"pa {nm}"
        )


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_powact_single_segment(seed):
    """G=1 + powact fuses too (the flagship shape)."""
    rng = np.random.default_rng(seed)
    chans = [(0.3, 0.04)]
    sd_scan = make_detector_at("scan", band=(0.55, 0.8))
    sd_pal = make_detector_at("pallas_interpret", band=(0.55, 0.8))
    pa_scan = PowerActivationBank(1024, 4, chans, 10.0, "scan")
    pa_pal = PowerActivationBank(1024, 4, chans, 10.0, "pallas_interpret")

    state = random_state(sd_scan, rng, occupancy=0.3)
    power = random_power(sd_scan, rng, nb=64)
    pa_powers, pa_state = _random_pa(rng, 1, 64)

    ns_ref, fl_ref = jax.jit(sd_scan.scan_slots)(power, state)
    pa_ref = jax.jit(pa_scan.scan_flags)(pa_powers, pa_state)

    fused, pa_fused = scan_slots_multi(
        [sd_pal], [power], [state], powact=(pa_pal, pa_powers, pa_state)
    )
    ((ns_b, fl_b),) = fused
    for k in ns_ref:
        np.testing.assert_array_equal(
            np.asarray(ns_ref[k]), np.asarray(ns_b[k]),
            err_msg=f"state[{k}]",
        )
    for nm, a, b in zip(("got", "processed", "emit", "phase_used"),
                        fl_ref, fl_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=nm)
    for k in pa_ref[0]:
        np.testing.assert_array_equal(
            np.asarray(pa_ref[0][k]), np.asarray(pa_fused[0][k]),
            err_msg=f"pa state[{k}]",
        )
    for nm, a, b in zip(("rise", "fall", "proc", "pu"),
                        pa_ref[1], pa_fused[1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"pa {nm}")


def test_scan_slots_multi_powact_cpu_fallback():
    """powact=(bank, ...) on the scan backend returns (segs, pa) via the
    separate paths."""
    rng = np.random.default_rng(5)
    sds = [make_detector_at("scan", band=(0.05, 0.3))]
    chans = [(0.2, 0.03), (0.7, 0.02)]
    bank = PowerActivationBank(1024, 4, chans, 10.0, "scan")
    states = [random_state(sd, rng) for sd in sds]
    powers = [random_power(sd, rng) for sd in sds]
    pa_powers, pa_state = _random_pa(rng, 2, 24)

    ref_seg = [sd.scan_slots(p, st) for sd, p, st in zip(sds, powers, states)]
    ref_pa = bank.scan_flags(pa_powers, pa_state)
    segs, pa = scan_slots_multi(
        sds, powers, states, powact=(bank, pa_powers, pa_state)
    )
    for (ns_a, _), (ns_b, _) in zip(ref_seg, segs):
        for k in ns_a:
            np.testing.assert_array_equal(
                np.asarray(ns_a[k]), np.asarray(ns_b[k])
            )
    for k in ref_pa[0]:
        np.testing.assert_array_equal(
            np.asarray(ref_pa[0][k]), np.asarray(pa[0][k])
        )


# ---------------------------------------------------------------------------
# dwell patterns around the retirement boundary
# ---------------------------------------------------------------------------


def _carrier_power(sd, nb, pattern, cell=6, width=3, level=2.0):
    """[nb, n_cells] noise-floor powers with one carrier present on the
    blocks where pattern[b] is truthy."""
    nc = sd.geometry.n_cells
    p = np.full((nb, nc), 1e-6, np.float32)
    for b in range(nb):
        if pattern[b % len(pattern)]:
            p[b, cell:cell + width] += level
    return jnp.asarray(p)


@pytest.mark.parametrize("delay", [0, 1, 3])
@pytest.mark.parametrize("pattern", [
    (1,),            # carrier every block: refresh-only chunks
    (1, 0),          # toggle: gap 1 (== delay boundary at delay=1)
    (1, 0, 0),       # gap 2: retires at delay<=1, refresh-only at 3
    (1, 1, 1, 1, 0, 0, 0, 0),  # dwell + silence crossing chunk state
])
def test_refresh_chunk_parity(delay, pattern):
    """Deterministic dwell patterns around the retirement boundary (gap
    == delay keeps the slot, gap > delay retires), bit-exact vs the
    lax.scan reference over two 32-block chunks + a carried step."""
    sd_scan = make_detector_at("scan", band=(0.05, 0.5), delay=delay)
    sd_pal = make_detector_at("pallas_interpret", band=(0.05, 0.5),
                              delay=delay)
    nb = 64
    power = _carrier_power(sd_scan, nb, pattern)
    st_a = sd_scan.init_state()
    st_b = sd_pal.init_state()
    # two steps: the second starts with carried ages/slots so chunk
    # boundaries land mid-dwell
    for step in range(2):
        ns_a, fl_a = jax.jit(sd_scan.scan_slots)(power, st_a)
        ns_b, fl_b = sd_pal.scan_slots(power, st_b)
        for k in ns_a:
            np.testing.assert_array_equal(
                np.asarray(ns_a[k]), np.asarray(ns_b[k]),
                err_msg=f"step{step} delay{delay} {pattern} state[{k}]",
            )
        for nm, a, b in zip(("got", "processed", "emit", "phase_used"),
                            fl_a, fl_b):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b),
                err_msg=f"step{step} delay{delay} {pattern} {nm}",
            )
        st_a, st_b = ns_a, ns_b


@pytest.mark.parametrize("seed", list(range(6)))
def test_refresh_chunk_fuzz(seed):
    """Random dwell/gap patterns at random delays: alloc, refresh,
    retire, and realloc churn across chunk boundaries, bit-exact."""
    rng = np.random.default_rng(100 + seed)
    delay = int(rng.integers(0, 4))
    sd_scan = make_detector_at("scan", band=(0.05, 0.5), delay=delay)
    sd_pal = make_detector_at("pallas_interpret", band=(0.05, 0.5),
                              delay=delay)
    nb = 64
    nc = sd_scan.geometry.n_cells
    p = np.full((nb, nc), 1e-6, np.float32)
    for _ in range(3):  # carriers with random on/off runs
        cell = int(rng.integers(2, nc - 8))
        w = int(rng.integers(1, 5))
        b = 0
        on = bool(rng.integers(0, 2))
        while b < nb:
            run = int(rng.integers(1, 8))
            if on:
                p[b:b + run, cell:cell + w] += float(rng.random()) + 0.5
            b += run
            on = not on
    power = jnp.asarray(p)
    st_a = sd_scan.init_state()
    st_b = sd_pal.init_state()
    for step in range(2):
        ns_a, fl_a = jax.jit(sd_scan.scan_slots)(power, st_a)
        ns_b, fl_b = sd_pal.scan_slots(power, st_b)
        for k in ns_a:
            np.testing.assert_array_equal(
                np.asarray(ns_a[k]), np.asarray(ns_b[k]),
                err_msg=f"seed{seed} step{step} state[{k}]",
            )
        for nm, a, b2 in zip(("got", "processed", "emit", "phase_used"),
                             fl_a, fl_b):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b2),
                err_msg=f"seed{seed} step{step} {nm}",
            )
        st_a, st_b = ns_a, ns_b


# ---------------------------------------------------------------------------
# exact all-edges mode + candidate compaction (round 4)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_accepted_candidate_bound(seed):
    """The compaction proof: the greedy non-overlap acceptance never
    accepts more than (n_cells - 1) // 2 candidates per block — every
    accepted interval spans >= 2 cells (a rise and a fall cannot share a
    ratio index) and accepted intervals are disjoint. Exercised with an
    adversarial comb (alternating strong/weak cells == the densest
    possible edge pattern) plus random churn."""
    from fdc_tpu.ops.detect import detect_candidates

    rng = np.random.default_rng(seed)
    sd = make_detector_at("scan", band=(0.05, 0.5), max_candidates=0)
    nc = sd.geometry.n_cells
    bound = max(1, (nc - 1) // 2)
    assert sd.k_pack == bound

    combs = np.full((8, nc), 1e-6, np.float32)
    combs[0, ::2] = 1.0                      # densest comb
    combs[1, 1::2] = 1.0                     # shifted comb
    combs[2, ::3] = 1.0
    combs[3] = rng.random(nc) + 1e-6         # broadband churn
    combs[4] = np.where(rng.random(nc) > 0.5, 1.0, 1e-6)
    combs[5, : nc // 2 * 2].reshape(-1, 2)[:, 0] = 1e3  # strong comb
    combs[6] = 10.0 ** rng.integers(-6, 3, nc)
    combs[7, ::2] = 10.0 ** rng.integers(0, 4, nc // 2 + nc % 2)
    _, _, cv = jax.vmap(
        lambda p: detect_candidates(p, sd.thresh, sd.k_detect)
    )(jnp.asarray(combs))
    counts = np.asarray(cv).sum(axis=1)
    assert counts.max() <= bound, (counts, bound)

    # ... and the compacted pack preserves the accepted set in order
    packed, kp = sd._packed_candidates(jnp.asarray(combs))
    assert kp == bound
    pk = np.asarray(packed)
    assert (pk[:, 2 * kp:3 * kp].sum(axis=1) == counts).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_mode_pallas_matches_scan(seed):
    """max_candidates=0 (exact all-edges, the config default): Pallas
    kernel == lax.scan reference across churny multi-carrier streams,
    with the compacted pack (k_detect=n_cells-1,
    k_pack=(n_cells-1)//2)."""
    rng = np.random.default_rng(300 + seed)
    sd_scan = make_detector_at("scan", band=(0.05, 0.6),
                               max_candidates=0)
    sd_pal = make_detector_at("pallas_interpret", band=(0.05, 0.6),
                              max_candidates=0)
    assert sd_scan.k_detect > sd_scan.k_pack > 2
    state_a = random_state(sd_scan, rng, occupancy=0.4)
    state_b = jax.tree.map(lambda x: x, state_a)
    power = random_power(sd_scan, rng, nb=64, n_carriers=6)

    for step in range(2):
        ns_a, fl_a = jax.jit(sd_scan.scan_slots)(power, state_a)
        ns_b, fl_b = sd_pal.scan_slots(power, state_b)
        for k in ns_a:
            np.testing.assert_array_equal(
                np.asarray(ns_a[k]), np.asarray(ns_b[k]),
                err_msg=f"seed{seed} step{step} state[{k}]",
            )
        for nm, a, b in zip(("got", "processed", "emit", "phase_used"),
                            fl_a, fl_b):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b),
                err_msg=f"seed{seed} step{step} {nm}",
            )
        state_a, state_b = ns_a, ns_b


@pytest.mark.parametrize("with_pa", [False, True])
def test_batch_idle_fast_path_matches_scan(with_pa):
    """A fully idle batch (no candidates, no live slots, no powact
    edges) takes the closed-form chunk in every chunk — outputs must
    equal the lax.scan reference exactly, including resting phases."""
    rng = np.random.default_rng(77)
    sd_scan = make_detector("scan")
    sd_pal = make_detector("pallas_interpret")
    nc = sd_scan.geometry.n_cells
    power = jnp.asarray(
        np.full((64, nc), 1e-6) + rng.random((64, nc)) * 1e-8, jnp.float32
    )
    # idle state with nonzero resting phases (phase_used must echo them)
    state = sd_scan.init_state()
    state = {**state, "phase": jnp.asarray(
        rng.integers(0, 4, sd_scan.max_slots), jnp.int32
    )}

    if not with_pa:
        ns_a, fl_a = jax.jit(sd_scan.scan_slots)(power, state)
        ns_b, fl_b = sd_pal.scan_slots(power, state)
        for k in ns_a:
            np.testing.assert_array_equal(
                np.asarray(ns_a[k]), np.asarray(ns_b[k]), err_msg=k
            )
        for nm, a, b in zip(("got", "proc", "emit", "pu"), fl_a, fl_b):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b), err_msg=nm
            )
        return

    # burst kernel beside the idle lifecycle: quiet powers, idle bank state
    from fdc_tpu.ops.lifecycle_pallas import powact_flags, slot_lifecycle_multi

    packed, _ = sd_pal._packed_candidates(power)
    c = 3
    pa_state = {
        "active": jnp.zeros((c,), bool),
        "lastpower": jnp.full((c,), 1e-5, jnp.float32),
        "phase": jnp.asarray([1, 2, 3], jnp.int32),
    }
    pows = jnp.full((64, c), 1e-5, jnp.float32)
    (res,) = slot_lifecycle_multi(
        (packed,), (state,),
        n_cands=(sd_pal.k_pack,), rs=(4,), delays=(1,),
        interpret=True,
    )
    pa_new, pa_flags = powact_flags(
        pows, pa_state, jnp.asarray([1, 2, 3], jnp.int32), r=4,
        thresh=4.0, interpret=True,
    )
    ns_b, fl_b = res
    assert not np.asarray(fl_b[0]).any()  # no activations
    np.testing.assert_array_equal(
        np.asarray(pa_new["phase"]), np.asarray(pa_state["phase"])
    )
    np.testing.assert_array_equal(
        np.asarray(pa_flags[3]),
        np.tile(np.asarray(pa_state["phase"])[:, None], (1, 64)),
    )
    assert not np.asarray(pa_flags[0]).any()


# ---------------------------------------------------------------------------
# chunks with a single candidate-bearing block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("evt", [0, 1, 15, 30, 31])
@pytest.mark.parametrize("occupancy", [0.0, 0.5])
def test_single_event_chunk_matches_scan(evt, occupancy):
    """A chunk with exactly ONE candidate-bearing block (the full body on
    that block, the aging-only body on the others) — bit-exact vs the
    scan reference at every event position, with live slots entering at assorted ages (retiring
    before, at, and after the event block)."""
    rng = np.random.default_rng(400 + evt)
    sd_scan = make_detector_at("scan", band=(0.05, 0.5), delay=2)
    sd_pal = make_detector_at("pallas_interpret", band=(0.05, 0.5),
                              delay=2)
    nc = sd_scan.geometry.n_cells
    nb = 64
    p = np.full((nb, nc), 1e-6, np.float32)
    # chunk 0: one isolated candidate at block `evt`; chunk 1: idle
    p[evt, 8:11] += 2.0
    power = jnp.asarray(p)
    state = random_state(sd_scan, rng, occupancy)
    # spread incoming ages so retirements land before/at/after the event
    state = {**state, "inactive": jnp.asarray(
        rng.integers(0, 6, sd_scan.max_slots), jnp.int32
    )}

    ns_a, fl_a = jax.jit(sd_scan.scan_slots)(power, state)
    ns_b, fl_b = sd_pal.scan_slots(power, state)
    for k in ns_a:
        np.testing.assert_array_equal(
            np.asarray(ns_a[k]), np.asarray(ns_b[k]),
            err_msg=f"evt{evt} state[{k}]",
        )
    for nm, a, b in zip(("got", "processed", "emit", "phase_used"),
                        fl_a, fl_b):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b), err_msg=f"evt{evt} {nm}"
        )


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_single_event_sparse_fuzz(seed):
    """Sparse random candidates (0-2 per chunk, isolated and paired) +
    churny slot states across multiple steps: the single-event and
    multi-event dispatch boundaries stay bit-exact vs the scan path."""
    rng = np.random.default_rng(500 + seed)
    delay = int(rng.integers(0, 4))
    sd_scan = make_detector_at("scan", band=(0.05, 0.5), delay=delay)
    sd_pal = make_detector_at("pallas_interpret", band=(0.05, 0.5),
                              delay=delay)
    nc = sd_scan.geometry.n_cells
    nb = 128
    p = np.full((nb, nc), 1e-6, np.float32)
    for b in sorted(rng.choice(nb, size=6, replace=False)):
        cell = int(rng.integers(2, nc - 8))
        p[b, cell:cell + int(rng.integers(1, 4))] += 1.0 + rng.random()
    power = jnp.asarray(p)
    st_a = sd_scan.init_state()
    st_b = sd_pal.init_state()
    for step in range(2):
        ns_a, fl_a = jax.jit(sd_scan.scan_slots)(power, st_a)
        ns_b, fl_b = sd_pal.scan_slots(power, st_b)
        for k in ns_a:
            np.testing.assert_array_equal(
                np.asarray(ns_a[k]), np.asarray(ns_b[k]),
                err_msg=f"seed{seed} step{step} state[{k}]",
            )
        for nm, a, b in zip(("got", "processed", "emit", "phase_used"),
                            fl_a, fl_b):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b),
                err_msg=f"seed{seed} step{step} {nm}",
            )
        st_a, st_b = ns_a, ns_b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_super_chunk_skip_matches_scan(seed):
    """Long batches (8 chunks): quiet stretches of several chunks take
    the closed form chunk by chunk, and work appearing anywhere
    dispatches correctly — bit-exact vs the scan reference, with live
    slots aging across many chunk boundaries."""
    rng = np.random.default_rng(600 + seed)
    delay = int(rng.integers(0, 4))
    sd_scan = make_detector_at("scan", band=(0.05, 0.5), delay=delay)
    sd_pal = make_detector_at("pallas_interpret", band=(0.05, 0.5),
                              delay=delay)
    nc = sd_scan.geometry.n_cells
    nb = 256  # 8 chunks of 32
    p = np.full((nb, nc), 1e-6, np.float32)
    # seed 0: one isolated event early (the last seven chunks quiet);
    # others: sparse events across both regions + a dwelling carrier
    p[7, 5:8] += 2.0
    if seed:
        for b in rng.choice(nb, size=4, replace=False):
            cell = int(rng.integers(2, nc - 8))
            p[b, cell:cell + 2] += 1.5
        p[140:200, 20:22] += 2.0  # dwell crossing chunk boundaries
    power = jnp.asarray(p)
    st_a = sd_scan.init_state()
    st_b = sd_pal.init_state()
    for step in range(2):
        ns_a, fl_a = jax.jit(sd_scan.scan_slots)(power, st_a)
        ns_b, fl_b = sd_pal.scan_slots(power, st_b)
        for k in ns_a:
            np.testing.assert_array_equal(
                np.asarray(ns_a[k]), np.asarray(ns_b[k]),
                err_msg=f"seed{seed} step{step} state[{k}]",
            )
        for nm, a, b in zip(("got", "processed", "emit", "phase_used"),
                            fl_a, fl_b):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b),
                err_msg=f"seed{seed} step{step} {nm}",
            )
        st_a, st_b = ns_a, ns_b
