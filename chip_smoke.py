#!/usr/bin/env python3
"""On-card smoke test of the channelizer's main path.

Drives the flagship configuration (4096-point FFT, 64 throughput channels,
one burst channel, one detection segment, 512 blocks per batch) through the
entry points a user calls — ``FrequencyDomainChannelizer.process`` and the
``python -m fdc_tpu run|vcm`` command line — on a synthesized capture, and
checks every result against the float64 NumPy oracle in ``tests/golden.py``:
events exactly (metadata) with their samples and the throughput streams
within rtol 2e-4 / atol 2e-5 (relative to each signal's peak). Then each
hand-written kernel of the path is compared bit-exactly with its plain
reference at flagship widths.

Usage:
  python chip_smoke.py                # one card: phases 1-5
  python chip_smoke.py --four-cards   # four cards: sharded + pipeline only

Needs a GPU: exits non-zero without printing a result when JAX finds none.
The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

RTOL, ATOL = 2e-4, 2e-5  # the stream contract (relative to peak for atol)
N_BATCHES = 9  # 9 x 512 x 3072 = 14.2 M complex samples
SEED = 0


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# capture synthesis
# ---------------------------------------------------------------------------


def flagship_capture(cfg, n_batches, rng):
    """Tones in every fourth throughput channel, scripted on/off bursts in
    the burst channel, and carriers one to four decimation cells wide
    appearing and vanishing in the detection segment — all ending well
    before the end of the capture, so no burst is open when the stream
    ends. Every tone sits on an FFT bin centre, so it leaks nothing into
    other bins and no detection decision rests on leakage interference."""
    n_fft, inplen = cfg.blocksize, cfg.inplen
    n = n_batches * cfg.batch_blocks * inplen
    t = np.arange(n, dtype=np.float64)
    x = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))

    def tone(fdc_bin, on=None, off=None, amp=1.0, phase=0.0):
        f = fdc_bin / n_fft - 0.5  # normalized baseband frequency
        lo = 0 if on is None else on * inplen
        hi = n if off is None else off * inplen
        x[lo:hi] += amp * np.exp(2j * np.pi * (f * t[lo:hi]) + 1j * phase)

    for i, (f, _) in enumerate(cfg.throughput_channels):
        if i % 4 == 0:
            tone(round((f + 0.5) * n_fft) + i % 3 - 1, amp=0.5)
    pa_bin = round((cfg.activity_controlled_channels[0][0] + 0.5) * n_fft)
    for on, off, amp in ((40, 300, 1.0), (700, 706, 0.7), (1500, 2100, 0.8),
                         (3000, 3010, 1.2)):
        tone(pa_bin, on, off, amp)
    # detection segment: FDC bins 3726..4056 in cells of 10 bins; a
    # carrier over an even number of cells is detected over an odd one
    # (its edge cells included), which puts its extraction start on an
    # odd bin
    seg0 = 3726
    for on, off, cell, width, amp in (
        (100, 900, 2, 1, 1.0), (300, 1400, 8, 2, 0.8),
        (1000, 1020, 14, 4, 0.9), (1800, 2600, 5, 2, 0.9),
        (2300, 3300, 20, 3, 0.7), (3500, 3900, 12, 2, 1.0),
    ):
        for c in range(cell, cell + width):
            for off_bin in (2, 5, 8):
                tone(seg0 + 10 * c + off_bin, on, off, amp / 3,
                     phase=float(rng.uniform(0, 2 * np.pi)))
    return x.astype(np.complex64)


def golden_spectra(x, cfg):
    from golden import golden_forward_fft, golden_overlap_save

    blocks, _ = golden_overlap_save(
        x.astype(np.complex128), cfg.blocksize, cfg.ovllen
    )
    return golden_forward_fft(blocks)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def close(got, ref, what):
    got = np.asarray(got)
    ref = np.asarray(ref)
    check(got.shape == ref.shape, f"{what}: shape {got.shape} vs {ref.shape}")
    peak = float(np.max(np.abs(ref))) if ref.size else 0.0
    err = np.abs(got - ref)
    tol = ATOL * max(peak, 1.0) + RTOL * np.abs(ref)
    check(bool(np.all(err <= tol)),
          f"{what}: max |err| {err.max():.3g} (peak {peak:.3g})")
    return float(err.max() / max(peak, 1e-30)) if ref.size else 0.0


def events_vs_golden(ours, ref, what, vector=False):
    """Exact event metadata; samples within the stream contract. Returns
    the worst sample error relative to the event's peak."""
    check(len(ours) == len(ref),
          f"{what}: {len(ours)} events vs golden {len(ref)}")
    worst = 0.0
    for i, (ev, g) in enumerate(zip(ours, ref)):
        tag = f"{what} event {i}"
        check(ev.finalized == g["finalized"], f"{tag}: finalized")
        check(ev.blockstart == g["blockstart"], f"{tag}: blockstart "
              f"{ev.blockstart} vs {g['blockstart']}")
        check(ev.blockend == g["blockend"], f"{tag}: blockend")
        check(ev.rel_cfreq == g["rel_cfreq"], f"{tag}: rel_cfreq")
        check(ev.rel_bw == g["rel_bw"], f"{tag}: rel_bw")
        if g["part"] is not None:
            check(ev.part == g["part"], f"{tag}: part")
        if vector:
            check(ev.vectorstart == g["vectorstart"], f"{tag}: vectorstart")
            check(ev.vectorend == g["vectorend"], f"{tag}: vectorend")
        worst = max(worst, close(ev.data, g["data"], tag))
    return worst


def event_key(e):
    """Event identity modulo the timestamped ID prefix."""
    d = e if isinstance(e, dict) else e.to_dict()
    return (d["ID"].split(".", 1)[1], d["finalized"], d.get("part"),
            d["rel_cfreq"], d["rel_bw"], d["blockstart"], d["blockend"])


def events_equal(a, b, what):
    check(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} events")
    for i, (x, y) in enumerate(zip(a, b)):
        check(event_key(x) == event_key(y), f"{what}: event {i} differs")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


# seconds spent lowering and compiling (persistent-cache hits included),
# summed from JAX's own compile events; the rest of a phase's wall time
# is steady work
_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)
_compile_s = [0.0]


def _on_duration(event, secs, **_):
    if event in _COMPILE_EVENTS:
        _compile_s[0] += secs


class Clock:
    """Wall time of a phase, split into compile and steady; reads the
    time so far until stopped."""

    def __init__(self):
        self.t0, self.c0 = time.perf_counter(), _compile_s[0]
        self.stopped = None

    def stop(self):
        self.stopped = (time.perf_counter(), _compile_s[0])
        return self

    def __str__(self):
        t1, c1 = self.stopped or (time.perf_counter(), _compile_s[0])
        wall, comp = t1 - self.t0, c1 - self.c0
        return (f"wall {wall:.2f} s = {comp:.2f} s compile + "
                f"{wall - comp:.2f} s steady")


def timed(fn, *a, **kw):
    clock = Clock()
    out = fn(*a, **kw)
    return out, clock.stop()


def phase_flagship(cfg, x, spectra):
    """Phase 2: FrequencyDomainChannelizer.process vs the golden oracle."""
    from golden import (
        golden_power_activation,
        golden_segment_detection,
        golden_throughput_channel,
    )

    from fdc_tpu.models.channelizer import FrequencyDomainChannelizer
    from fdc_tpu.ops.fft import DFT_PRECISION

    fdc = FrequencyDomainChannelizer(cfg)
    bs = fdc.batch_samples
    first, c_first = timed(fdc.process, x[:bs])
    t = time.perf_counter()
    rest = fdc.process(x[bs:])
    steady = (time.perf_counter() - t) / (N_BATCHES - 1)
    tail = fdc.flush()
    events = first.events + rest.events + tail.events
    streams = [np.concatenate([a, b]) for a, b in
               zip(first.throughput, rest.throughput)]
    log(f"phase 2 process(): first batch {c_first}; then "
        f"{steady * 1e3:.1f} ms/batch over {N_BATCHES - 1} batches "
        f"({bs / steady / 1e6:.1f} Msamples/s incl. host emission)")
    transforms = (f"matmul DFTs at {DFT_PRECISION}" if cfg.use_mxu_fft
                  else "FFT lowering (cuFFT), no matmul DFTs")
    log(f"phase 2 precision: forward FFT and subband transforms by "
        f"{transforms}; band_power matmul HIGHEST; slot geometry, plan "
        f"ids and candidate packs by exact integer indexing")

    n, r = cfg.blocksize, cfg.relinvovl
    # burst channel
    f_pa, bw_pa = cfg.activity_controlled_channels[0]
    ref_pa = golden_power_activation(
        spectra, n, r, f_pa + 0.5, bw_pa, cfg.act_contr_threshold,
        cfg.pow_act_maxblocks,
    )
    ours_pa = [e for e in events if ".PowActChan." in e.ID]
    w_pa = events_vs_golden(ours_pa, ref_pa, "burst")
    # detection segment
    seg = cfg.activity_detection_segments[0]
    ref_sd = golden_segment_detection(
        spectra, n, r, seg[0] + 0.5, seg[1] + 0.5, cfg.act_det_threshold,
        cfg.fdc_minchandist(), cfg.minchanflankpuffer,
        cfg.act_det_maxblocks, cfg.act_det_deactivation_delay,
    )
    ours_sd = [e for e in events if ".DETECTED." in e.ID]
    w_sd = events_vs_golden(ours_sd, ref_sd, "detection", vector=True)
    starts = {round((g["rel_cfreq"] - g["rel_bw"] / 2) * n) for g in ref_sd}
    odd_high = sorted(s for s in starts if s % 2 and s > 2048)
    check(odd_high, f"no detected channel with an odd ext_start > 2048 "
          f"(starts {sorted(starts)})")
    # throughput streams
    w_tp = 0.0
    for i, (f, bw) in enumerate(cfg.throughput_channels):
        ref = golden_throughput_channel(spectra, n, r, f + 0.5, bw)
        w_tp = max(w_tp, close(streams[i], ref, f"throughput ch{i}"))
    log(f"phase 2 golden: {len(ours_pa)} burst + {len(ours_sd)} detection "
        f"events exact; odd ext_starts > 2048: {odd_high}; worst |err|/peak "
        f"burst {w_pa:.2e}, detection {w_sd:.2e}, 64 streams {w_tp:.2e}")
    check(len(ours_pa) >= 4 and len(ours_sd) >= 6, "weak scenario")
    return events


def phase_cli(cfg, x, events, tmp):
    """Phase 3: python -m fdc_tpu run (StreamDriver.run_file over the
    native ring) on the same capture, same events."""
    from fdc_tpu.__main__ import main

    cfg_path = os.path.join(tmp, "flagship.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    cap = os.path.join(tmp, "capture.c64")
    x.tofile(cap)
    ev_path = os.path.join(tmp, "events.jsonl")
    rc, clock = timed(main, ["run", cfg_path, cap, "--out-dir",
                          os.path.join(tmp, "out"), "--events-jsonl",
                          ev_path])
    check(rc == 0, f"run exited {rc}")
    with open(ev_path) as f:
        cli = [json.loads(s) for s in f]
    events_equal(cli, events, "CLI run vs process()")
    log(f"phase 3 CLI run (StreamDriver.run_file): {len(cli)} events "
        f"identical to phase 2, "
        f"{clock}")
    return cap


def vcm_config(cfg):
    """Four detection segments across the band, vcm semantics.

    Cells of 40 bins (minchandist 0.02): two noise-only cells then differ
    by the 6 dB threshold only at about six standard deviations, so no
    event rests on noise. No extraction-width cap below the block size:
    the reference (and its oracle) caps a channel only at the block."""
    return cfg.replace(
        throughput_channels=[],
        activity_controlled_channels=[],
        activity_detection_segments=[
            (-0.45, -0.3), (-0.1, 0.05), (0.2, 0.33), (0.41, 0.49),
        ],
        minchandist=0.02,
        max_extract_width=cfg.blocksize,
    )


def vcm_capture(cfg, rng, n_batches=2):
    inplen = cfg.inplen
    n_blocks = n_batches * cfg.batch_blocks
    n = n_blocks * inplen
    t = np.arange(n, dtype=np.float64)
    x = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for on, off, f, amp in ((20, 300, -0.4, 1.0), (100, 140, -0.05, 0.8),
                            (400, 900, 0.27, 0.9), (50, 700, 0.43, 0.7),
                            (600, 610, 0.46, 1.0)):
        g = np.zeros(n)
        g[on * inplen:off * inplen] = 1.0
        x += amp * g * np.exp(2j * np.pi * f * t)
    return x.astype(np.complex64)


def phase_vcm(cfg, rng, tmp):
    """Phase 4: python -m fdc_tpu vcm on a 4-segment config."""
    from golden import golden_activity_detection_vcm

    from fdc_tpu.__main__ import main

    vcfg = vcm_config(cfg)
    x = vcm_capture(vcfg, rng)
    cfg_path = os.path.join(tmp, "vcm.json")
    with open(cfg_path, "w") as f:
        f.write(vcfg.to_json())
    cap = os.path.join(tmp, "vcm.c64")
    x.tofile(cap)
    ev_path = os.path.join(tmp, "vcm.jsonl")
    rc, clock = timed(main, ["vcm", cfg_path, cap, "--events-jsonl",
                             ev_path])
    check(rc == 0, f"vcm exited {rc}")
    with open(ev_path) as f:
        cli = [json.loads(s) for s in f]
    segs = [(a + 0.5, b + 0.5) for a, b in vcfg.activity_detection_segments]
    ref = golden_activity_detection_vcm(
        golden_spectra(x, vcfg), vcfg.blocksize, vcfg.relinvovl, segs,
        vcfg.act_det_threshold, vcfg.minchandist, vcfg.minchanflankpuffer,
        vcfg.act_det_maxblocks, vcfg.act_det_deactivation_delay,
    )
    check(len(cli) == len(ref), f"vcm: {len(cli)} events vs golden "
          f"{len(ref)}")
    for sid in range(len(segs)):
        ours = [d for d in cli if f".DETECTED.{sid}." in d["ID"]]
        gold = [g for g in ref if g["seg_id"] == sid]
        check(len(ours) == len(gold), f"vcm segment {sid}: event count")
        for d, g in zip(ours, gold):
            for k in ("finalized", "blockstart", "blockend", "vectorstart",
                      "vectorend", "rel_cfreq", "rel_bw"):
                check(d[k] == g[k], f"vcm segment {sid}: {k}")
            check(d["nsamples"] == len(g["data"]), f"vcm seg {sid}: length")
            check(int(d["ID"].split(".")[-1]) == g["chan_id"],
                  f"vcm segment {sid}: channel id")
    check(len({g["seg_id"] for g in ref}) == 4, "vcm: a segment is silent")
    log(f"phase 4 vcm (4 segments): {len(cli)} events exact vs golden, "
        f"{clock}")


def phase_kernels(cfg, x):
    """Phase 5: each kernel vs its plain reference, bit-exact, at flagship
    widths on the card."""
    import jax
    import jax.numpy as jnp

    from fdc_tpu.models.channelizer import FrequencyDomainChannelizer
    from fdc_tpu.ops import detect
    from fdc_tpu.ops.fft import forward_spectrum
    from fdc_tpu.ops.framing import frame_blocks

    fdc = FrequencyDomainChannelizer(cfg)
    sd, pa = fdc.segments[0], fdc.power_bank
    check(sd._resolved_backend() == "pallas", "segment does not take the "
          "kernel on the GPU")

    @jax.jit
    def powers_of(hist, xb):
        blocks, hist = frame_blocks(xb, hist, cfg.blocksize)
        spec = forward_spectrum(blocks, use_mxu=cfg.use_mxu_fft)
        sq = jnp.abs(spec) ** 2
        return hist, sd.measure(spec, sq), pa.measure(spec, sq)

    def scan_pair(kernel, ref, inputs):
        outs_k, outs_r = [], []
        for args in inputs:
            outs_k.append(kernel(*args))
            outs_r.append(ref(*args))
        return outs_k, outs_r

    bs = fdc.batch_samples
    hist = jnp.zeros((cfg.ovllen,), jnp.complex64)
    seg_p, pa_p = [], []
    for b in range(N_BATCHES):
        hist, sp, pp = powers_of(hist, jnp.asarray(x[b * bs:(b + 1) * bs]))
        seg_p.append(sp)
        pa_p.append(pp)
    # churn: random carriers on every block (allocation, refresh, retire,
    # slot exhaustion), the worst case for the serial chain
    rng = np.random.default_rng(SEED + 5)
    nc = sd.geometry.n_cells
    churn = np.full((cfg.batch_blocks, nc), 1e-6)
    for _ in range(40):
        c0 = int(rng.integers(0, nc - 4))
        on = int(rng.integers(0, cfg.batch_blocks - 8))
        churn[on:on + int(rng.integers(1, 60)),
              c0:c0 + int(rng.integers(1, 4))] += 1.0 + rng.random()
    seg_p.append(jnp.asarray(churn, jnp.float32))

    def seg_run(backend):
        sd.lifecycle_backend = backend
        fn = jax.jit(sd.scan_slots)
        st = sd.init_state()
        outs = []
        for p in seg_p:
            st, flags = fn(p, st)
            outs.append((st, flags))
        return jax.device_get(outs)

    clock = Clock()
    got, ref = seg_run("pallas"), seg_run("scan")
    sd.lifecycle_backend = "auto"
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        check(np.array_equal(a, b), "lifecycle kernel != lax.scan")
    n_ev = int(sum(np.asarray(g[1][0]).sum() for g in got))

    def pa_run(backend):
        pa.lifecycle_backend = backend
        fn = jax.jit(pa.scan_flags)
        st = pa.init_state()
        outs = []
        for p in pa_p:
            st, flags = fn(p, st)
            outs.append((st, flags))
        return jax.device_get(outs)

    got, ref = pa_run("pallas"), pa_run("scan")
    pa.lifecycle_backend = "auto"
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        check(np.array_equal(a, b), "burst kernel != lax.scan")
    n_rise = int(sum(np.asarray(g[1][0]).sum() for g in got))

    edges = jax.jit(jax.vmap(
        lambda p: detect.detect_edges(p, sd.thresh, sd.k_detect)
    ))
    n_acc = 0
    for p in seg_p:
        cs, ce, hp = edges(p)
        a = np.asarray(detect._greedy_accept_pallas(cs, ce, hp))
        b = np.asarray(jax.jit(detect._greedy_accept_jnp)(cs, ce, hp))
        check(np.array_equal(a, b), "greedy kernel != jnp loop")
        n_acc += int(a.sum())
    log(f"phase 5 kernels bit-exact vs plain references over "
        f"{len(seg_p)} batches of {cfg.batch_blocks} blocks: lifecycle "
        f"({n_ev} activations), burst ({n_rise} rises), greedy acceptance "
        f"({n_acc} accepted); {clock}")


def phase_four_cards(cfg, rng):
    """Phase 6: sharded (2x2 time x chan mesh) and pipelined runs on four
    cards vs the one-card channelizer in the same process."""
    import jax

    from fdc_tpu.models.channelizer import FrequencyDomainChannelizer
    from fdc_tpu.parallel import PipelineChannelizer
    from fdc_tpu.parallel.mesh import make_mesh
    from fdc_tpu.parallel.sharded import ShardedChannelizer

    devs = jax.devices()
    check(len(devs) >= 4, f"--four-cards needs 4 devices, found {len(devs)}")
    devs = devs[:4]
    n_batches = 4
    x = flagship_capture(cfg, n_batches, rng)

    def run(ch):
        res, clock = timed(ch.process, x)
        tail = ch.flush()
        return res.events + tail.events, res.throughput, clock

    ev_ref, tp_ref, dt_ref = run(
        FrequencyDomainChannelizer(cfg)
    )
    mesh = make_mesh(n_time=2, n_chan=2, devices=devs)
    sh = ShardedChannelizer(cfg, mesh=mesh)
    ev_sh, tp_sh, dt_sh = run(sh)
    placed = {d for leaf in jax.tree.leaves(sh._carry)
              for d in leaf.devices()}
    check(len(placed) == 4, f"sharded carry on {len(placed)} devices")
    pipe = PipelineChannelizer(cfg, devices=devs, dedicated_owner=True)
    # the pipeline places its inputs and carries with jax.device_put:
    # record where those arrays actually land
    pipe_placed = set()
    device_put = jax.device_put

    def recording_put(*a, **kw):
        out = device_put(*a, **kw)
        for leaf in jax.tree.leaves(out):
            pipe_placed.update(leaf.devices())
        return out

    jax.device_put = recording_put
    try:
        ev_pp, tp_pp, dt_pp = run(pipe)
    finally:
        jax.device_put = device_put
    check(len(pipe_placed) == 4,
          f"pipeline arrays on {len(pipe_placed)} devices")
    worst = 0.0
    for name, ev, tp in (("sharded", ev_sh, tp_sh), ("pipeline", ev_pp,
                                                      tp_pp)):
        events_equal(ev, ev_ref, f"{name} vs one card")
        for a, b in zip(ev, ev_ref):
            worst = max(worst, close(a.data, b.data, f"{name} event data"))
        for i, (a, b) in enumerate(zip(tp, tp_ref)):
            worst = max(worst, close(a, b, f"{name} stream {i}"))
    log(f"phase 6 four cards: sharded 2x2 and pipeline (dedicated owner) "
        f"{len(ev_ref)} events equal to one card modulo ID prefix, streams "
        f"worst |err|/peak {worst:.2e}; one card {dt_ref}; sharded "
        f"{dt_sh}; pipeline {dt_pp}; "
        f"arrays on devices {sorted(d.id for d in placed)} (sharded), "
        f"{sorted(d.id for d in pipe_placed)} (pipeline)")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded/pipeline phase")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 1

    from __graft_entry__ import _flagship
    from fdc_tpu.runtime import native
    from fdc_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    dev = jax.devices()[0]
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}, device {dev.device_kind} x "
        f"{len(jax.devices())}, emission engine "
        f"{'native C++' if native.available() else 'Python'}, "
        f"compile cache {cache}")
    if not native.available():
        try:
            native._load()
        except native.NativeBuildError as e:
            log(f"native engine did not build: {str(e)[:600]}")
    log("phase 1 device: gpu ok")

    cfg = _flagship(batch_blocks=512)
    rng = np.random.default_rng(SEED)
    if args.four_cards:
        phase_four_cards(cfg, rng)
        count = 4
    else:
        t = time.perf_counter()
        x = flagship_capture(cfg, N_BATCHES, rng)
        spectra = golden_spectra(x, cfg)
        log(f"capture: {len(x)} complex samples ({N_BATCHES} batches) and "
            f"its golden spectra in {time.perf_counter() - t:.1f} s")
        events = phase_flagship(cfg, x, spectra)
        del spectra
        with tempfile.TemporaryDirectory() as tmp:
            phase_cli(cfg, x, events, tmp)
            phase_vcm(cfg, rng, tmp)
        phase_kernels(cfg, x)
        count = len(jax.devices())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
