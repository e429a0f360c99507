"""FrequencyDomainChannelizer — the top-level system.

The functional equivalent of the reference hier block
(reference: python/FrequencyDomainChannelizer.py:42-316): one shared
overlap-save FFT front-end feeding three channelization modes —

- throughput channels (always-on streams),
- power-activated burst channels (PDU/file emission),
- activity-detection segments with dynamic channel spawning.

Instead of wiring ~6 blocks per channel into a flowgraph, construction
solves all static geometry and builds ONE jitted step function
``(carry, samples) -> (carry, outputs)`` processing `batch_blocks` FFT
blocks at a time; a thin host driver (``process``) buffers arbitrary-length
sample arrays into batches and runs the host emission layer.

All host<->device traffic is float32 (complex64 viewed as [..., 2]), the
layout the host emitters consume (see fdc_tpu.utils.cplx).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from fdc_tpu.config import (
    ChannelizerConfig,
    VerboseMode,
    solve_segment,
    split_segment_geometry,
)
from fdc_tpu.models.power_activation import PowerActivationBank
from fdc_tpu.models.segment_detection import SegmentDetector, scan_slots_multi
from fdc_tpu.models.throughput import ThroughputChannelizer
from fdc_tpu.ops.extract import extract_bucket, extract_bucket_phased
from fdc_tpu.ops.framing import frame_blocks
from fdc_tpu.ops.fft import forward_spectrum
from fdc_tpu.runtime.emission import (
    PowerActivationEmitter,
    SegmentDetectionEmitter,
)
from fdc_tpu.utils.cplx import c2f, c2f_host, f2c, f2c_host
from fdc_tpu.utils.events import ChannelEvent, FileSink
from fdc_tpu.utils.logging import make_logger

__all__ = [
    "FrequencyDomainChannelizer",
    "ProcessResult",
    "finalize_rounds_bound",
]


def finalize_rounds_bound(segments, batch_blocks: int) -> int:
    """Upper bound on the end-of-stream silence batches a finalize pass
    may need: burst channels fall on the first silent block; detection
    slots age out after deactivation_delay + 1 silent blocks (plus one
    block for the emit itself). Bounded so a pathological state (e.g. a
    burst whose lastpower already sits at the FLT_MIN floor, which can
    never produce a falling ratio) cannot loop forever. Shared by
    ``flush(finalize=True)`` and the vcm CLI's end-of-stream pass — one
    formula, one place to change if the aging/emit semantics move."""
    max_delay = max((sd.deactivation_delay for sd in segments), default=0)
    return -(-(max_delay + 2) // batch_blocks) + 1


@dataclass
class ProcessResult:
    """Host-side result of processing a chunk of samples."""

    # per configured throughput channel: contiguous complex64 output stream
    throughput: List[np.ndarray] = field(default_factory=list)
    # burst / detection events in emission order (PDU equivalents)
    events: List[ChannelEvent] = field(default_factory=list)
    # [B_total, N] normalized spectra if debug=True (reference debug port,
    # python/FrequencyDomainChannelizer.py:152-158,314-315)
    debug_spectrum: Optional[np.ndarray] = None
    # [B_total, n_cells] decimated power per detection segment (waterfall feed)
    segment_power: List[np.ndarray] = field(default_factory=list)
    blocks_processed: int = 0


class FrequencyDomainChannelizer:
    """Parameter-compatible top-level channelizer.

    Construct from a :class:`ChannelizerConfig` (or its kwargs). Use
    ``process(samples)`` for the buffered streaming API, or drive the jitted
    ``device_step`` directly for custom loops / sharding.
    """

    def __init__(self, config: Optional[ChannelizerConfig] = None, **kwargs):
        if config is None:
            config = ChannelizerConfig(**kwargs)
        elif kwargs:
            config = config.replace(**kwargs)
        self.config = config
        cfg = config

        self.log = make_logger(cfg.verbose, "gr-FDC.FreqDomChan.log")

        # -- sub-models (static geometry solved here) -------------------------
        self.throughput: Optional[ThroughputChannelizer] = None
        tp_chans = cfg.fdc_throughput_channels()
        if tp_chans:
            self.throughput = ThroughputChannelizer(
                cfg.blocksize, cfg.relinvovl, tp_chans, cfg.windowtype,
                use_mxu=cfg.use_mxu_fft,
            )

        self.power_bank: Optional[PowerActivationBank] = None
        pa_chans = cfg.fdc_activity_controlled_channels()
        if pa_chans:
            self.power_bank = PowerActivationBank(
                cfg.blocksize, cfg.relinvovl, pa_chans,
                cfg.act_contr_threshold, use_mxu=cfg.use_mxu_fft,
            )

        self.segments: List[SegmentDetector] = []
        # split-part adjacency: expanded segment index -> (lower expanded
        # index | None, upper expanded index | None); drives the per-batch
        # cut reconciliation (SegmentDetector.reconcile_split)
        self._split_neighbors = {}
        splits = {idx: (n, ovl) for idx, n, ovl in cfg.segment_splits}
        for i, (a, b) in enumerate(cfg.fdc_activity_detection_segments()):
            # split segments expand into sub-segments on the parent's
            # decimation grid with overlapping scan margins
            # (config.split_segment_geometry) — each part is a full
            # SegmentDetector with its own slot table, scan automaton and
            # emitter, taking the next sequential segment id (exactly as
            # if the config listed the parts as separate segments)
            if i in splits:
                n_parts, ovl = splits[i]
                parent = solve_segment(
                    cfg.blocksize, a, b, cfg.fdc_minchandist()
                )
                geoms = split_segment_geometry(parent, n_parts, ovl)
            else:
                geoms = [(None, None)]
            base = len(self.segments)
            if len(geoms) > 1:
                for p in range(len(geoms)):
                    self._split_neighbors[base + p] = (
                        base + p - 1 if p > 0 else None,
                        base + p + 1 if p + 1 < len(geoms) else None,
                    )
            for geom, core in geoms:
                self.segments.append(
                    SegmentDetector(
                        len(self.segments),
                        cfg.blocksize,
                        cfg.relinvovl,
                        a,
                        b,
                        cfg.act_det_threshold,
                        cfg.fdc_minchandist(),
                        cfg.minchanflankpuffer
                        if cfg.minchanflankpuffer >= 0 else 0.2,
                        cfg.act_det_deactivation_delay
                        if cfg.act_det_deactivation_delay >= 0
                        else 0,
                        cfg.max_slots,
                        cfg.max_candidates,
                        cfg.max_extract_width,
                        geometry=geom,
                        extract_budget=cfg.extract_budget,
                        use_mxu=cfg.use_mxu_fft,
                        extract_width_split=cfg.extract_width_split,
                        extract_budget_narrow=cfg.extract_budget_narrow,
                        core_bins=core,
                    )
                )

        # -- per-component lifecycle loggers -----------------------------------
        # The reference gives each detection/burst block its own log file
        # with fixed names and logs every emission's lifecycle line
        # (reference: lib/SegmentDetection_impl.cc:49-57,474-481,
        # lib/PowerActivationChannel_impl.cc:52-60,245-253). None when
        # verbose is off — the emitters skip line formatting entirely.
        verbose_on = cfg.verbose != VerboseMode.NOLOG
        seg_logs = []
        for i, sd in enumerate(self.segments):
            lg = None
            if verbose_on:
                lg = make_logger(cfg.verbose, f"gr-FDC.ActDetChan.ID_{i}.log")
                g = sd.geometry
                # constructor banner (reference: lib/SegmentDetection_impl.cc:109-113)
                lg(f"Threshold               {sd.thresh:g}")
                lg(f"decimation factor       {g.decimation}")
                lg(f"start                   {g.start}")
                lg(f"stop                    {g.stop}")
                lg(f"width                   {g.width}")
            seg_logs.append(lg)
        pa_logs = None
        if self.power_bank and verbose_on:
            pa_logs = []
            for c, g in enumerate(self.power_bank.geometry):
                lg = make_logger(cfg.verbose, f"gr-FDC.PowActChan.{c}.log")
                # constructor banner (reference: lib/PowerActivationChannel_impl.cc:112-123,
                # including its doubled header)
                s0 = "############################\n\n"
                lg(
                    s0 + f"# gr-FDC.PowActChan.{c}\n\n" + s0
                    + f"# extract_start: {g.extract_start}\n"
                    + f"# extract_stop: {g.extract_stop}\n"
                    + f"# extract_width: {g.extract_width}\n"
                    + f"# measure_start: {g.measure_start}\n"
                    + f"# measure_stop: {g.measure_stop}\n\n"
                    + "# equivalent cfreq: "
                    + f"{(g.extract_start + g.extract_width / 2) / cfg.blocksize:.6f}\n"
                    + f"# equivalent bw: {g.extract_width / cfg.blocksize:.6f}\n"
                )
                pa_logs.append(lg)

        # -- host emission layer ----------------------------------------------
        sink = FileSink(cfg.outputpath, self.log) if cfg.fileoutput else None
        use_native = cfg.native_emission
        if use_native == "auto":
            from fdc_tpu.runtime import native

            use_native = native.available()
        if use_native:
            from fdc_tpu.runtime.emission import (
                NativePowerActivationEmitter,
                NativeSegmentDetectionEmitter,
            )

            pa_cls, sd_cls = (
                NativePowerActivationEmitter,
                NativeSegmentDetectionEmitter,
            )
        else:
            pa_cls, sd_cls = PowerActivationEmitter, SegmentDetectionEmitter
        self.power_emitter = (
            pa_cls(self.power_bank, cfg.pow_act_maxblocks, sink,
                   cfg.msgoutput, channel_logs=pa_logs)
            if self.power_bank
            else None
        )
        self.segment_emitters = [
            sd_cls(sd, cfg.act_det_maxblocks, sink, cfg.msgoutput,
                   log=seg_logs[i])
            for i, sd in enumerate(self.segments)
        ]

        # -- fused extraction plan ---------------------------------------------
        # throughput + burst channels sharing an FFT width extract as ONE
        # bucketed slice-window-IFFT pass (fewer kernel chains per step)
        self._fused_widths = {}
        if self.throughput and self.power_bank:
            tp_by_w = {b.width: b for b in self.throughput.buckets}
            pa_by_w = {b.width: b for b in self.power_bank.buckets}
            for w in set(tp_by_w) & set(pa_by_w):
                tb, pb = tp_by_w[w], pa_by_w[w]
                starts = np.concatenate([tb.starts, pb.starts])
                # gain folds into the (linear) window
                wins = np.concatenate(
                    [tb.windows * np.float32(w), pb.windows]
                )
                self._fused_widths[w] = (
                    starts, wins, len(tb.channel_ids), tb, pb
                )

        # -- streaming state ---------------------------------------------------
        self._carry = None
        self._t0 = 0  # global index of next block
        self._pending = np.zeros(0, np.complex64)  # host sample buffer
        # pre-FFT'd vector-mode buffer (process_spectra remainders)
        self._pending_spec = np.zeros((0, cfg.blocksize), np.complex64)
        self._spectra_mode = False  # which silence flavor flush() feeds
        self._samples_mode = False  # process() has been used on this stream

        self._jit_step = jax.jit(self._device_step)
        self._jit_step_spectra = jax.jit(self._device_step_spectra)
        self._jit_init = jax.jit(self._device_init)

        if cfg.verbose:
            self.log("# fdc_tpu FrequencyDomainChannelizer")
            self.log(f"Blocksize     = {cfg.blocksize}")
            self.log(f"Relinvovl     = {cfg.relinvovl}")
            self.log(f"Ovllen        = {cfg.ovllen}")
            self.log(f"BatchBlocks   = {cfg.batch_blocks}")
            self.log(f"Throughput channels:         {cfg.throughput_channels}")
            self.log(f"Activity control channels:   {cfg.activity_controlled_channels}")
            self.log(f"Activity detection segments: {cfg.activity_detection_segments}")

    # -- device functions -------------------------------------------------------

    def _device_init(self):
        cfg = self.config
        carry = {
            "hist": jnp.zeros((cfg.ovllen,), jnp.complex64),
            "prev_spec": jnp.zeros((cfg.blocksize,), jnp.complex64),
        }
        if self.power_bank:
            carry["powact"] = self.power_bank.init_state()
        for i, sd in enumerate(self.segments):
            carry[f"seg{i}"] = sd.init_state()
        return carry

    def _device_step(self, carry, xf, t0):
        """One jitted step over B = len(x)//inplen blocks.

        xf: [B*inplen, 2] float32 (complex64 pairs); t0: traced int32 global
        index of the first block. Returns (carry, out) where all complex
        leaves of `out` are float32 [..., 2].
        """
        cfg = self.config
        x = f2c(xf)
        blocks, hist = frame_blocks(x, carry["hist"], cfg.blocksize)
        spec = forward_spectrum(blocks, use_mxu=cfg.use_mxu_fft)  # [B, N]
        new_carry = dict(carry)
        new_carry["hist"] = hist
        return self._step_from_spec(new_carry, spec, t0)

    def _device_step_spectra(self, carry, specf, t0):
        """Pre-FFT'd entry point (the reference's inpveclen>1 mode,
        reference: python/FrequencyDomainChannelizer.py:201-216): specf is
        [B, N, 2] float32 — already normalized fftshifted spectra."""
        return self._step_from_spec(dict(carry), f2c(specf), t0)

    def _step_from_spec(self, new_carry, spec, t0):
        cfg = self.config
        spec_ext = jnp.concatenate([new_carry["prev_spec"][None], spec])
        new_carry["prev_spec"] = spec[-1]

        out, pa_powers, pa_ext, seg_powers, seg_packed = (
            self._extract_static(spec, spec_ext, t0)
        )
        scans = self._scan_detections(new_carry, pa_powers, seg_packed)
        self._finish_detections(out, scans, spec_ext, pa_ext, seg_powers)
        if cfg.debug:
            out["debug_spectrum"] = c2f(spec)
        return new_carry, out

    def _extract_static(self, spec, spec_ext, t0):
        """Everything in the step that does NOT depend on detection state:
        throughput/burst extraction and the detection power measures.

        Split out so the pipeline driver (parallel/pipeline.py) can run
        this stage on a worker device while the scan owner runs ahead;
        the plain step composes the three stages under one jit (same
        traced graph as before the split). Returns (out, pa_powers,
        pa_ext, seg_powers, seg_packed) — the powers and pre-packed
        candidate rows are the tiny inputs the scans consume (candidate
        detection is per-block independent and slot-table-free, so it
        belongs HERE, off the sequential stage).
        """
        cfg = self.config
        out = {}
        # fused extraction: throughput + burst channels of equal width run
        # as one bucketed slice-window-IFFT over spec_ext. pairs=True:
        # the matmul-DFT emits the [..., 2] float-pair host layout
        # directly (interleaved matrix columns) — no complexify/c2f pass
        # ever touches the (large) extraction outputs.
        fused_mats = {}
        fused_pa_ext = {}
        for w, (starts, wins, n_tp, tb, pb) in self._fused_widths.items():
            # tp and pa share the same overlap trim (out_len = w - w//R on
            # both sides), so the fused bucket trims uniformly at extraction
            y = extract_bucket(
                spec_ext, starts, wins,
                use_mxu=cfg.use_mxu_fft, keep_from=w - pb.out_len,
                pairs=True,
            )  # [C_tp + C_pa, B+1, out_len, 2]
            fused_mats[w] = self.throughput.finish_bucket(
                tb, y[:n_tp, 1:], t0, pairs=True
            )
            fused_pa_ext[w] = y[n_tp:]

        if self.throughput:
            # one [C_l, B*out_len, 2] matrix per bucket (the host splits
            # rows; device-side per-channel splitting costs a kernel per
            # channel)
            # t0 is always a whole number of batches (self._t0 += B), so
            # with B % R == 0 the per-row phase pattern is static
            # (extract_bucket_phased)
            fold_phase = cfg.batch_blocks % cfg.relinvovl == 0
            mats = []
            for bucket in self.throughput.buckets:
                if bucket.width in self._fused_widths:
                    mats.append(fused_mats[bucket.width])
                    continue
                if fold_phase:
                    y = extract_bucket_phased(
                        spec, bucket.starts, bucket.windows,
                        cfg.relinvovl, gain=float(bucket.width),
                        use_mxu=cfg.use_mxu_fft,
                        keep_from=bucket.width - bucket.out_len,
                    )
                    mats.append(
                        self.throughput.finish_bucket(
                            bucket, y, t0, pairs=True, prephased=True
                        )
                    )
                    continue
                y = extract_bucket(
                    spec, bucket.starts,
                    bucket.windows, gain=float(bucket.width),
                    use_mxu=cfg.use_mxu_fft,
                    keep_from=bucket.width - bucket.out_len, pairs=True,
                )
                mats.append(
                    self.throughput.finish_bucket(bucket, y, t0, pairs=True)
                )
            out["throughput_buckets"] = mats
        # one shared |X|^2 pass feeds every detection consumer
        sq = (
            jnp.abs(spec) ** 2 if (self.power_bank or self.segments)
            else None
        )
        pa_powers = None
        pa_ext = None
        if self.power_bank:
            pa = self.power_bank
            pa_powers = pa.measure(spec, sq)
            # burst-channel extraction is flag-INDEPENDENT (all configured
            # channels are extracted every step; the flags only select what
            # the host emits) — it belongs to the static stage
            pa_ext = dict(fused_pa_ext)
            for bucket in pa.buckets:
                if bucket.width in pa_ext:
                    continue
                y = extract_bucket(
                    spec_ext, bucket.starts,
                    bucket.windows, use_mxu=cfg.use_mxu_fft,
                    keep_from=bucket.width - bucket.out_len, pairs=True,
                )
                pa_ext[bucket.width] = y
        seg_powers = [sd.measure(spec, sq) for sd in self.segments]
        seg_packed = [
            sd._packed_candidates(p)[0]
            for sd, p in zip(self.segments, seg_powers)
        ]
        return out, pa_powers, pa_ext, seg_powers, seg_packed

    def _scan_detections(self, carry_io, pa_powers, seg_packed):
        """The sequential detection logic: burst hysteresis + slot
        lifecycle scans + extraction plans, all on tiny [B, C]-scale
        inputs. Updates ``carry_io`` in place; returns the flags/plans
        pytree. This is the pipeline's serial stage — it depends only on
        the power matrices / pre-packed candidate rows and its own carry,
        never on the extraction outputs."""
        scans = {}
        seg_killed = self._reconcile_splits(
            carry_io, seg_packed,
            {i: carry_io[f"seg{i}"] for i in self._split_neighbors},
        )
        # all segments' lifecycle scans run as one kernel launch (one
        # program per segment) on the kernel backend, plus the burst
        # hysteresis automaton
        if self.power_bank and self.segments:
            seg_scans, pa_result = scan_slots_multi(
                self.segments, [None] * len(self.segments),
                [carry_io[f"seg{i}"] for i in range(len(self.segments))],
                packed_list=seg_packed,
                powact=(self.power_bank, pa_powers, carry_io["powact"]),
            )
            carry_io["powact"], flags = pa_result
            scans["powact"] = flags
        else:
            if self.power_bank:
                carry_io["powact"], flags = self.power_bank.scan_flags(
                    pa_powers, carry_io["powact"]
                )
                scans["powact"] = flags
            seg_scans = scan_slots_multi(
                self.segments, [None] * len(self.segments),
                [carry_io[f"seg{i}"] for i in range(len(self.segments))],
                packed_list=seg_packed,
            )
        segs = []
        for i, sd in enumerate(self.segments):
            seg_state, flags = seg_scans[i]
            carry_io[f"seg{i}"] = seg_state
            so = self._seg_scan_outputs(sd, seg_state, flags)
            if i in seg_killed:
                so["killed"] = seg_killed[i]
            segs.append((seg_state, so))
        scans["segs"] = segs
        return scans

    def _reconcile_splits(self, carry_io, seg_packed, entry_states):
        """Pre-scan cut reconciliation for split segments
        (SegmentDetector.reconcile_split): kills duplicate slots at the
        cuts (lower part wins) and suppresses candidates tracked by a
        neighbor, both against ``entry_states`` — the batch-entry
        snapshot, i.e. every part's state at the END OF THE PREVIOUS
        BATCH. Mutates ``carry_io`` (killed slots freed) and
        ``seg_packed`` (suppressed packs re-compacted) in place; returns
        {seg_index: killed [S] bool} for the host emitters."""
        seg_killed = {}
        for i, (lo, hi) in self._split_neighbors.items():
            sd = self.segments[i]
            kill_from = []
            if lo is not None:
                kill_from.append(
                    SegmentDetector.split_foreign_view(entry_states[lo])
                )
            suppress_from = list(kill_from)
            if hi is not None:
                suppress_from.append(
                    SegmentDetector.split_foreign_view(entry_states[hi])
                )
            st, pk, killed = sd.reconcile_split(
                entry_states[i], seg_packed[i], kill_from, suppress_from
            )
            carry_io[f"seg{i}"] = st
            seg_packed[i] = pk
            seg_killed[i] = killed
        return seg_killed

    @staticmethod
    def _seg_scan_outputs(sd, seg_state, flags):
        """Assemble one segment's scan-stage outputs (flags in host layout,
        slot_meta snapshot, compaction plan) from its lifecycle scan
        result. Shared by _scan_detections and the pipeline's multi-owner
        scan dispatch (parallel/pipeline.py) so the two cannot drift."""
        got, processed, emit_now, phase_used = flags
        so = {
            "activated": got.T,
            "processed": processed.T,
            "emit": emit_now.T,
            "phase_used": phase_used.T,
            "slot_meta": {
                "ext_start": seg_state["ext_start"],
                "wlog2": seg_state["wlog2"],
                "order": seg_state["order"],
            },
        }
        if sd.extract_width_split:
            ids_n, ids_w, overflow = sd.extract_plan_split(
                got, processed, seg_state["wlog2"]
            )
            so["slot_ids"] = ids_w
            so["slot_ids_narrow"] = ids_n
            so["ext_overflow"] = overflow
        else:
            slot_ids, overflow = sd.extract_plan(got, processed)
            so["slot_ids"] = slot_ids
            so["ext_overflow"] = overflow
        return so

    def _extract_slots_all(self, spec_ext, seg_states, plans):
        """Detection-slot extraction for every segment, given the scan's
        slot tables and compaction plans (the pipeline's third stage —
        the only extraction that depends on detection state)."""
        outs = []
        for sd, seg_state, plan in zip(self.segments, seg_states, plans):
            eo = {
                "extract": sd.extract_slots(
                    spec_ext, seg_state, plan["slot_ids"], pairs=True
                )
            }
            if sd.extract_width_split:
                eo["extract_narrow"] = sd.extract_slots(
                    spec_ext, seg_state, plan["slot_ids_narrow"],
                    width=sd.extract_width_split, pairs=True,
                )
            outs.append(eo)
        return outs

    def _finish_detections(self, out, scans, spec_ext, pa_ext, seg_powers):
        """Assemble the detection outputs from the three stages' pieces."""
        if self.power_bank:
            rise, fall, processed, phase_used = scans["powact"]
            out["powact"] = {
                "rise": rise,
                "fall": fall,
                "processed": processed,
                "phase_used": phase_used,
                "extract": pa_ext,
            }
        seg_states = [st for st, _ in scans["segs"]]
        plans = [so for _, so in scans["segs"]]
        extracts = self._extract_slots_all(spec_ext, seg_states, plans)
        for i, (st_so, eo, power) in enumerate(
            zip(scans["segs"], extracts, seg_powers)
        ):
            _, so = st_so
            so = dict(so)
            so.update(eo)
            so["power"] = power
            out[f"seg{i}"] = so

    # -- host streaming API ------------------------------------------------------

    @property
    def batch_samples(self) -> int:
        return self.config.batch_blocks * self.config.inplen

    def _new_result(self) -> "ProcessResult":
        """Empty ProcessResult shell with per-channel/segment slots sized
        for this config (shared by the streaming drivers here and in
        parallel/pipeline.py)."""
        return ProcessResult(
            throughput=[
                np.zeros(0, np.complex64)
                for _ in range(
                    self.throughput.num_channels if self.throughput else 0
                )
            ],
            segment_power=[
                np.zeros((0, sd.geometry.n_cells), np.float32)
                for sd in self.segments
            ],
        )

    def reset(self):
        self._carry = None
        self._t0 = 0
        self._pending = np.zeros(0, np.complex64)
        self._pending_spec = np.zeros(
            (0, self.config.blocksize), np.complex64
        )
        self._spectra_mode = False
        self._samples_mode = False

    def _host_extra_state(self) -> dict:
        """Checkpoint hook: subclass-owned host state to snapshot (the
        pipeline driver's framing tail lives here). Base: nothing."""
        return {}

    def _restore_host_extra_state(self, extra: dict):
        """Checkpoint hook: restore what :meth:`_host_extra_state` saved
        (called after the carry/emitter state is in place)."""

    def process(self, samples: np.ndarray) -> ProcessResult:
        """Buffered streaming entry point.

        Accepts any-length complex64 sample arrays; whole batches are
        processed, the remainder is buffered for the next call (the
        stream_to_vector equivalent).
        """
        cfg = self.config
        if self._spectra_mode:
            # mixing the two entry points on one stream is documented
            # unsupported (the sample front-end and its history are
            # bypassed in vector mode); failing loudly here keeps a
            # mixed-mode checkpoint from silently corrupting resume
            # (the pipeline driver's host framing state is per-mode)
            raise RuntimeError(
                "process() called on a stream already driven by "
                "process_spectra(); use one entry point per stream "
                "(reset() starts a new one)"
            )
        self._samples_mode = True
        if self._carry is None:
            self._carry = self._jit_init()

        x = np.concatenate([self._pending, np.asarray(samples, np.complex64)])
        bs = self.batch_samples
        n_batches = len(x) // bs
        self._pending = x[n_batches * bs :]

        result = self._new_result()
        dbg = []
        for i in range(n_batches):
            chunk = x[i * bs : (i + 1) * bs]
            self._carry, out = self._jit_step(
                self._carry,
                jnp.asarray(c2f_host(chunk)),
                jnp.int32(self._t0),
            )
            self._consume_outputs(out, result, dbg)
            self._t0 += cfg.batch_blocks
            result.blocks_processed += cfg.batch_blocks

        if dbg:
            result.debug_spectrum = np.concatenate(dbg)
        return result

    def flush(self, finalize: bool = True) -> ProcessResult:
        """End-of-stream: process the buffered sample remainder and (by
        default) finalize still-open bursts.

        ``process`` only runs whole device batches, so a finite capture
        leaves up to ``batch_samples - 1`` samples buffered forever (the
        reference has the same property at FFT-block granularity — a
        tail shorter than one input vector is never processed). flush
        zero-pads the remainder up to one whole batch, runs it, and trims
        the stream outputs back to the blocks that contain real samples.
        The zero padding drives in-band power to zero, so open bursts see
        a falling edge and finalize — emitted events may carry block
        spans extending into the padded region, exactly as if the
        capture ended in silence.

        With ``finalize`` (the default), flush then keeps feeding whole
        batches of silence until every burst channel and detection slot
        has deactivated, so the emitted EVENT SET does not depend on the
        capture length mod batch_blocks: a capture ending exactly on a
        batch boundary finalizes identically to a ragged one (the
        historic contract left its bursts open). Silence-only batches contribute nothing to streams,
        segment_power, or blocks_processed. ``finalize=False`` restores
        the tail-only behavior (what the reference does at flowgraph
        stop). Idempotent: a second flush with nothing buffered and no
        open bursts returns an empty result.
        """
        cfg = self.config
        n_pend = len(self._pending)
        n_pend_spec = len(self._pending_spec)
        if n_pend == 0 and n_pend_spec == 0:
            res = ProcessResult(
                throughput=[
                    np.zeros(0, np.complex64)
                    for _ in range(
                        self.throughput.num_channels if self.throughput
                        else 0
                    )
                ],
                segment_power=[
                    np.zeros((0, sd.geometry.n_cells), np.float32)
                    for sd in self.segments
                ],
                # with debug on, every returned result carries an array
                # (possibly 0 rows) — a finalize-only flush reaching an
                # on_result consumer must not surprise it with None
                debug_spectrum=(
                    np.zeros((0, cfg.blocksize), np.complex64)
                    if cfg.debug else None
                ),
            )
        else:
            if n_pend_spec:
                # vector mode: pad the buffered spectrum rows with silence
                # rows up to one batch (zero spectra == zero in-band power)
                n_real = n_pend_spec
                res = self.process_spectra(
                    np.zeros(
                        (cfg.batch_blocks - n_pend_spec, cfg.blocksize),
                        np.complex64,
                    )
                )
            else:
                n_real = -(-n_pend // cfg.inplen)  # blocks w/ real samples
                res = self.process(
                    np.zeros(self.batch_samples - n_pend, np.complex64)
                )
            if self.throughput:
                for bucket in self.throughput.buckets:
                    for chan in bucket.channel_ids:
                        res.throughput[chan] = res.throughput[chan][
                            : n_real * bucket.out_len
                        ]
            if res.debug_spectrum is not None:
                res.debug_spectrum = res.debug_spectrum[:n_real]
            res.segment_power = [p[:n_real] for p in res.segment_power]
            res.blocks_processed = n_real
        if finalize:
            for _ in range(self._finalize_rounds()):
                if not self._open_bursts():
                    break
                res.events.extend(self._feed_silence().events)
        return res

    def _feed_silence(self) -> ProcessResult:
        """One whole batch of end-of-stream silence, in the flavor of the
        stream mode in use (zero samples through the front-end, or zero
        spectrum rows in the pre-FFT'd vector mode)."""
        cfg = self.config
        if self._spectra_mode:
            return self.process_spectra(
                np.zeros((cfg.batch_blocks, cfg.blocksize), np.complex64)
            )
        return self.process(np.zeros(self.batch_samples, np.complex64))

    def _finalize_rounds(self) -> int:
        if not (self.power_bank or self.segments):
            return 0
        return finalize_rounds_bound(self.segments, self.config.batch_blocks)

    def _open_bursts(self) -> bool:
        """Any burst channel or detection slot still active on device."""
        if self._carry is None:
            return False
        c = self._carry
        if self.power_bank and bool(
            np.any(np.asarray(c["powact"]["active"]))
        ):
            return True
        for i in range(len(self.segments)):
            if bool(np.any(np.asarray(c[f"seg{i}"]["active"]))):
                return True
        return False

    def process_spectra(self, spectra: np.ndarray) -> ProcessResult:
        """Pre-FFT'd streaming entry point (reference inpveclen>1 mode):
        consumes [B, blocksize] normalized fftshifted complex spectra
        directly, for any B — whole batches are processed, the row
        remainder is buffered for the next call (the reference's
        vector-input mode likewise consumes any number of input vectors,
        reference: python/FrequencyDomainChannelizer.py:201-216).

        Use either this or ``process`` for a given stream, not both: in
        this mode the overlap-save front-end (and its sample history) is
        bypassed entirely. ``flush()`` pads and trims a buffered spectra
        remainder the same way it pads a sample tail.

        On a ShardedChannelizer this path runs the sharded shard_map
        step (spectrum rows time-sharded, prev-spec ppermute handoff;
        results identical, pinned by tests/test_parallel.py)."""
        cfg = self.config
        if self._samples_mode:
            raise RuntimeError(
                "process_spectra() called on a stream already driven by "
                "process(); use one entry point per stream (reset() "
                "starts a new one)"
            )
        if self._carry is None:
            self._carry = self._jit_init()
        self._spectra_mode = True
        spectra = np.ascontiguousarray(spectra, np.complex64)
        if spectra.ndim != 2 or spectra.shape[1] != cfg.blocksize:
            raise ValueError(
                f"spectra must be [B, {cfg.blocksize}], got {spectra.shape}"
            )
        if len(self._pending_spec):
            spectra = np.concatenate([self._pending_spec, spectra])
        bb = cfg.batch_blocks
        n_batches = spectra.shape[0] // bb
        self._pending_spec = spectra[n_batches * bb:]
        result = self._new_result()
        dbg = []
        for i in range(n_batches):
            chunk = spectra[i * bb: (i + 1) * bb]
            self._carry, out = self._jit_step_spectra(
                self._carry,
                jnp.asarray(c2f_host(chunk)),
                jnp.int32(self._t0),
            )
            self._consume_outputs(out, result, dbg)
            self._t0 += bb
            result.blocks_processed += bb
        if dbg:
            result.debug_spectrum = np.concatenate(dbg)
        return result

    def _consume_outputs(self, out, result: ProcessResult, dbg: list,
                         t0: int = None):
        # t0 defaults to the streaming cursor; the pipeline driver passes
        # each batch's own t0 because it consumes outputs deferred
        t0 = self._t0 if t0 is None else t0
        if self.throughput:
            for bucket, mat in zip(
                self.throughput.buckets, out["throughput_buckets"]
            ):
                m = f2c_host(np.asarray(mat))  # [C_l, B*out_len]
                for row, chan in enumerate(bucket.channel_ids):
                    result.throughput[chan] = np.concatenate(
                        [result.throughput[chan], m[row]]
                    )
        if self.power_bank:
            po = jax.tree.map(np.asarray, out["powact"])
            po["extract"] = {
                w: f2c_host(v) for w, v in po["extract"].items()
            }
            result.events.extend(self.power_emitter.process_step(po, t0))
        for i in range(len(self.segments)):
            so = jax.tree.map(np.asarray, out[f"seg{i}"])
            so["extract"] = f2c_host(so["extract"])
            if "extract_narrow" in so:
                so["extract_narrow"] = f2c_host(so["extract_narrow"])
            # slot recycling happens ON DEVICE at step end
            # (SegmentDetector._free_tombstones) — the emitter reads slot
            # geometry from the slot_meta outputs, the carry never crosses
            # to the host.
            events = self.segment_emitters[i].process_step(
                so, so["slot_meta"], t0
            )
            result.events.extend(events)
            result.segment_power[i] = np.concatenate(
                [result.segment_power[i], so["power"]]
            )
        if self.config.debug and "debug_spectrum" in out:
            dbg.append(f2c_host(np.asarray(out["debug_spectrum"])))
