"""Multi-segment activity-detection channelizer.

JAX rebuild of activity_detection_channelizer_vcm
(reference: lib/activity_detection_channelizer_vcm_impl.cc): several
detection segments sharing one FFT-block stream, one threshold, one
decimation factor and one window table. The reference fans segments out as
std::threads per block (reference:
lib/activity_detection_channelizer_vcm_impl.cc:293-304); here each segment
is an independent batched SegmentDetector sub-graph inside one jitted step —
XLA schedules them concurrently, and the parallel layer can shard them over
a mesh `chan` axis.

Detection math per segment runs with vcm=True SegmentDetector semantics:
the reference's 1/decimation power normalization
(lib/activity_detection_channelizer_vcm_impl.cc:630-650), its FLT_MIN
zero-denominator edge ratios (:701-705 — 0/0 is a falling edge, unlike
SegmentDetection), its blockcount-from-1 convention (:188), and its inline
per-channel maxblocks partial emission (:305-321); segment geometry uses the
vcm rounding rules (config.solve_segment_vcm). Parity is pinned by a
vcm-specific sequential golden replay (tests/golden.py
golden_activity_detection_vcm).
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from fdc_tpu.config import solve_segment_vcm
from fdc_tpu.models.segment_detection import SegmentDetector
from fdc_tpu.utils.cplx import c2f, c2f_host, f2c, f2c_host

__all__ = ["ActivityDetectionChannelizer"]


class ActivityDetectionChannelizer:
    """Bank of detection segments with shared configuration.

    Mirrors the reference constructor parameter set
    (reference: include/FDC/activity_detection_channelizer_vcm.h make(...)):
    blocklen, segments [[start, stop] in FDC coords], thresh (dB), relinvovl,
    minchandist, channel_deactivation_delay, window_flank_puffer.
    """

    def __init__(
        self,
        blocklen: int,
        segments,  # [[start, stop]] in FDC [0,1) coordinates
        thresh_db: float,
        relinvovl: int,
        minchandist: float,
        channel_deactivation_delay: int = 1,
        window_flank_puffer: float = 0.2,
        max_slots: int = 32,
        max_candidates: int = 0,
        max_extract_width: int = 0,
        verbose=0,
        extract_budget: int = 0,
        extract_width_split: int = 0,
        extract_budget_narrow: int = 0,
    ):
        if blocklen < 2 or blocklen & (blocklen - 1):
            raise ValueError("Blocklen invalid (must be a power of 2 >= 2)")
        self.blocklen = blocklen
        # lifecycle log: one shared file for all segments, like the
        # reference vcm block (reference:
        # lib/activity_detection_channelizer_vcm_impl.cc:88-100)
        from fdc_tpu.config import VerboseMode
        from fdc_tpu.utils.logging import make_logger

        self.log = (
            make_logger(verbose, "gr-FDC.ActDetChan.log")
            if VerboseMode(verbose) != VerboseMode.NOLOG
            else None
        )
        self.segments: List[SegmentDetector] = []
        for i, (a, b) in enumerate(segments):
            geo = solve_segment_vcm(blocklen, float(a), float(b), minchandist)
            self.segments.append(
                SegmentDetector(
                    i,
                    blocklen,
                    relinvovl,
                    float(a),
                    float(b),
                    thresh_db,
                    minchandist,
                    window_flank_puffer,
                    channel_deactivation_delay,
                    max_slots,
                    max_candidates,
                    max_extract_width,
                    geometry=geo,
                    vcm=True,
                    extract_budget=extract_budget,
                    extract_width_split=extract_width_split,
                    extract_budget_narrow=extract_budget_narrow,
                )
            )
            if self.log is not None:
                # per-segment banner (reference:
                # lib/activity_detection_channelizer_vcm_impl.cc:177-185)
                self.log(
                    f"# Segment {i}: \n"
                    f"# start: {geo.start} => "
                    f"f_start={geo.start / blocklen:g}\n"
                    f"# stop: {geo.stop} => f_stop={geo.stop / blocklen:g}\n"
                    f"# width: {geo.width} => "
                    f"f_bw={geo.width / blocklen:g}\n"
                    f"# chan_decimation_fact: {geo.decimation}\n"
                )

    def init_state(self):
        return [sd.init_state() for sd in self.segments]

    def step(self, spec_ext: jax.Array, states):
        """Run all segments over one [B+1, N] spectrum batch.

        Returns (new_states, outputs) as parallel lists — each entry the
        corresponding SegmentDetector's result.
        """
        new_states, outs = [], []
        for sd, st in zip(self.segments, states):
            ns, o = sd.step(spec_ext, st)
            new_states.append(ns)
            outs.append(o)
        return new_states, outs

    # -- host streaming API (vector-in, message-out like the reference block,
    # reference: grc/FDC_activity_detection_channelizer_vcm.xml io signature) --

    def make_runner(
        self,
        maxblocks: int = 256,
        file_sink=None,
        msg_output: bool = True,
        native_emission="auto",
    ) -> "ActivityDetectionRunner":
        return ActivityDetectionRunner(
            self, maxblocks, file_sink, msg_output, native_emission
        )


class ActivityDetectionRunner:
    """Host driver for ActivityDetectionChannelizer: consumes batches of
    pre-FFT'd (normalized, fftshifted) spectrum vectors, emits ChannelEvents.

    The functional equivalent of feeding the reference vcm block a stream of
    FFT vectors and reading its msgout port
    (reference: lib/activity_detection_channelizer_vcm_impl.cc:542-576)."""

    def __init__(self, adc: ActivityDetectionChannelizer, maxblocks: int,
                 file_sink, msg_output: bool, native_emission="auto"):
        from fdc_tpu.runtime.emission import SegmentDetectionEmitter

        use_native = native_emission
        if use_native == "auto":
            from fdc_tpu.runtime import native

            use_native = native.available()
        if use_native:
            from fdc_tpu.runtime.emission import (
                NativeSegmentDetectionEmitter as emitter_cls,
            )
        else:
            emitter_cls = SegmentDetectionEmitter

        self.adc = adc
        self.emitters = [
            emitter_cls(sd, maxblocks, file_sink, msg_output, log=adc.log)
            for sd in adc.segments
        ]
        self._carry = None
        self._t0 = 0
        self._jit_step = jax.jit(self._device_step)
        self._jit_init = jax.jit(self._device_init)

    def _device_init(self):
        return {
            "prev_spec": jnp.zeros((self.adc.blocklen,), jnp.complex64),
            "segs": self.adc.init_state(),
        }

    def _device_step(self, carry, specf):
        spec = f2c(specf)  # [B, N]
        spec_ext = jnp.concatenate([carry["prev_spec"][None], spec])
        new_states, outs = self.adc.step(spec_ext, carry["segs"])
        for o in outs:
            o["extract"] = c2f(o["extract"])
            if "extract_narrow" in o:
                o["extract_narrow"] = c2f(o["extract_narrow"])
        return (
            {"prev_spec": spec[-1], "segs": new_states},
            outs,
        )

    def has_open_slots(self) -> bool:
        """Any detection slot still active on device (an open burst the
        end-of-stream finalize pass should close)."""
        if self._carry is None:
            return False
        return any(
            bool(np.any(np.asarray(st["active"])))
            for st in self._carry["segs"]
        )

    def process_spectra(self, spectra: np.ndarray):
        """[B, blocklen] complex spectra -> list of ChannelEvents."""
        if self._carry is None:
            self._carry = self._jit_init()
        spectra = np.ascontiguousarray(spectra, np.complex64)
        nb = spectra.shape[0]
        self._carry, outs = self._jit_step(
            self._carry, jnp.asarray(c2f_host(spectra))
        )
        events = []
        for em, so in zip(self.emitters, outs):
            so = jax.tree.map(np.asarray, so)
            so["extract"] = f2c_host(so["extract"])
            if "extract_narrow" in so:
                so["extract_narrow"] = f2c_host(so["extract_narrow"])
            # slot recycling happens on device at step end; the emitter
            # reads slot geometry from the slot_meta outputs
            events.extend(em.process_step(so, so["slot_meta"], self._t0))
        self._t0 += nb
        return events
