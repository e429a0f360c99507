"""Power-activated burst channels (fixed positions, hysteresis on/off).

JAX rebuild of PowerActivationChannel
(reference: lib/PowerActivationChannel_impl.cc): C configured channels share

1. one matmul for all in-band power measurements,
2. one serial walk over the block axis for the per-channel activation
   state machine (active flag, last-block power, window phase): a kernel
   on the GPU, a ``lax.scan`` elsewhere,
3. one width-bucketed batched extraction over [B+1] spectra — row 0 is the
   *previous* batch's last block so a channel activating at the batch start
   can reach back one block, exactly like the reference's history processing
   (reference: lib/PowerActivationChannel_impl.cc:198-210).

Extraction runs unconditionally for every channel every block (batched, no
data-dependent shapes); activity only gates which rows the host-side
emission layer (fdc_tpu.runtime.emission.PowerActivationEmitter) appends to
burst buffers. The device returns phase-0 extractions; the scalar
overlap-save phase rotation is applied by the emitter (see
fdc_tpu/ops/extract.py docstring for why it factors out).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from fdc_tpu.config import solve_power_channel
from fdc_tpu.ops.detect import band_power
from fdc_tpu.ops.extract import extract_bucket
from fdc_tpu.ops.lifecycle_pallas import powact_flags, resolve_backend
from fdc_tpu.ops.windows import sine_flank_window_bank

__all__ = ["PowerActivationBank"]

# std::numeric_limits<float>::min() — the reference's zero-power floor
# (reference: lib/PowerActivationChannel_impl.cc:293-294)
_FLOAT_MIN = np.float32(1.1754944e-38)
_FLOAT_MAX = np.float32(3.4028235e38)


@dataclass(frozen=True)
class _Bucket:
    width: int
    out_len: int
    channel_ids: tuple
    starts: np.ndarray  # [C] int32 extract starts
    windows: np.ndarray  # [C, width] float32 phase-0 sine-flank windows


class PowerActivationBank:
    """Bank of C power-activated channels with one shared device step."""

    def __init__(
        self,
        blocksize: int,
        relinvovl: int,
        channels,  # [(cfreq, bw)] in FDC [0,1) coordinates
        thresh_db: float,
        lifecycle_backend: str = "auto",
        use_mxu: bool = False,
    ):
        if thresh_db <= 0.0:
            raise ValueError("Threshold is dB and must be > 0")
        if lifecycle_backend not in (
            "auto", "scan", "pallas", "pallas_interpret"
        ):
            raise ValueError(f"unknown lifecycle_backend {lifecycle_backend!r}")
        self.lifecycle_backend = lifecycle_backend
        self.use_mxu = bool(use_mxu)  # matmul-DFT subband transforms
        self.blocksize = blocksize
        self.relinvovl = relinvovl
        # linear threshold (reference: lib/PowerActivationChannel_impl.cc:377-381)
        self.thresh = float(10.0 ** (thresh_db / 10.0))
        self.geometry = [
            solve_power_channel(blocksize, relinvovl, f, bw) for f, bw in channels
        ]

        # measurement masks: [N, C] 0/1 — one matmul measures all channels
        n_chan = len(self.geometry)
        masks = np.zeros((blocksize, n_chan), np.float32)
        for i, g in enumerate(self.geometry):
            masks[g.measure_start : g.measure_stop, i] = 1.0
        self.measure_masks = masks

        by_width = {}
        for i, g in enumerate(self.geometry):
            by_width.setdefault(g.extract_width, []).append(i)
        self.buckets = []
        for width in sorted(by_width):
            ids = by_width[width]
            starts = np.array(
                [self.geometry[i].extract_start for i in ids], np.int32
            )
            wins = np.stack(
                [
                    # phase-0 copy of the sine-flank bank
                    sine_flank_window_bank(
                        width,
                        self.geometry[i].measure_stop
                        - self.geometry[i].measure_start,
                        relinvovl,
                    )[0].real
                    for i in ids
                ]
            ).astype(np.float32)
            self.buckets.append(
                _Bucket(
                    width=width,
                    out_len=width - width // relinvovl,
                    channel_ids=tuple(ids),
                    starts=starts,
                    windows=wins,
                )
            )

    @property
    def num_channels(self) -> int:
        return len(self.geometry)

    # -- state ---------------------------------------------------------------

    def init_state(self):
        """Per-channel carry: active flag, last-block power (initialized to
        float max to suppress an initial activation, reference:
        lib/PowerActivationChannel_impl.cc:92), window phase."""
        c = self.num_channels
        return {
            "active": jnp.zeros((c,), bool),
            "lastpower": jnp.full((c,), _FLOAT_MAX, jnp.float32),
            "phase": jnp.zeros((c,), jnp.int32),
        }

    # -- device step ----------------------------------------------------------

    def measure(self, spectrum: jax.Array, sq: jax.Array = None) -> jax.Array:
        """[B, N] spectra -> [B, C] floored in-band powers (one matmul,
        reference: lib/PowerActivationChannel_impl.cc:286-306). Pass ``sq``
        (= |spectrum|²) when the caller already computed it — the channelizer
        shares one power pass across all detection consumers."""
        if sq is None:
            sq = jnp.abs(spectrum) ** 2
        powers = band_power(sq, jnp.asarray(self.measure_masks))
        return jnp.maximum(powers, _FLOAT_MIN)

    def scan_flags(self, powers: jax.Array, state):
        """Activation state machine over [B, C] powers.

        Cheap sequential part of the step, separated out so the parallel
        layer can run it replicated on all-gathered powers while extraction
        stays sharded. Returns (new_state, (rise, fall, processed,
        phase_used)) — all flags [C, B].
        """
        delta = jnp.asarray(
            [g.delta_phase for g in self.geometry], jnp.int32
        )  # [C]

        backend = resolve_backend(self.lifecycle_backend)
        if backend in ("pallas", "pallas_interpret"):
            return powact_flags(
                powers,
                state,
                delta,
                r=self.relinvovl,
                thresh=self.thresh,
                interpret=(backend == "pallas_interpret"),
            )

        thresh = jnp.float32(self.thresh)
        r = self.relinvovl

        def scan_body(carry, pwr):
            active, lastpower, phase = carry
            # reference: lib/PowerActivationChannel_impl.cc:286-306
            rise = (~active) & (pwr / lastpower >= thresh)
            fall = active & (lastpower / pwr >= thresh)
            processed = rise | active
            phase_used = jnp.where(rise, delta, phase)
            new_phase = jnp.where(
                rise,
                (2 * delta) % r,
                jnp.where(processed, (phase + delta) % r, phase),
            )
            new_active = (active | rise) & ~fall
            return (new_active, pwr, new_phase), (
                rise,
                fall,
                processed,
                phase_used,
            )

        (active, lastpower, phase), (rise, fall, processed, phase_used) = (
            jax.lax.scan(
                scan_body,
                (state["active"], state["lastpower"], state["phase"]),
                powers,
            )
        )
        new_state = {"active": active, "lastpower": lastpower, "phase": phase}
        return new_state, (rise.T, fall.T, processed.T, phase_used.T)

    def extract_rows(self, spec_ext: jax.Array, bucket_tables=None):
        """Width-bucketed extraction of every configured channel over every
        spectrum row. ``bucket_tables`` optionally overrides each bucket's
        (starts, windows) arrays — the parallel layer passes channel-sharded
        views. Returns {width: [C_w, rows, out_len] complex}, phase 0."""
        extract = {}
        for i, bucket in enumerate(self.buckets):
            if bucket_tables is not None:
                starts, windows = bucket_tables[i]
            else:
                starts = bucket.starts  # np: static slice starts
                windows = bucket.windows  # np: folds into the DFT matrix
            # [C_w, rows, out_len], phase-0, unnormalized-IFFT scale
            extract[bucket.width] = extract_bucket(
                spec_ext, starts, windows, use_mxu=self.use_mxu,
                keep_from=bucket.width - bucket.out_len,
            )
        return extract

    def step(self, spec_ext: jax.Array, state):
        """Process B blocks.

        Args:
          spec_ext: [B+1, N] normalized fftshifted spectra; row 0 is the
            previous batch's last block (history), rows 1..B are this batch.
          state: see init_state.

        Returns (new_state, outputs) with outputs:
          rise/fall/processed: [C, B] bool flags per block
            (rise == activation, fall == deactivation-with-final-process;
            processed == process_channel ran for that block).
          phase_used: [C, B] int32 window phase consumed by each processed
            block (the emitter turns this into a scalar rotation).
          extract: dict {width: [C_w, B+1, out_len] complex} phase-0
            extraction of every row (row b is block b-1; row 0 is history).
        """
        powers = self.measure(spec_ext[1:])  # [B, C]
        new_state, (rise, fall, processed, phase_used) = self.scan_flags(
            powers, state
        )
        outputs = {
            "rise": rise,  # [C, B]
            "fall": fall,
            "processed": processed,
            "phase_used": phase_used,
            "extract": self.extract_rows(spec_ext),
        }
        return new_state, outputs
