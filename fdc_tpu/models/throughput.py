"""Static ("throughput") channelizer: fixed always-on channels.

Replaces the reference's per-channel 6-block chain
(vector_cut -> phase_shifting_windowing_vcc -> inverse fft_vcc -> vector_cut
-> vector_to_stream -> multiply_const;
reference: python/FrequencyDomainChannelizer.py:218-231) with width-bucketed
batched extraction: all channels sharing an FFT width l are processed as one
[C_l, B, l] tensor — one gather, one complex multiply, one batched IFFT.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from fdc_tpu.config import WindowType, solve_throughput_channel
from fdc_tpu.ops.extract import apply_phase, apply_phase_pairs, extract_bucket
from fdc_tpu.ops.windows import base_window

__all__ = ["ThroughputChannelizer"]


@dataclass(frozen=True)
class _Bucket:
    width: int
    out_len: int
    channel_ids: tuple  # original channel indices, in order
    starts: np.ndarray  # [C] int32
    windows: np.ndarray  # [C, width] float32 phase-0 window amplitudes


class ThroughputChannelizer:
    """Batched fixed-channel extractor.

    Built once from solved channel geometry; ``extract`` is a pure function
    of (spectrum batch, global block index) suitable for jit/vmap/shard_map.
    """

    def __init__(
        self,
        blocksize: int,
        relinvovl: int,
        channels,  # [(freq, bw)] in FDC [0,1) coordinates
        windowtype: WindowType = WindowType.RECTANGULAR,
        use_mxu: bool = False,
    ):
        self.blocksize = blocksize
        self.relinvovl = relinvovl
        self.use_mxu = bool(use_mxu)  # matmul-DFT subband transforms
        self.geometry = [
            solve_throughput_channel(blocksize, relinvovl, f, bw)
            for f, bw in channels
        ]

        by_width = {}
        for i, g in enumerate(self.geometry):
            by_width.setdefault(g.width, []).append(i)

        self.buckets = []
        for width in sorted(by_width):
            ids = by_width[width]
            starts = np.array(
                [self.geometry[i].start for i in ids], dtype=np.int32
            )
            wins = np.stack(
                [
                    base_window(
                        windowtype,
                        width,
                        self.geometry[i].passband,
                        self.geometry[i].stopband,
                    )
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

    def extract(self, spectrum: jax.Array, block_index0) -> list:
        """Extract all channels from a [B, N] spectrum batch.

        Returns a list (one entry per configured channel, original order) of
        [B * out_len] complex sample streams — each the contiguous output of
        that channel for this batch, overlap samples dropped
        (reference: python/FrequencyDomainChannelizer.py:229-231).
        """
        out = [None] * self.num_channels
        for bucket in self.buckets:
            y = extract_bucket(
                spectrum,
                bucket.starts,
                bucket.windows,  # np: folds into the DFT matrix
                gain=float(bucket.width),  # trailing multiply_const == l
                use_mxu=self.use_mxu,
                keep_from=bucket.width - bucket.out_len,
            )  # [C, B, out_len]
            mat = self.finish_bucket(bucket, y, block_index0)
            for row, chan in enumerate(bucket.channel_ids):
                out[chan] = mat[row]
        return out

    def finish_bucket(
        self, bucket: _Bucket, y: jax.Array, block_index0,
        pairs: bool = False, prephased: bool = False,
    ):
        """Phase-compensate and trim a bucket's raw extraction into the
        per-channel stream matrix [C, B*out_len] (``pairs``: float32
        [C, B*out_len, 2], y then being a pairs extraction).

        Accepts y of [C, B, l(, 2)] (trims the l//R overlap here) or
        already overlap-trimmed [C, B, out_len(, 2)] (the matmul path never
        computes the dropped columns). ``prephased``: y already carries
        the per-block phase compensation (extract_bucket_phased) — only
        trim + reshape here. Separated from ``extract`` so the
        channelizer's fused extraction path (shared slice-window-IFFT with
        the burst bank) can reuse the post-processing. Kept as ONE matrix:
        per-channel splitting belongs on the host — splitting on device
        turns every channel into its own XLA kernel (64 extra launches per
        step on the flagship workload).
        """
        b = y.shape[1]
        l = bucket.width

        def phase_idx():
            # overlap-save phase compensation: window index (t * start) % R
            # (reference: lib/phase_shifting_windowing_vcc_impl.cc:80-83);
            # block_index0 is unused (dead) when prephased
            t = jnp.asarray(block_index0, dtype=jnp.int32) + jnp.arange(
                b, dtype=jnp.int32
            )  # [B] global blocks
            return (t[None, :] * jnp.asarray(bucket.starts)[:, None]) \
                % self.relinvovl

        if pairs:
            if not prephased:
                y = apply_phase_pairs(y, phase_idx(), self.relinvovl)
            if y.shape[-2] == l:
                y = y[..., l - bucket.out_len:, :]
            return y.reshape(
                len(bucket.channel_ids), b * bucket.out_len, 2
            )
        y = apply_phase(y, phase_idx(), self.relinvovl)
        if y.shape[-1] == l:
            y = y[..., l - bucket.out_len:]  # drop time-domain overlap
        return y.reshape(len(bucket.channel_ids), b * bucket.out_len)
