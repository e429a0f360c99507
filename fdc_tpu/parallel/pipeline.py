"""Pipeline-parallel channelizer: batches farm over devices, scans run ahead.

The SPMD sharded step (parallel/sharded.py) pays the sequential detection
logic L as an Amdahl replication tax — every rank re-runs the scans on
all-gathered powers, so eff(T) = (E+L)/(E+T·L) no matter how the batch is
split. But the scan chain's TRUE dependencies are tiny: it needs only the
[B, n_cells]-scale power matrices and its own carry — never the heavy
extraction outputs — and the overlap-save framing history is a function
of the RAW INPUT (the host already holds it), not of device compute. So
the step decomposes into an asynchronous MPMD pipeline instead:

- **stage A (worker w, batch b)**: framing + FFT over B+1 blocks (the
  leading block RECOMPUTES the previous batch's last spectrum row from
  the host-fed sample tail — bit-identical to the carried ``prev_spec``
  row, and it removes the only cross-batch device dependency), all
  flag-independent extraction (throughput + burst channels), and the
  detection power measures. Embarrassingly parallel over batches.
- **stage B (scan owner, in batch order)**: burst hysteresis + slot
  lifecycle scans + extraction plans on the tiny powers. The only serial
  stage; its inputs/outputs are KB-scale.
- **stage C (worker w)**: detection-slot extraction on the worker-resident
  spectrum, given the owner's slot tables and plans.

Throughput model: the scan chain advances at 1/L independent of
extraction, so system throughput is min(W/E_step, 1/L) — ~100% scaling
until W ≈ E/L (≈ 10 for the flagship's E ≈ 0.53 ms, L ≈ 0.05 ms),
where the SPMD step's replicated-L law has already decayed to ~65%.
JAX's async dispatch provides the overlap: the host enqueues A/B/C for
each batch and the runtime executes A(b+1) on worker w+1 concurrently
with B(b) on the owner; per-device queues serialize reuse naturally.

No reference analog (the reference is single-process; its per-block
work loop interleaves detection and extraction on one thread,
reference: lib/SegmentDetection_impl.cc:125-176). Results are
bit-compatible with FrequencyDomainChannelizer: stage A recomputes
identical spectra, stage B runs the identical scan ops on identical
powers, stage C the identical slot extraction — pinned by
tests/test_pipeline.py (event metadata exactly equal, streams equal
within the same tolerance as the sharded contract).
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fdc_tpu.config import ChannelizerConfig
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer
from fdc_tpu.models.segment_detection import scan_slots_multi
from fdc_tpu.ops.fft import forward_spectrum
from fdc_tpu.ops.framing import frame_blocks
from fdc_tpu.parallel.mesh import TIME_AXIS
from fdc_tpu.utils.cplx import c2f, c2f_host, f2c, f2c_host

__all__ = ["PipelineChannelizer"]


class PipelineChannelizer(FrequencyDomainChannelizer):
    """FrequencyDomainChannelizer whose batches pipeline over devices.

    Usage::

        fdc = PipelineChannelizer(config, devices=jax.devices())
        result = fdc.process(samples)   # same API/results as single-device

    ``devices[0]`` owns the sequential detection state (scan chain); all
    devices (including the owner) serve as extraction workers in
    round-robin batch order, or — with ``dedicated_owner=True`` (the
    high-device-count regime, see the efficiency note on ``__init__``) —
    the leading ``max(1, scan_owners)`` devices are reserved as the
    owner pool and only the remaining devices extract. With one device this degenerates
    to the plain step's work split across three dispatches (same
    results, pointless — use the base class).

    ``process_spectra`` (the pre-FFT'd vector mode) pipelines the same
    way: there is no framing tail to recompute the reach-back row from,
    but none is needed — the HOST holds the input spectra, so each
    batch ships with the previous batch's last spectrum row prepended
    (exact, not recomputed) and stage A skips straight to extraction.
    """

    def __init__(self, config: Optional[ChannelizerConfig] = None,
                 devices: Optional[List] = None, window: int = 0,
                 dedicated_owner: bool = False, shard_time: int = 1,
                 scan_owners: int = 1, **kwargs):
        self.devices = list(devices) if devices else list(jax.devices())
        if not self.devices:
            raise ValueError("PipelineChannelizer requires >= 1 device")
        self.owner = self.devices[0]
        # With a dedicated owner the scan device does NO extraction — the
        # owner otherwise pays B + (A+C)/W per batch and the pipeline
        # efficiency decays as (A+B+C)/(A+C+W·B); dedicating it costs one
        # device of extraction capacity but removes the scan from every
        # worker's critical path: eff(W) = (W-1)/W · (A+B+C)/(A+C) until
        # the scan rate 1/B caps throughput.
        # With dedicated_owner and scan_owners > 1, RESERVE that many
        # leading devices as the owner pool so additional scan owners do
        # not land on worker devices (stage-B scans contending with
        # stage A/C would partially defeat the dedicated contract). The
        # reservation is an upper bound — if the config ends up with
        # fewer segments than reserved owners, the surplus reserved
        # devices idle (a config choice, logged nowhere: size
        # scan_owners to the segment count).
        self._n_reserved_owners = (
            min(max(1, int(scan_owners)), max(1, len(self.devices) - 1))
            if dedicated_owner and len(self.devices) > 1
            else 0
        )
        self.workers = (
            self.devices[self._n_reserved_owners:]
            if self._n_reserved_owners
            else self.devices
        )
        # PIPELINE x SPMD COMPOSITION (shard_time > 1): each pipeline
        # worker becomes a GROUP of shard_time devices; stage A/C run as
        # one shard_map over the group's time axis while the batch farm
        # and the scan chain stay MPMD. Composition attacks both scaling
        # walls at once: the SPMD step's replicated-scan tax (scans run
        # ONCE per batch on the owner) and the pipeline's 1/B scan-rate
        # ceiling (each group retires batches shard_time x faster, so
        # fewer in-flight batches reach the owner per unit time).
        # Framing needs NO collectives: every shard recomputes its own
        # reach-back spectrum row from the host-fed sample overlap — the
        # same trick the plain pipeline uses for batch boundaries,
        # applied at shard boundaries.
        self.shard_time = int(shard_time)
        if self.shard_time < 1:
            raise ValueError("shard_time must be >= 1")
        self.group_meshes = []
        if self.shard_time > 1:
            n_groups = len(self.workers) // self.shard_time
            if n_groups < 1:
                raise ValueError(
                    f"shard_time={self.shard_time} needs at least that "
                    f"many worker devices, have {len(self.workers)}"
                )
            self.group_meshes = [
                Mesh(
                    np.array(
                        self.workers[g * self.shard_time:
                                     (g + 1) * self.shard_time],
                        dtype=object,
                    ),
                    (TIME_AXIS,),
                )
                for g in range(n_groups)
            ]
        # bound on dispatched-but-unconsumed batches (device memory holds
        # one spec_ext + extraction set per in-flight batch per worker)
        n_slots = (
            len(self.group_meshes) if self.group_meshes else
            len(self.workers)
        )
        self.window = int(window) or 2 * n_slots
        super().__init__(config, **kwargs)
        if self.shard_time > 1:
            cfg_ = self.config
            if cfg_.batch_blocks % self.shard_time:
                raise ValueError(
                    f"batch_blocks={cfg_.batch_blocks} must be divisible "
                    f"by shard_time={self.shard_time}"
                )
            self.b_local = cfg_.batch_blocks // self.shard_time
            if (cfg_.batch_blocks % cfg_.relinvovl == 0
                    and self.b_local % cfg_.relinvovl):
                # the static phase-fold contract needs every shard's first
                # global block index == 0 (mod R)
                raise ValueError(
                    f"b_local={self.b_local} must be a multiple of "
                    f"relinvovl={cfg_.relinvovl} (phase-fold contract)"
                )

        # MULTI-OWNER SCANS (scan_owners > 1): segments are independent
        # automata (the reference runs one std::thread per segment), so
        # the pipeline's sequential stage B can spread segment GROUPS
        # over several owner devices — each owner advances its segments'
        # scan chains concurrently (async dispatch), dividing the
        # 1/B throughput cap by the owner count. The powact automaton
        # rides owner 0. Checkpoint/carry semantics unchanged: the carry
        # leaves simply live on their owner devices.
        self.scan_owners_n = max(1, int(scan_owners))
        self._owner_groups = []  # [(device, [seg indices])]
        if self.scan_owners_n > 1 and len(self.segments) > 1:
            n_own = min(self.scan_owners_n, len(self.segments),
                        len(self.devices))
            own_devs = self.devices[:n_own]
            groups = {}
            for i in range(len(self.segments)):
                groups.setdefault(i % n_own, []).append(i)
            self._owner_groups = [
                (own_devs[k], ids) for k, ids in sorted(groups.items())
            ]
            self._jit_scan_groups = [
                self._make_group_scan(ids, with_powact=(k == 0))
                for k, (dev, ids) in enumerate(self._owner_groups)
            ]

        cfg = self.config
        n = cfg.blocksize

        def pipe_front(histf, xf_extf, t0, ov_rowf, ov_flag):
            x = f2c(xf_extf)
            blocks, _ = frame_blocks(x, f2c(histf), n)
            # FFT the recomputed reach-back block SEPARATELY from the B
            # body rows: the split keeps the plain step's even-B FFT
            # shape (no odd [B+1]-row transform and slice
            # re-materialization) and lets consumers read `spec` as the
            # direct FFT output, with spec_ext as a concat (exactly the
            # plain step's form, models/channelizer.py _device_step).
            spec0 = forward_spectrum(
                blocks[:1], use_mxu=cfg.use_mxu_fft
            )  # [1, N]; row 0 == previous batch's last row, recomputed
            # resuming from a checkpoint WITHOUT a pipeline tail (one
            # written by the plain/sharded paths): the reach-back row
            # cannot be recomputed, so the first post-resume batch
            # substitutes the checkpoint's carried prev_spec (exact)
            spec0 = jnp.where(ov_flag, f2c(ov_rowf)[None], spec0)
            spec = forward_spectrum(
                blocks[1:], use_mxu=cfg.use_mxu_fft
            )  # [B, N]
            spec_ext = jnp.concatenate([spec0, spec])
            out, pa_powers, pa_ext, seg_powers, seg_packed = (
                self._extract_static(spec, spec_ext, t0)
            )
            dbg = c2f(spec) if cfg.debug else 0
            return (out, pa_powers, pa_ext, seg_powers, seg_packed,
                    spec_ext, dbg)

        def pipe_front_spec(spec_extf, t0):
            # vector-mode stage A: the host prepends the previous batch's
            # last spectrum row (it owns the input spectra), so there is
            # no framing/FFT and no recomputation — row 0 is exact
            spec_ext = f2c(spec_extf)  # [B+1, N]
            spec = spec_ext[1:]
            out, pa_powers, pa_ext, seg_powers, seg_packed = (
                self._extract_static(spec, spec_ext, t0)
            )
            dbg = c2f(spec) if cfg.debug else 0
            return (out, pa_powers, pa_ext, seg_powers, seg_packed,
                    spec_ext, dbg)

        def pipe_scan(carry, pa_powers, seg_packed):
            carry = dict(carry)
            scans = self._scan_detections(carry, pa_powers, seg_packed)
            return carry, scans

        def pipe_slots(spec_ext, seg_states, plans):
            return self._extract_slots_all(spec_ext, seg_states, plans)

        self._jit_front = jax.jit(pipe_front)
        self._jit_front_spec = jax.jit(pipe_front_spec)
        self._jit_scan = jax.jit(pipe_scan)
        self._jit_slots = jax.jit(pipe_slots)

        if self.group_meshes:
            bl = self.b_local
            ta = TIME_AXIS

            def pipe_front_sh(histsf, xsf, t0, ov_rowf, ov_flag):
                # per-shard stage A (under shard_map over one group's
                # time axis): frame b_local+1 blocks from the host-fed
                # overlapped sample run — the leading block RECOMPUTES
                # the left-neighbor's last spectrum row, so framing needs
                # no ppermute; only shard 0 honors the resume override.
                tidx = jax.lax.axis_index(ta)
                x = f2c(xsf[0])           # [(b_local+1)*inplen]
                blocks, _ = frame_blocks(x, f2c(histsf[0]), n)
                # split reach-back FFT, same rationale as pipe_front
                # (even-b_local FFT shape)
                spec0 = forward_spectrum(
                    blocks[:1], use_mxu=cfg.use_mxu_fft
                )
                spec0 = jnp.where(
                    ov_flag & (tidx == 0), f2c(ov_rowf)[None], spec0
                )
                spec = forward_spectrum(
                    blocks[1:], use_mxu=cfg.use_mxu_fft
                )  # [b_local, N]
                spec_ext = jnp.concatenate([spec0, spec])
                return self._front_sh_tail(spec_ext, t0, tidx, spec=spec)

            def pipe_front_spec_sh(specsf, t0):
                # vector mode: the host ships each shard its b_local+1
                # overlapping spectrum rows directly (row 0 = reach-back)
                tidx = jax.lax.axis_index(ta)
                spec_ext = f2c(specsf[0])  # [b_local+1, N]
                return self._front_sh_tail(spec_ext, t0, tidx)

            def pipe_slots_sh(spec_ext_sh, seg_states, plans):
                outs = self._extract_slots_all(
                    spec_ext_sh[0], seg_states, plans
                )
                # keep a per-shard axis for host-side row merging
                return [
                    jax.tree.map(lambda v: v[:, None], eo) for eo in outs
                ]

            # output partition specs mirroring the pytrees above
            p5 = P(None, ta, None, None, None)
            out_spec = {}
            if self.throughput:
                out_spec["throughput_buckets"] = [
                    P(None, ta, None) for _ in self.throughput.buckets
                ]
            pa_pw_spec = P(ta, None) if self.power_bank else None
            pa_ext_spec = (
                {b.width: p5 for b in self.power_bank.buckets}
                if self.power_bank else None
            )
            seg_list_spec = [P(ta, None) for _ in self.segments]
            front_out = (
                out_spec, pa_pw_spec, pa_ext_spec, seg_list_spec,
                list(seg_list_spec), P(ta, None, None),
                P(ta, None, None) if cfg.debug else P(),
            )
            slots_out = []
            for sd in self.segments:
                d = {"extract": p5}
                if sd.extract_width_split:
                    d["extract_narrow"] = p5
                slots_out.append(d)
            states_spec = [
                jax.tree.map(lambda _: P(), sd.init_state())
                for sd in self.segments
            ]
            plans_spec = []
            for sd in self.segments:
                d = {"slot_ids": P()}
                if sd.extract_width_split:
                    d["slot_ids_narrow"] = P()
                plans_spec.append(d)

            def mk(body, in_specs, out_specs, mesh):
                return jax.jit(jax.shard_map(
                    body, mesh=mesh, in_specs=in_specs,
                    out_specs=out_specs, check_vma=False,
                ))

            self._jit_front_groups = [
                mk(pipe_front_sh,
                   (P(ta, None, None), P(ta, None, None), P(), P(), P()),
                   front_out, m)
                for m in self.group_meshes
            ]
            self._jit_front_spec_groups = [
                mk(pipe_front_spec_sh, (P(ta, None, None, None), P()),
                   front_out, m)
                for m in self.group_meshes
            ]
            self._jit_slots_groups = [
                mk(pipe_slots_sh,
                   (P(ta, None, None), states_spec, plans_spec),
                   slots_out, m)
                for m in self.group_meshes
            ]

        # host rolling tail: the (inplen + ovllen) samples preceding the
        # next batch — ovllen of framing history for the RECOMPUTED
        # leading block plus that block's inplen samples. Note
        # inplen + ovllen == blocksize, so the tail IS the last block.
        self._tail = np.zeros(cfg.inplen + cfg.ovllen, np.complex64)
        # one-shot reach-back-row override for resume-from-plain
        # checkpoints (see pipe_front)
        self._ov_row = np.zeros((cfg.blocksize, 2), np.float32)
        self._ov_flag = False
        # vector-mode rolling state: the previous batch's last spectrum
        # row (float pairs), prepended to the next batch as the exact
        # reach-back row (carry['prev_spec'] is never advanced by the
        # pipelined vector step — see _host_extra_state)
        self._prev_specf = np.zeros((cfg.blocksize, 2), np.float32)

    def reset(self):
        super().reset()
        cfg = self.config
        self._tail = np.zeros(cfg.inplen + cfg.ovllen, np.complex64)
        self._ov_row = np.zeros((cfg.blocksize, 2), np.float32)
        self._ov_flag = False
        self._prev_specf = np.zeros((cfg.blocksize, 2), np.float32)

    # -- pipeline x SPMD composition helpers ---------------------------------

    def _front_sh_tail(self, spec_ext, t0, tidx, spec=None):
        """Shared post-FFT body of the sharded stage A: extraction +
        measures + candidate packing on this shard's b_local(+1) rows at
        its global block offset. Pass ``spec`` (the direct body-FFT
        output) when available so consumers avoid re-materializing the
        spec_ext[1:] slice."""
        cfg = self.config
        if spec is None:
            spec = spec_ext[1:]
        t_loc0 = t0 + tidx * self.b_local
        out, pa_powers, pa_ext, seg_powers, seg_packed = (
            self._extract_static(spec, spec_ext, t_loc0)
        )
        if pa_ext is not None:
            # keep a per-shard axis so the host can merge the duplicated
            # reach-back rows (same convention as parallel/sharded.py)
            pa_ext = {w: v[:, None] for w, v in pa_ext.items()}
        dbg = c2f(spec) if cfg.debug else jnp.int32(0)
        return (out, pa_powers, pa_ext, seg_powers, seg_packed,
                spec_ext[None], dbg)

    def _shard_inputs(self, chunk):
        """Host-side per-shard sample runs for one batch: shard t frames
        blocks [t*b_local - 1, (t+1)*b_local) of the batch, so its input
        is (b_local+1)*inplen samples plus ovllen of history — all taken
        from the rolling tail + chunk sample line (the host holds every
        sample, so shard boundaries need no device communication)."""
        cfg = self.config
        s_line = np.concatenate([self._tail, chunk])
        bl, t_n = self.b_local, self.shard_time
        inplen, ovl = cfg.inplen, cfg.ovllen
        xs = np.stack([
            s_line[ovl + t * bl * inplen:
                   ovl + (t * bl + bl + 1) * inplen]
            for t in range(t_n)
        ])
        hists = np.stack([
            s_line[t * bl * inplen: t * bl * inplen + ovl]
            for t in range(t_n)
        ])
        return xs, hists

    def _shard_spec_inputs(self, spec_extf):
        """Vector-mode equivalent: shard t gets rows
        [t*b_local, t*b_local + b_local] of the [B+1, N, 2] extended
        spectrum batch (overlapping reach-back rows)."""
        bl = self.b_local
        return np.stack([
            spec_extf[t * bl: t * bl + bl + 1]
            for t in range(self.shard_time)
        ])

    @staticmethod
    def _np_merge_rows(a: np.ndarray) -> np.ndarray:
        """[C, T, b_local+1, ...] per-shard row families -> canonical
        [C, B+1, ...] (row 0 = batch reach-back; duplicated shard
        reach-back rows dropped)."""
        c, t, blp1 = a.shape[:3]
        body = a[:, :, 1:].reshape(c, t * (blp1 - 1), *a.shape[3:])
        return np.concatenate([a[:, 0, :1], body], axis=1)

    def _make_group_scan(self, seg_ids, with_powact):
        """One owner device's jitted stage B: the fused lifecycle scans +
        plans for its segment group (plus the powact automaton on owner
        0). Same ops as _scan_detections restricted to the group.

        ``foreign`` carries split-cut neighbor views — per local segment
        a (lower, upper) pair of raw (det_start, det_stop, active, tomb)
        leaves, device_put from the neighbor owner's PREVIOUS-batch state
        (the lagged contract of SegmentDetector.reconcile_split; the
        host snapshots all views before dispatching any group, so
        same-batch updates never leak across owners)."""
        sds = [self.segments[i] for i in seg_ids]
        bank = self.power_bank if with_powact else None

        def fn(states, packed_list, pa_powers, pa_state, foreign=None):
            states = list(states)
            packed_list = list(packed_list)
            killed_by_lk = {}
            for lk, (lo_v, hi_v) in (foreign or {}).items():
                kill_from, sup = [], []
                if lo_v is not None:
                    v = (lo_v[0], lo_v[1], lo_v[2] & ~lo_v[3])
                    kill_from.append(v)
                    sup.append(v)
                if hi_v is not None:
                    sup.append((hi_v[0], hi_v[1], hi_v[2] & ~hi_v[3]))
                st, pk, killed = sds[lk].reconcile_split(
                    states[lk], packed_list[lk], kill_from, sup
                )
                states[lk] = st
                packed_list[lk] = pk
                killed_by_lk[lk] = killed
            pa_res = None
            if bank is not None:
                if sds:
                    seg_scans, pa_res = scan_slots_multi(
                        sds, [None] * len(sds), list(states),
                        packed_list=list(packed_list),
                        powact=(bank, pa_powers, pa_state),
                    )
                else:
                    seg_scans = []
                    pa_res = bank.scan_flags(pa_powers, pa_state)
            else:
                seg_scans = scan_slots_multi(
                    sds, [None] * len(sds), list(states),
                    packed_list=list(packed_list),
                )
            outs = []
            for lk, (sd, (st, flags)) in enumerate(zip(sds, seg_scans)):
                so = self._seg_scan_outputs(sd, st, flags)
                if lk in killed_by_lk:
                    so["killed"] = killed_by_lk[lk]
                outs.append((st, so))
            return outs, pa_res

        return jax.jit(fn)

    # -- checkpoint integration ---------------------------------------------

    def _host_extra_state(self) -> dict:
        """Checkpoint hook: the pipeline's real framing state is host-side
        (the sample tail, or in vector mode the previous spectrum row);
        carry['hist'] / carry['prev_spec'] are never advanced by the
        pipelined steps. Sync them INTO the carry so a plain or sharded
        channelizer can resume this checkpoint bit-identically, and save
        the host state so a pipeline can."""
        cfg = self.config
        if self._carry is not None:
            # sync ONLY the touched leaves — jitting over the whole carry
            # would mix devices in multi-owner mode (segment states live
            # on their owner devices)
            if self._spectra_mode:
                # vector mode: the sample tail is meaningless (all zeros)
                # — syncing from it would overwrite prev_spec with the
                # spectrum of silence; the real reach-back row is the
                # host-held _prev_specf
                rowf = jnp.asarray(self._prev_specf)
                carry = dict(self._carry)
                carry["prev_spec"] = jax.jit(f2c)(rowf)
                self._carry = carry
            else:
                tailf = jnp.asarray(c2f_host(self._tail))

                @jax.jit
                def sync(tf):
                    t = f2c(tf)
                    # the tail is exactly the last processed block (see
                    # __init__ note), so its spectrum IS prev_spec
                    return t[-cfg.ovllen:], forward_spectrum(
                        t[None], use_mxu=cfg.use_mxu_fft
                    )[0]

                hist, prev = sync(tailf)
                carry = dict(self._carry)
                carry["hist"] = hist
                carry["prev_spec"] = prev
                self._carry = carry
        return {
            "pipeline_tail": self._tail.copy(),
            "pipeline_prev_specf": self._prev_specf.copy(),
        }

    def _restore_host_extra_state(self, extra: dict):
        cfg = self.config
        tail = extra.get("pipeline_tail")
        row = extra.get("pipeline_prev_specf")
        if tail is not None:
            self._tail = np.asarray(tail, np.complex64)
            self._prev_specf = (
                np.asarray(row, np.float32)
                if row is not None
                # pre-row pipeline checkpoint: the saving side synced the
                # carry, so the carried prev_spec is the exact row
                else self._pack_host_row()["prev_spec"]
            )
            self._ov_flag = False
            return
        # plain/sharded checkpoint: reconstruct what is reconstructible —
        # the tail's hist section comes from the carried hist (it frames
        # the first real block); the prev-block samples are unknown, so
        # the recomputed reach-back row would be wrong — override it with
        # the carried prev_spec for the first post-resume batch (exact).
        # In vector mode the carried prev_spec IS the reach-back row.
        host = self._pack_host_row()
        self._tail = np.concatenate(
            [np.zeros(cfg.inplen, np.complex64), host["hist"]]
        )
        self._ov_row = host["prev_spec"]
        self._ov_flag = True
        self._prev_specf = host["prev_spec"]

    def _pack_host_row(self):
        """Fetch carry hist (complex64) + prev_spec ([N, 2] float32) to
        the host, crossing the device boundary as float pairs."""

        @jax.jit
        def pack(carry):
            return {
                "hist": c2f(carry["hist"]),
                "prev_spec": c2f(carry["prev_spec"]),
            }

        out = pack(self._carry)
        return {
            "hist": f2c_host(np.asarray(out["hist"])),
            "prev_spec": np.asarray(out["prev_spec"]),
        }

    # -- pipelined streaming ----------------------------------------------------

    def _pipe_scan_extract(self, dev, pa_powers, seg_packed, spec_ext,
                           group_idx=None):
        """Stages B and C for one batch: the owner(s)' sequential scans
        on the tiny powers/candidate rows, then slot extraction back on
        the batch's worker (or worker GROUP, pipeline x SPMD mode) under
        the owner's tables/plans."""
        if self._owner_groups:
            # multi-owner stage B: each owner device advances its segment
            # group's scan chain; async dispatch runs the owners
            # concurrently. Carry leaves live on their owners.
            results = [None] * len(self.segments)
            pa_res = None
            # split-cut neighbor views: snapshot ALL split parts' states
            # BEFORE dispatching any group (the previous batch's states —
            # the lagged contract; device_put of a still-computing array
            # queues asynchronously, so the owner chain never blocks)
            views = {}
            for i in self._split_neighbors:
                st = self._carry[f"seg{i}"]
                views[i] = (
                    st["det_start"], st["det_stop"],
                    st["active"], st["tomb"],
                )
            for k, ((odev, ids), fn) in enumerate(
                zip(self._owner_groups, self._jit_scan_groups)
            ):
                states = tuple(
                    jax.device_put(self._carry[f"seg{i}"], odev)
                    for i in ids
                )
                packs = tuple(
                    jax.device_put(seg_packed[i], odev) for i in ids
                )
                foreign = {}
                for lk, i in enumerate(ids):
                    if i in self._split_neighbors:
                        lo, hi = self._split_neighbors[i]
                        foreign[lk] = (
                            jax.device_put(views[lo], odev)
                            if lo is not None else None,
                            jax.device_put(views[hi], odev)
                            if hi is not None else None,
                        )
                if k == 0 and self.power_bank:
                    outs, pa_res = fn(
                        states, packs,
                        jax.device_put(pa_powers, odev),
                        jax.device_put(self._carry["powact"], odev),
                        foreign,
                    )
                else:
                    outs, _ = fn(states, packs, None, None, foreign)
                for i, (st, so) in zip(ids, outs):
                    self._carry = dict(self._carry)
                    self._carry[f"seg{i}"] = st
                    results[i] = (st, so)
            scans = {"segs": results}
            if self.power_bank:
                self._carry = dict(self._carry)
                self._carry["powact"], flags = pa_res
                scans["powact"] = flags
        else:
            # single-owner stage B, in batch order (the serial chain)
            pa_o = (
                jax.device_put(pa_powers, self.owner)
                if self.power_bank else None
            )
            # only the tiny pre-packed candidate rows travel to the owner
            # (candidate detection already ran on the worker, stage A)
            segk_o = [jax.device_put(p, self.owner) for p in seg_packed]
            self._carry, scans = self._jit_scan(self._carry, pa_o, segk_o)
        # stage C back on the worker / worker group
        states = [st for st, _ in scans["segs"]]
        plans = [
            {
                k: so[k]
                for k in ("slot_ids", "slot_ids_narrow")
                if k in so
            }
            for _, so in scans["segs"]
        ]
        if group_idx is not None:
            mesh = self.group_meshes[group_idx]
            repl = NamedSharding(mesh, P())
            states_w = jax.device_put(states, repl)
            plans_w = jax.device_put(plans, repl)
            extracts = self._jit_slots_groups[group_idx](
                spec_ext, states_w, plans_w
            )
        else:
            states_w = jax.device_put(states, dev)
            plans_w = jax.device_put(plans, dev)
            extracts = self._jit_slots(spec_ext, states_w, plans_w)
        return scans, extracts

    def _consume_pipeline_batch(self, batch_parts, result, dbg):
        """Reassemble one in-flight batch's stage outputs into the plain
        step's `out` dict and fold it into the result (deferred, so the
        host never blocks the pipeline on device completion)."""
        cfg = self.config
        (out_static, pa_ext, seg_powers, dbgb, scans, extracts,
         t0_b) = batch_parts
        out = dict(out_static)
        if self.shard_time > 1:
            # composed mode: the row-family outputs carry a per-shard
            # axis (duplicated shard reach-back rows) — merge to the
            # canonical [C, B+1, ...] layout on the host
            if pa_ext is not None:
                pa_ext = {
                    w: self._np_merge_rows(np.asarray(v))
                    for w, v in pa_ext.items()
                }
            extracts = [
                {
                    k: self._np_merge_rows(np.asarray(v))
                    for k, v in eo.items()
                }
                for eo in extracts
            ]
        if self.power_bank:
            rise, fall, processed, phase_used = scans["powact"]
            out["powact"] = {
                "rise": rise,
                "fall": fall,
                "processed": processed,
                "phase_used": phase_used,
                "extract": pa_ext,
            }
        for i, ((_, so), eo, power) in enumerate(
            zip(scans["segs"], extracts, seg_powers)
        ):
            so = dict(so)
            so.update(eo)
            so["power"] = power
            out[f"seg{i}"] = so
        if cfg.debug:
            out["debug_spectrum"] = dbgb
        self._consume_outputs(out, result, dbg, t0=t0_b)
        result.blocks_processed += cfg.batch_blocks

    def process(self, samples: np.ndarray):
        cfg = self.config
        if self._spectra_mode:
            # same contract as the base class: one entry point per
            # stream. For the pipeline this is load-bearing — the host
            # framing state (_tail vs _prev_specf) is per-mode, and a
            # mixed-mode checkpoint would sync the wrong one into the
            # carry and silently corrupt resume.
            raise RuntimeError(
                "process() called on a stream already driven by "
                "process_spectra(); use one entry point per stream "
                "(reset() starts a new one)"
            )
        self._samples_mode = True
        if self._carry is None:
            self._carry = jax.device_put(self._jit_init(), self.owner)

        x = np.concatenate(
            [self._pending, np.asarray(samples, np.complex64)]
        )
        bs = self.batch_samples
        n_batches = len(x) // bs
        self._pending = x[n_batches * bs:]

        result = self._new_result()
        dbg = []
        inflight = []

        for b in range(n_batches):
            chunk = x[b * bs: (b + 1) * bs]
            gi = dev = None
            if self.group_meshes:
                gi = b % len(self.group_meshes)
            else:
                dev = self.workers[b % len(self.workers)]

            ov_flag = jnp.bool_(self._ov_flag)
            self._ov_flag = False  # consumed by the first post-resume batch
            if gi is not None:
                # composed mode: per-shard overlapped sample runs, placed
                # directly onto the group's time-sharded mesh
                mesh = self.group_meshes[gi]
                xs, hists = self._shard_inputs(chunk)
                shd = NamedSharding(mesh, P(TIME_AXIS))
                xf = jax.device_put(c2f_host(xs), shd)
                histf = jax.device_put(c2f_host(hists), shd)
                ov_row = jax.device_put(
                    self._ov_row, NamedSharding(mesh, P())
                )
                glue = np.concatenate([self._tail, chunk])
                self._tail = glue[-(cfg.inplen + cfg.ovllen):]
                (out_static, pa_powers, pa_ext, seg_powers, seg_packed,
                 spec_ext, dbgb) = self._jit_front_groups[gi](
                    histf, xf, jnp.int32(self._t0), ov_row, ov_flag
                )
            else:
                # host-fed framing tail: one extra leading block so stage
                # A recomputes the previous batch's last spectrum row
                # itself. Inputs go host -> worker DIRECTLY (committing
                # via jnp.asarray first would land them on the default
                # device — the scan owner — and pay a second
                # device-to-device hop on exactly the device the pipeline
                # must keep unblocked).
                x_ext = np.concatenate([self._tail[cfg.ovllen:], chunk])
                histf = jax.device_put(
                    c2f_host(self._tail[: cfg.ovllen]), dev
                )
                xf = jax.device_put(c2f_host(x_ext), dev)
                glue = np.concatenate([self._tail, chunk])
                self._tail = glue[-(cfg.inplen + cfg.ovllen):]
                ov_row = jax.device_put(self._ov_row, dev)
                (out_static, pa_powers, pa_ext, seg_powers, seg_packed,
                 spec_ext, dbgb) = self._jit_front(
                    histf, xf, jnp.int32(self._t0), ov_row, ov_flag
                )
            scans, extracts = self._pipe_scan_extract(
                dev, pa_powers, seg_packed, spec_ext, group_idx=gi
            )

            inflight.append(
                (out_static, pa_ext, seg_powers, dbgb, scans, extracts,
                 self._t0)
            )
            self._t0 += cfg.batch_blocks
            if len(inflight) >= self.window:
                self._consume_pipeline_batch(inflight.pop(0), result, dbg)

        while inflight:
            self._consume_pipeline_batch(inflight.pop(0), result, dbg)
        if dbg:
            result.debug_spectrum = np.concatenate(dbg)
        return result

    def process_spectra(self, spectra: np.ndarray):
        """Pipelined pre-FFT'd vector mode: same batch farm-out as
        ``process``, minus framing/FFT. The host owns the input spectra,
        so each batch ships to its worker with the previous batch's last
        spectrum row prepended — the reach-back row is exact by
        construction (no recompute, no carried-row override needed)."""
        cfg = self.config
        if self._samples_mode:
            raise RuntimeError(
                "process_spectra() called on a stream already driven by "
                "process(); use one entry point per stream (reset() "
                "starts a new one)"
            )
        if self._carry is None:
            self._carry = jax.device_put(self._jit_init(), self.owner)
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
        inflight = []

        for b in range(n_batches):
            chunk = spectra[b * bb: (b + 1) * bb]
            gi = dev = None
            if self.group_meshes:
                gi = b % len(self.group_meshes)
            else:
                dev = self.workers[b % len(self.workers)]
            spec_extf = np.concatenate(
                [self._prev_specf[None], c2f_host(chunk)]
            )  # [B+1, N, 2]
            # .copy(): a bare view would keep the whole [B+1, N, 2] batch
            # array alive between calls just to retain one row
            self._prev_specf = spec_extf[-1].copy()

            if gi is not None:
                mesh = self.group_meshes[gi]
                sf = jax.device_put(
                    self._shard_spec_inputs(spec_extf),
                    NamedSharding(mesh, P(TIME_AXIS)),
                )  # [T, b_local+1, N, 2]
                (out_static, pa_powers, pa_ext, seg_powers, seg_packed,
                 spec_ext, dbgb) = self._jit_front_spec_groups[gi](
                    sf, jnp.int32(self._t0)
                )
            else:
                sf = jax.device_put(spec_extf, dev)
                (out_static, pa_powers, pa_ext, seg_powers, seg_packed,
                 spec_ext, dbgb) = self._jit_front_spec(
                    sf, jnp.int32(self._t0)
                )
            scans, extracts = self._pipe_scan_extract(
                dev, pa_powers, seg_packed, spec_ext, group_idx=gi
            )

            inflight.append(
                (out_static, pa_ext, seg_powers, dbgb, scans, extracts,
                 self._t0)
            )
            self._t0 += bb
            if len(inflight) >= self.window:
                self._consume_pipeline_batch(inflight.pop(0), result, dbg)

        while inflight:
            self._consume_pipeline_batch(inflight.pop(0), result, dbg)
        if dbg:
            result.debug_spectrum = np.concatenate(dbg)
        return result
