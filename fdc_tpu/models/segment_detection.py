"""Dynamic carrier detection + channelization over one frequency segment.

JAX rebuild of SegmentDetection (reference: lib/SegmentDetection_impl.cc).
The reference's data-dependent channel lifecycle (spawn / track / retire with
variable widths, std::deque of heap-allocated channels, per-channel FFTW
plans and std::threads) becomes:

1. a decimated power spectrum for the whole batch at once (``cell_power``),
2. one ``lax.scan`` over blocks updating a FIXED-CAPACITY slot table
   (the functional form of ``struct active_channel``,
   reference: lib/SegmentDetection_impl.h:65-83) — candidates via
   strongest-first edge pairing, first-match refresh semantics, aging,
   allocation of new slots, tombstoning of retired ones,
3. one batched variable-width extraction of ALL slots over the [B+1]-row
   spectrum batch (row 0 = previous batch's last block for activation
   history reach-back, reference: lib/SegmentDetection_impl.cc:431-435)
   via the comb-upsampled single-shape IFFT.

Slots are allocated monotonically within a step and never reused until the
host emission layer has read retired ("tombstoned") slots and freed them
between steps; slot exhaustion drops new channels with a counter (the
reference's philosophy of clamp/skip + log rather than dying,
reference: lib/SegmentDetection_impl.cc:298-308).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from fdc_tpu.config import SegmentGeometry, solve_segment
from fdc_tpu.ops.detect import (
    candidate_geometry,
    cell_power,
    detect_candidates,
    detect_candidates_batch,
    match_candidates,
)
from fdc_tpu.ops.extract import extract_dynamic
from fdc_tpu.ops.lifecycle_pallas import (
    resolve_backend,
    slot_lifecycle,
    slot_lifecycle_multi,
)
from fdc_tpu.ops.windows import flank_window_bank

__all__ = ["SegmentDetector", "scan_slots_multi"]


def _compact_front(groups, keep, width):
    """Order-preserving compaction of [B, K] columns under ``keep`` into
    the first ``width`` columns, by exact integer indexing. Returns
    (compacted groups [B, width] each, zero where no candidate landed;
    compacted validity [B, width])."""
    rank = jnp.cumsum(keep.astype(jnp.int32), axis=1) - 1  # [B, K]
    sel = (
        (rank[:, None, :] == jnp.arange(width, dtype=jnp.int32)[None, :, None])
        & keep[:, None, :]
    )  # [B, width, K]: output column p <- input column k
    src = jnp.argmax(sel, axis=2)
    valid = jnp.any(sel, axis=2)
    taken = [
        jnp.where(valid, jnp.take_along_axis(grp, src, axis=1), 0)
        for grp in groups
    ]
    return taken, valid


class SegmentDetector:
    """One detection segment with an S-slot dynamic channel table."""

    def __init__(
        self,
        segment_id: int,
        blocksize: int,
        relinvovl: int,
        seg_start: float,
        seg_stop: float,
        thresh_db: float,
        minchandist: float,
        window_flank_puffer: float,
        channel_deactivation_delay: int = 1,
        max_slots: int = 32,
        max_candidates: int = 0,
        max_extract_width: int = 0,
        geometry: SegmentGeometry = None,
        lifecycle_backend: str = "auto",
        extract_budget: int = 0,
        vcm: bool = False,
        use_mxu: bool = False,
        extract_width_split: int = 0,
        extract_budget_narrow: int = 0,
        core_bins=None,
    ):
        if thresh_db < 0.0:
            raise ValueError("Threshold is dB and must be >= 0")
        if window_flank_puffer < 0.0:
            raise ValueError("window_flank_puffer must be >= 0")
        self.segment_id = segment_id
        self.blocksize = blocksize
        self.relinvovl = relinvovl
        # linear threshold (reference: lib/SegmentDetection_impl.cc:75-77)
        self.thresh = float(10.0 ** (thresh_db / 10.0))
        self.flank_puffer = float(window_flank_puffer)
        self.deactivation_delay = int(channel_deactivation_delay)
        self.max_slots = int(max_slots)
        self.max_candidates = int(max_candidates)  # 0 = exact (all edges)
        # Device-side output compaction: only `extract_budget` slots' rows
        # are extracted and shipped per step (0 = all slots). The reference
        # only ever materializes ACTIVE channels' samples
        # (reference: lib/SegmentDetection_impl.cc:399-429); a fixed budget
        # is the static-shape equivalent — slots with no activity this step
        # are skipped, overflow beyond the budget is counted and logged.
        self.extract_budget = min(
            int(extract_budget) or self.max_slots, self.max_slots
        )
        # optional second, NARROWER extraction bucket: slots whose width
        # fits extract_width_split ship from a [E_narrow, B+1, W_split]
        # tensor instead of paying the full w_cap-wide IFFT (pod-scale
        # configs detect mostly narrow carriers); narrow overflow spills
        # into the wide bucket
        self.extract_width_split = int(extract_width_split)
        # like the wide budget, never more rows than the slot table has
        self.extract_budget_narrow = min(
            int(extract_budget_narrow), self.max_slots
        )
        if self.extract_width_split:
            w = self.extract_width_split
            if w & (w - 1) or not 0 < w < (int(max_extract_width) or blocksize):
                raise ValueError(
                    "extract_width_split must be a power of 2 below "
                    "max_extract_width"
                )
            if self.extract_budget_narrow <= 0:
                raise ValueError(
                    "extract_width_split requires extract_budget_narrow > 0"
                )
            self.split_log2 = int(math.log2(w))
        self.w_cap = int(max_extract_width) or blocksize
        if self.w_cap & (self.w_cap - 1):
            raise ValueError("max_extract_width must be a power of 2")
        self.w_cap = min(self.w_cap, blocksize)
        self.w_cap_log2 = int(math.log2(self.w_cap))

        if lifecycle_backend not in ("auto", "scan", "pallas", "pallas_interpret"):
            raise ValueError(f"unknown lifecycle_backend {lifecycle_backend!r}")
        self.lifecycle_backend = lifecycle_backend
        # vcm semantics (activity_detection_channelizer_vcm): 1/decimation
        # power normalization and FLT_MIN zero-denominator edge ratios
        # (reference: lib/activity_detection_channelizer_vcm_impl.cc:630-650,
        # 701-705); False = SegmentDetection semantics.
        self.vcm = bool(vcm)
        self.use_mxu = bool(use_mxu)  # matmul-DFT subband transforms

        self.geometry: SegmentGeometry = geometry or solve_segment(
            blocksize, seg_start, seg_stop, minchandist
        )
        # Candidate ownership window for split segments
        # (config.split_segment_geometry): only candidates whose
        # extraction midpoint bin falls in [core_bins) survive detection
        # here — the overlap margin beyond the core is scanned (so edge
        # ratios and the greedy acceptance see the same neighborhood the
        # unsplit parent would) but owned by the neighboring part.
        self.core_bins = None
        if core_bins is not None:
            lo, hi = int(core_bins[0]), int(core_bins[1])
            g = self.geometry
            if not g.start <= lo < hi <= g.stop:
                raise ValueError(
                    f"core_bins {core_bins} outside segment "
                    f"[{g.start}, {g.stop})"
                )
            self.core_bins = (lo, hi)

        # K for edge DETECTION (0 = exact: every ratio position) vs K for
        # the candidate PACK the lifecycle consumes. The greedy non-overlap
        # acceptance bounds the survivors: every accepted interval [s, e)
        # has e - s >= 2 (a rise and a fall cannot share a ratio index for
        # thresh >= 1) and accepted intervals are disjoint within the
        # n_cells - 1 ratio span, so at most (n_cells - 1) // 2 candidates
        # are ever valid per block. Compacting them to the front
        # (order-preserving) and truncating the pack to k_pack is therefore
        # BIT-EXACT — and it is what keeps exact all-edges mode
        # (max_candidates=0, reference lib/SegmentDetection_impl.cc:208-243)
        # from paying kernel work quadratic in n_cells.
        self.k_detect = self.max_candidates or (self.geometry.n_cells - 1)
        # The (n_cells-1)//2 pack bound is only valid when thresh >= 1
        # (a rise and a fall can share a ratio index for thresh < 1);
        # thresh_db >= 0 is checked above — tie the invariant to the
        # derivation that relies on it.
        assert self.thresh >= 1.0, "k_pack bound requires thresh >= 1"
        self.k_pack = min(
            self.k_detect, max(1, (self.geometry.n_cells - 1) // 2)
        )

        # Window table for every power-of-2 width <= w_cap, phase-0 copies,
        # zero-padded to w_cap (reference builds all widths x all phases,
        # lib/SegmentDetection_impl.cc:551-583; phases factor out — see
        # fdc_tpu/ops/extract.py).
        table = np.zeros((self.w_cap_log2 + 1, self.w_cap), np.float32)
        for s in range(self.w_cap_log2 + 1):
            w = 1 << s
            table[s, :w] = flank_window_bank(w, relinvovl, self.flank_puffer)[
                0
            ].real
        self.window_table = table

    # -- state ----------------------------------------------------------------

    def init_state(self):
        s = self.max_slots
        return {
            "active": jnp.zeros((s,), bool),
            "tomb": jnp.zeros((s,), bool),
            "det_start": jnp.zeros((s,), jnp.int32),
            "det_stop": jnp.zeros((s,), jnp.int32),
            "ext_start": jnp.zeros((s,), jnp.int32),
            "wlog2": jnp.zeros((s,), jnp.int32),
            "phase": jnp.zeros((s,), jnp.int32),
            "phase_inc": jnp.zeros((s,), jnp.int32),
            "inactive": jnp.zeros((s,), jnp.int32),
            "order": jnp.zeros((s,), jnp.int32),  # channel ID (activation seq)
            "alloc_counter": jnp.int32(0),
            "dropped": jnp.int32(0),  # channels lost to slot/width limits
        }

    # -- device step ----------------------------------------------------------

    def measure(self, spectrum: jax.Array, sq: jax.Array = None) -> jax.Array:
        """[B, N] spectra -> [B, n_cells] decimated segment power
        (reference: lib/SegmentDetection_impl.cc:178-193). Pass ``sq``
        (= |spectrum|²) when already computed to share the power pass."""
        if sq is None:
            sq = jnp.abs(spectrum) ** 2
        g = self.geometry
        p = cell_power(sq, g.start, g.n_cells, g.decimation)
        if self.vcm:
            # vcm normalizes cell power by 1/decimation (reference:
            # lib/activity_detection_channelizer_vcm_impl.cc:630-650); the
            # factor cancels in the edge ratios but is kept for bit-faithful
            # power observability and threshold rounding behavior.
            p = p * jnp.float32(1.0 / g.decimation)
        return p

    def _resolved_backend(self) -> str:
        return resolve_backend(self.lifecycle_backend)

    def _packed_candidates(self, power: jax.Array):
        """[B, n_cells] powers -> ([B, 7K] packed candidate rows, K).

        Candidates for ALL blocks at once (per-block independent). The
        greedy acceptance is K steps, each VECTORIZED over all B blocks
        (inside the lifecycle kernel it would land on the serial
        per-block chain: B*K sequential steps instead of K). Candidate
        geometry is slot-table-independent too: batch-compute it over
        [B, K] HERE rather than on the kernel's serial chain, and pack all
        7 candidate vectors into one [B, 7K] array.
        """
        g = self.geometry
        # 0 = exact: every ratio position is a potential rising edge, so
        # K = n_cells - 1 covers ALL of them — identical semantics to the
        # reference's unbounded edge list
        # (reference: lib/SegmentDetection_impl.cc:208-243).
        k = self.k_detect
        cand_s, cand_e, cand_v = detect_candidates_batch(
            power, self.thresh, k, zero_floor=self.vcm,
            interpret=(self._resolved_backend() == "pallas_interpret"),
        )  # each [B, K], cell coords
        # NOTE (split segments): the pack keeps EVERY accepted candidate
        # in the scan region, including the overlap margin — candidate
        # OWNERSHIP (the core_bins midpoint rule) is enforced by
        # reconcile_split in the scan stage, which knows the slot tables
        # and so can distinguish refresh candidates (kept regardless of
        # ownership) from spawn candidates (core-owned only).
        # Compact accepted candidates to the front, order-preserving,
        # ALWAYS: the greedy acceptance leaves invalid holes between
        # accepted rows. Truncating to k_pack rows is bit-exact (see
        # __init__: at most (n_cells - 1) // 2 survive the greedy
        # acceptance).
        kp = self.k_pack
        (cand_s, cand_e), cand_v = _compact_front(
            (cand_s, cand_e), cand_v, kp
        )
        k = kp
        cand_s = cand_s * g.decimation + g.start  # -> bin coords
        cand_e = cand_e * g.decimation + g.start
        wl2, es, too_big = candidate_geometry(
            cand_s, cand_e, puffer=self.flank_puffer, w_cap=self.w_cap,
            w_cap_log2=self.w_cap_log2, n=self.blocksize,
        )
        packed = jnp.concatenate(
            [
                cand_s, cand_e, cand_v.astype(jnp.int32),
                wl2, es, es % self.relinvovl, too_big.astype(jnp.int32),
            ],
            axis=1,
        )  # [B, 7K]
        return packed, k

    def _recompact_pack(self, packed: jax.Array, keep: jax.Array):
        """Order-preserving re-compaction of a [B, 7K] candidate pack
        under a new validity mask ``keep`` [B, K] (candidate filtering
        after packing must keep the valid-first pack layout)."""
        k = self.k_pack
        groups = [packed[:, j * k:(j + 1) * k] for j in range(7)]
        taken, valid = _compact_front(groups, keep, k)
        taken[2] = valid.astype(packed.dtype)
        return jnp.concatenate(taken, axis=1)

    def reconcile_split(self, state, packed, kill_from, suppress_from):
        """Split-part pre-scan reconciliation (the cut contract).

        Lagged-neighbor semantics: ``kill_from`` / ``suppress_from`` hold
        adjacent parts' slot-interval tables as of the END OF THE PREVIOUS
        BATCH (each a tuple ``(det_start [S_f], det_stop [S_f],
        live [S_f])``) — identical across plain / sharded / pipeline
        topologies, so event parity between them is preserved.

        Three rules make the cuts behave like the interior (closing the
        double-spawn race that candidate-midpoint jitter at a cut opens —
        a burst transient's candidate can land its midpoint on the other
        side of the cut from the steady-state candidate):

        1. KILL (lower part wins): a live local slot whose detection
           interval overlaps a live slot of the LOWER neighbor is
           discarded silently — no emission, flagged ``killed`` so the
           host emitters drop its buffered samples. Duplicates only
           arise from the one-batch race window, so the killed slot's
           twin holds the full burst.
        2. REFRESH PRIORITY: a candidate overlapping a live LOCAL slot
           is always kept (regardless of whose core its midpoint is in)
           — slots keep being refreshed by their carrier even when its
           candidates jitter across the cut. Slots spawned EARLIER IN
           THIS BATCH are covered by the batch-local chain closure: a
           candidate overlapping an earlier block's kept candidate is
           kept too (the stationary-carrier chain a per-block slot-table
           view would produce).
        3. SPAWN OWNERSHIP: any other candidate survives only if its
           midpoint bin lies in this part's half-open core (``core_bins``)
           AND it overlaps no live FOREIGN slot (the carrier is already
           tracked by the neighbor; matching it here would re-spawn the
           duplicate every batch).

        Deviations vs the unsplit segment are bounded by the one-batch
        lag (a same-batch midpoint-jitter duplicate lives for one batch,
        then dies silently; a slot dying at a cut suppresses a successor
        spawn for at most one extra batch; a burst whose FIRST candidate
        lands in the neighbor's core starts up to one block later) and
        by the overlap margin (see config.split_segment_geometry).

        Returns ``(state', packed', killed [S] bool)``.
        """
        killed = jnp.zeros((self.max_slots,), bool)
        new_state = state
        if kill_from:
            live = state["active"] & ~state["tomb"]
            ov = jnp.zeros((self.max_slots,), bool)
            for fds, fde, flive in kill_from:
                # slot-vs-slot overlap, the candidate-match convention
                # (start < stop && stop >= start; see match_candidates)
                o = (
                    (state["det_start"][:, None] < fde[None, :])
                    & (state["det_stop"][:, None] >= fds[None, :])
                    & flive[None, :]
                )
                ov = ov | jnp.any(o, axis=1)
            killed = live & ov
            new_state = {**state, "active": state["active"] & ~killed}
        if self.core_bins is not None:
            k = self.k_pack
            cs = packed[:, 0 * k:1 * k]
            ce = packed[:, 1 * k:2 * k]
            cv = packed[:, 2 * k:3 * k] != 0
            # the same midpoint bin candidate_geometry centers on
            # (reference lib/SegmentDetection_impl.cc:290-344)
            mid = cs + (ce - cs) // 2
            lo, hi = self.core_bins
            in_core = (mid >= lo) & (mid < hi)
            # Everything below runs in CELL-MASK form on the part's C
            # cells: candidate intervals as [B, K, C] cell memberships
            # (computed once, shared by every test) and slot tables as
            # [C] coverage masks. All values are cell-aligned bins, so
            # the interval-overlap convention (cand cs < slot de AND
            # cand ce >= slot ds, the match_candidates rule) is EXACTLY
            # "candidate cells intersect slot cells extended one cell
            # down": [cs, ce) ∩ [ds - dec, de) != ∅. This form is a few
            # fused elementwise passes instead of [B, K, S_f] interval
            # tensors.
            g = self.geometry
            dec = g.decimation
            c_n = g.n_cells
            cell_bins = (
                g.start
                + jnp.arange(c_n, dtype=jnp.int32) * g.decimation
            )
            in_int = (
                (cell_bins[None, None, :] >= cs[:, :, None])
                & (cell_bins[None, None, :] < ce[:, :, None])
            )  # [B, K, C]

            def slot_cover(ds, de, live_mask):
                return jnp.any(
                    live_mask[:, None]
                    & (cell_bins[None, :] >= ds[:, None] - dec)
                    & (cell_bins[None, :] < de[:, None]),
                    axis=0,
                )  # [C]

            live = new_state["active"] & ~new_state["tomb"]
            loc_cover = slot_cover(
                new_state["det_start"], new_state["det_stop"], live
            )
            f_cover = jnp.zeros((c_n,), bool)
            for fds, fde, flive in suppress_from:
                f_cover = f_cover | slot_cover(fds, fde, flive)
            local_ov = jnp.any(
                in_int & loc_cover[None, None, :], axis=2
            )  # [B, K]
            f_ov = jnp.any(in_int & f_cover[None, None, :], axis=2)
            keep0 = cv & (local_ov | (in_core & ~f_ov))
            # batch-local spawn-chain closure (rule 2, same-batch case):
            # a candidate overlapping ANY earlier block's kept candidate
            # refreshes a slot spawned this batch — keep it. One hop
            # suffices for stationary carriers (every later candidate
            # overlaps the first kept one). Exclusive prefix-OR over
            # blocks.
            covered = jnp.any(
                in_int & keep0[:, :, None], axis=1
            ).astype(jnp.int32)  # [B, C]
            earlier = (jnp.cumsum(covered, axis=0) - covered) > 0  # [B, C]
            chain_ov = jnp.any(
                in_int & earlier[:, None, :], axis=2
            )  # [B, K]
            keep = keep0 | (cv & chain_ov)
            packed = self._recompact_pack(packed, keep)
        return new_state, packed, killed

    @staticmethod
    def split_foreign_view(state):
        """The tiny slot-interval table a split part publishes to its
        neighbors for :meth:`reconcile_split` (det bounds + liveness)."""
        return (
            state["det_start"],
            state["det_stop"],
            state["active"] & ~state["tomb"],
        )

    def scan_slots(self, power: jax.Array, state, packed=None):
        """Detection + slot-table lifecycle scan over [B, n_cells] powers.

        The cheap sequential part of the step, separated out so the parallel
        layer can run it replicated on all-gathered powers while extraction
        stays sharded. Returns (new_state, (activated, processed, emit,
        phase_used)) — all flags [B, S] in scan order.

        ``packed`` (optional, [B, 7K] from :meth:`_packed_candidates`)
        skips the candidate detection: it is per-block independent and
        slot-table-free, so distributed callers detect WHERE THE POWERS
        LIVE (each time shard / pipeline worker packs its own blocks) and
        only the tiny candidate rows travel to the scan.
        """
        g = self.geometry
        r = self.relinvovl
        n = self.blocksize
        dec = g.decimation
        d_start = g.start
        delay = self.deactivation_delay
        thresh = self.thresh
        puffer = self.flank_puffer

        backend = self._resolved_backend()
        if backend in ("pallas", "pallas_interpret"):
            if packed is None:
                packed, _ = self._packed_candidates(power)
            # tombstones are freed in the kernel (same semantics as
            # _free_tombstones on the lax.scan path)
            return slot_lifecycle(
                packed, state,
                n_cand=self.k_pack, r=r, delay=delay,
                interpret=(backend == "pallas_interpret"),
            )

        # lax.scan reference path (see _packed_candidates for why the
        # candidate detection batches over [B, K] outside the scan)
        if packed is not None:
            # pre-packed candidates (the time-sharded / pipeline callers
            # detect per block where the powers live): the first three
            # column groups ARE (cand_s, cand_e, valid) in bin coords
            # at the COMPACTED k_pack width (see _packed_candidates);
            # the geometry columns are re-derived by the scan body
            # (identical candidate_geometry arithmetic)
            k = self.k_pack
            cand_s = packed[:, 0 * k:1 * k]
            cand_e = packed[:, 1 * k:2 * k]
            cand_v = packed[:, 2 * k:3 * k] != 0
        else:
            k = self.k_detect
            cand_s, cand_e, cand_v = jax.vmap(
                lambda p: detect_candidates(
                    p, thresh, k, zero_floor=self.vcm
                )
            )(power)  # each [B, K], cell coords
            cand_s = cand_s * dec + d_start  # -> bin coords
            cand_e = cand_e * dec + d_start

        def scan_body(carry, cand):
            (
                active,
                tomb,
                det_start,
                det_stop,
                ext_start,
                wlog2,
                phase,
                phase_inc,
                inactive,
                order,
                alloc_counter,
                dropped,
            ) = carry

            live = active & ~tomb
            cs, ce, c_v = cand

            # 2. match against live slots; age unmatched
            refreshed, consumed = match_candidates(
                cs, ce, c_v, live, det_start, det_stop, order
            )
            inactive = jnp.where(
                live, jnp.where(refreshed, 0, inactive + 1), inactive
            )

            # 3. new-channel geometry + in-band clamp
            # (reference: lib/SegmentDetection_impl.cc:290-344)
            new_mask = c_v & ~consumed
            wl2, es, too_big = candidate_geometry(
                cs, ce, puffer=puffer, w_cap=self.w_cap,
                w_cap_log2=self.w_cap_log2, n=n,
            )
            new_ok = new_mask & ~too_big

            # 4. allocate free slots in index order, candidates in
            #    acceptance order (reference activation order)
            free = ~active & ~tomb
            rank = jnp.cumsum(new_ok.astype(jnp.int32)) - 1  # [K]
            free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1  # [S]
            assign = (
                free[:, None]
                & new_ok[None, :]
                & (free_rank[:, None] == rank[None, :])
            )  # [S, K] (at most one true per row and per column)
            got = jnp.any(assign, axis=1)  # [S]
            cand_of_slot = jnp.argmax(assign, axis=1)  # [S]

            n_free = free.sum()
            n_new = new_ok.sum()
            n_alloc = jnp.minimum(n_new, n_free)
            dropped = (
                dropped
                + (n_new - n_alloc)
                + (new_mask & too_big).sum().astype(jnp.int32)
            )

            def pick(arr_k, current):
                return jnp.where(got, arr_k[cand_of_slot], current)

            active = active | got
            det_start = pick(cs, det_start)
            det_stop = pick(ce, det_stop)
            ext_start = pick(es, ext_start)
            wlog2 = pick(wl2, wlog2)
            phase_inc = pick(es % r, phase_inc)
            inactive = jnp.where(got, 0, inactive)
            order = jnp.where(
                got, alloc_counter + rank[cand_of_slot], order
            )
            alloc_counter = alloc_counter + n_alloc

            # 5. processing / retiring flags for this block
            live = active & ~tomb
            emit_now = live & ~got & (inactive > delay)
            tomb = tomb | emit_now
            processed = live & ~emit_now
            phase_used = jnp.where(got, phase_inc, phase)
            phase = jnp.where(
                got,
                (2 * phase_inc) % r,
                jnp.where(processed, (phase + phase_inc) % r, phase),
            )

            new_carry = (
                active,
                tomb,
                det_start,
                det_stop,
                ext_start,
                wlog2,
                phase,
                phase_inc,
                inactive,
                order,
                alloc_counter,
                dropped,
            )
            return new_carry, (got, processed, emit_now, phase_used)

        keys = (
            "active",
            "tomb",
            "det_start",
            "det_stop",
            "ext_start",
            "wlog2",
            "phase",
            "phase_inc",
            "inactive",
            "order",
            "alloc_counter",
            "dropped",
        )
        init = tuple(state[kk] for kk in keys)
        final, flags = jax.lax.scan(
            scan_body, init, (cand_s, cand_e, cand_v)
        )
        return self._free_tombstones(dict(zip(keys, final))), flags

    @staticmethod
    def _free_tombstones(state):
        """Recycle retired slots at step end, ON DEVICE.

        The host emission layer consumes every tombstoned slot's burst from
        this step's outputs unconditionally, so freeing is deterministic and
        needs no host round-trip: a slot emitted during the step stays
        tombstoned until the scan finishes (it cannot be re-allocated
        mid-step, preserving per-step-constant slot geometry for the batched
        extraction), then becomes free for the next step — the same timing
        the host-side recycle had. The slot's geometry values (ext_start,
        wlog2, order) are left in place; they are only overwritten at the
        next allocation, so the host emitters can still read them from the
        step's slot_meta outputs.
        """
        tomb = state["tomb"]
        return {
            **state,
            "active": state["active"] & ~tomb,
            "tomb": jnp.zeros_like(tomb),
        }

    def extract_plan(self, got, processed):
        """Device-side output compaction plan.

        Args:
          got/processed: [B, S] bool flags in scan order (from scan_slots).

        Returns (slot_ids [E] int32, overflow int32): the slots whose
        extraction rows this step ships (E = extract_budget), needy slots
        first in slot-index order, then idle slots as filler; ``overflow``
        counts needy slots beyond the budget (their samples are lost — the
        clamp/skip+log philosophy, the budget must cover the worst-case
        concurrent channel count). With the default budget E == max_slots
        the plan is the identity and nothing is dropped.
        """
        s = self.max_slots
        e = self.extract_budget
        if e >= s:
            return jnp.arange(s, dtype=jnp.int32), jnp.int32(0)
        # a slot needs extraction iff any block this step activated or
        # processed it (activation reads rows b and b+1, processing row b+1;
        # emission reads nothing)
        need = jnp.any(got | processed, axis=0)  # [S]
        # needy-first stable compaction: prefix-sum ranks give each slot
        # its target position; the inverse permutation is an argmax over
        # the position-match matrix (exact integer indexing)
        n_need = jnp.sum(need.astype(jnp.int32))
        rank_needy = jnp.cumsum(need.astype(jnp.int32)) - 1
        rank_idle = n_need + jnp.cumsum((~need).astype(jnp.int32)) - 1
        pos = jnp.where(need, rank_needy, rank_idle)  # [S] target position
        ids = jnp.argmax(
            pos[None, :] == jnp.arange(s, dtype=jnp.int32)[:, None], axis=1
        ).astype(jnp.int32)  # row p: the slot placed at p
        overflow = jnp.maximum(n_need - jnp.int32(e), 0)
        return ids[:e], overflow

    def extract_plan_split(self, got, processed, wlog2_state):
        """Two-bucket compaction plan (extract_width_split configured).

        Slots whose width fits the narrow bucket fill it first (slot-index
        order); remaining needy slots — wide ones and narrow overflow —
        fill the wide bucket. Unused plan entries are the out-of-range
        sentinel S (they extract zeros and are ignored by the emitters, so
        a needy-but-overflowed slot is never silently aliased to a filler
        row).

        Returns (ids_narrow [E_n], ids_wide [E_w], overflow int32).
        """
        s = self.max_slots
        e_n = self.extract_budget_narrow
        e_w = self.extract_budget
        need = jnp.any(got | processed, axis=0)  # [S]

        def pick(mask, budget):
            # chosen slots go to position rank[s] in index order;
            # unfilled rows get the sentinel S
            rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
            chosen = mask & (rank < budget)
            sel = chosen[None, :] & (
                rank[None, :] == jnp.arange(budget, dtype=jnp.int32)[:, None]
            )  # [budget, S]
            ids = jnp.where(
                jnp.any(sel, axis=1), jnp.argmax(sel, axis=1), s
            ).astype(jnp.int32)
            return chosen, ids

        narrow_ok = need & (wlog2_state <= self.split_log2)
        in_n, ids_n = pick(narrow_ok, e_n)
        in_w, ids_w = pick(need & ~in_n, e_w)
        overflow = (
            jnp.sum(need.astype(jnp.int32))
            - jnp.sum(in_n.astype(jnp.int32))
            - jnp.sum(in_w.astype(jnp.int32))
        )
        return ids_n, ids_w, overflow

    def extract_slots(self, spec_ext: jax.Array, state, slot_ids=None,
                      width: int = None, pairs: bool = False):
        """Batched variable-width extraction of the slots named by
        ``slot_ids`` ([E_local] int32, traced — an extract_plan slice) over
        every spectrum row; None extracts all slots. ``width`` selects the
        bucket width (default w_cap; pass extract_width_split for the
        narrow bucket — slots wider than the bucket extract zeros). The
        parallel layer shards the (heavy) extraction by passing each mesh
        chan rank its slice of the replicated plan. Returns
        [E_local, rows, width], phase 0."""
        w_bucket = width or self.w_cap
        if slot_ids is None:
            slot_ids = jnp.arange(self.max_slots, dtype=jnp.int32)
        # compacted slot geometry; sentinel ids (== max_slots) get
        # wlog2 = -1 and an all-zero window -> zero output
        valid = slot_ids < self.max_slots
        ids = jnp.minimum(slot_ids, self.max_slots - 1)
        ext_start = jnp.where(valid, state["ext_start"][ids], 0)
        wlog2 = jnp.where(valid, state["wlog2"][ids], jnp.int32(-1))
        n_tables = int(math.log2(w_bucket)) + 1
        table = jnp.asarray(self.window_table[:n_tables, :w_bucket])
        in_table = (wlog2 >= 0) & (wlog2 < n_tables)
        windows_pad = jnp.where(
            in_table[:, None], table[jnp.clip(wlog2, 0, n_tables - 1)], 0.0
        )
        return extract_dynamic(
            spec_ext, ext_start, wlog2, windows_pad, w_bucket,
            use_mxu=self.use_mxu, pairs=pairs,
        )

    def step(self, spec_ext: jax.Array, state):
        """Detect + extract over B blocks.

        Args:
          spec_ext: [B+1, N] normalized fftshifted spectra (row 0 = previous
            batch's last block).
          state: slot table, see init_state.

        Returns (new_state, outputs):
          activated/processed/emit: [S, B] bool — slot s was activated at
            block b (hist row b + current row b+1 enter its burst), was
            processed at block b (row b+1 enters), or aged out at block b
            (host finalizes its burst, blockend = global block index of b).
          phase_used: [S, B] int32 phase of each processed block.
          extract: [E, B+1, w_cap] complex phase-0 extraction of the rows
            named by slot_ids (leading 2**wlog2 samples valid, w-periodic
            after); E = extract_budget (== max_slots unless compaction is
            configured).
          slot_ids: [E] int32 extraction plan (extract row -> slot index).
          ext_overflow: int32 needy slots beyond the budget this step.
          slot_meta: {ext_start, wlog2, order} [S] snapshots for the host
            emitters (the carry itself never crosses to the host).
          power: [B, n_cells] decimated power spectrum (observability /
            waterfall).
          plus the final slot table in new_state (geometry is per-step
          constant per slot: slots are not reused within a step; retired
          slots are recycled on device at step end).
        """
        power = self.measure(spec_ext[1:])  # [B, nc]
        new_state, (got, processed, emit_now, phase_used) = self.scan_slots(
            power, state
        )
        outputs = {
            "activated": got.T,  # [S, B]
            "processed": processed.T,
            "emit": emit_now.T,
            "phase_used": phase_used.T,
            "slot_meta": {
                "ext_start": new_state["ext_start"],
                "wlog2": new_state["wlog2"],
                "order": new_state["order"],
            },
            "power": power,
        }
        if self.extract_width_split:
            ids_n, ids_w, overflow = self.extract_plan_split(
                got, processed, new_state["wlog2"]
            )
            outputs["extract"] = self.extract_slots(
                spec_ext, new_state, ids_w
            )
            outputs["slot_ids"] = ids_w
            outputs["extract_narrow"] = self.extract_slots(
                spec_ext, new_state, ids_n, width=self.extract_width_split
            )
            outputs["slot_ids_narrow"] = ids_n
            outputs["ext_overflow"] = overflow
        else:
            slot_ids, overflow = self.extract_plan(got, processed)
            outputs["extract"] = self.extract_slots(
                spec_ext, new_state, slot_ids
            )
            outputs["slot_ids"] = slot_ids
            outputs["ext_overflow"] = overflow
        return new_state, outputs


def scan_slots_multi(segments, powers, states, packed_list=None,
                     powact=None):
    """Lifecycle scans for multiple SegmentDetectors.

    Segments are independent automata (the reference runs one std::thread
    per segment, lib/activity_detection_channelizer_vcm_impl.cc:293-304);
    on the kernel backend all G scans run as G programs of ONE kernel
    launch. Bit-identical per segment to ``sd.scan_slots`` (same op
    sequence per segment, no cross-segment math). Segments on the
    ``lax.scan`` backend run ``scan_slots`` one by one.

    ``packed_list`` (optional, per-segment [B, 7K_g] rows from
    ``_packed_candidates``) skips the candidate detection — see
    :meth:`SegmentDetector.scan_slots`.

    ``powact`` (optional, ``(bank, pa_powers, pa_state)``) also runs the
    PowerActivationBank hysteresis automaton (its own ``scan_flags``);
    the return value then becomes ``(seg_results, (pa_new_state,
    pa_flags))``.

    Returns a list of (new_state, (activated, processed, emit,
    phase_used)) pairs, one per segment, flags [B, S_g] in scan order.
    """
    backends = {sd._resolved_backend() for sd in segments}
    if packed_list is None:
        packed_list = [None] * len(segments)
    if len(backends) == 1 and backends <= {"pallas", "pallas_interpret"}:
        packed = tuple(
            sd._packed_candidates(p)[0] if pk is None else pk
            for sd, p, pk in zip(segments, powers, packed_list)
        )
        seg_results = list(slot_lifecycle_multi(
            packed, tuple(states),
            n_cands=tuple(sd.k_pack for sd in segments),
            rs=tuple(sd.relinvovl for sd in segments),
            delays=tuple(sd.deactivation_delay for sd in segments),
            interpret=("pallas_interpret" in backends),
        ))
    else:
        seg_results = [
            sd.scan_slots(p, st, packed=pk)
            for sd, p, st, pk in zip(segments, powers, states, packed_list)
        ]
    if powact is None:
        return seg_results
    bank, pa_powers, pa_state = powact
    return seg_results, bank.scan_flags(pa_powers, pa_state)
