"""Detection primitives: in-band power measurement and carrier edge detection.

Fixed-shape, fully-batched re-expressions of the reference's sequential
detection code:

- ``band_power``: per-block in-band power sums for many bands at once as one
  |X|^2 matmul — replaces the per-channel scalar accumulation loop
  (reference: lib/PowerActivationChannel_impl.cc:286-306).
- ``cell_power``: decimated power spectrum over a segment
  (reference: lib/SegmentDetection_impl.cc:178-193).
- ``detect_candidates``: rising/falling power-edge pairing with
  strongest-first greedy overlap rejection, as static-shape top-k + masked
  scan (reference: lib/SegmentDetection_impl.cc:195-244).
- ``match_candidates``: refresh/age matching of candidates against an active
  slot table with the reference's first-match-consumes semantics
  (reference: lib/SegmentDetection_impl.cc:246-288).
- ``ceil_log2``: traced-integer next-power-of-2 exponent.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

__all__ = [
    "band_power",
    "cell_power",
    "detect_edges",
    "detect_candidates",
    "detect_candidates_batch",
    "greedy_accept_batch",
    "candidate_geometry",
    "match_candidates",
    "ceil_log2",
]

_BIG = jnp.int32(2**30)


def band_power(spectrum_sq: jax.Array, band_masks: jax.Array) -> jax.Array:
    """Per-band power sums: [B, N] |X|^2 x [N, C] 0/1 masks -> [B, C].

    One matmul replaces C scalar accumulation loops
    (reference: lib/PowerActivationChannel_impl.cc:286-306). Full float32
    precision: a rounded power can flip a burst decision that sits near
    its threshold.
    """
    return jnp.dot(
        spectrum_sq, band_masks, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )


def cell_power(
    spectrum_sq: jax.Array, start: int, n_cells: int, decimation: int
) -> jax.Array:
    """Decimated power spectrum over one segment.

    spectrum_sq: [B, N] |X|^2. Returns [B, n_cells] with
    cell[i] = sum over bins [start + i*dec, start + (i+1)*dec)
    (reference: lib/SegmentDetection_impl.cc:178-193).
    """
    seg = jax.lax.slice_in_dim(
        spectrum_sq, start, start + n_cells * decimation, axis=1
    )
    return seg.reshape(spectrum_sq.shape[0], n_cells, decimation).sum(axis=-1)


def ceil_log2(v: jax.Array, max_log2: int) -> jax.Array:
    """ceil(log2(v)) for traced positive int32 v, exact integer arithmetic.

    Counts powers of two strictly below v (static unrolled sum, max_log2+1
    terms)."""
    v = v.astype(jnp.int32)
    acc = jnp.zeros_like(v)
    for j in range(max_log2 + 1):
        acc = acc + (v > (1 << j)).astype(jnp.int32)
    return acc


_FLT_MIN = jnp.float32(1.1754944e-38)


def detect_edges(
    power: jax.Array,
    thresh: float,
    max_candidates: int,
    zero_floor: bool = False,
):
    """Rising/falling edge pairing WITHOUT the greedy overlap rejection.

    The strength-sorted candidate list (strongest rising edge first, each
    paired with the nearest following falling edge) that the reference
    builds before its sequential accept loop
    (reference: lib/SegmentDetection_impl.cc:195-230). The greedy
    acceptance is applied by :func:`detect_candidates` /
    :func:`greedy_accept_batch`; the lifecycle kernel expects its
    candidates PRE-ACCEPTED, so do not feed detect_edges output to it
    directly.

    Returns (cand_s, cand_e, has_pair): [K] int32 cell coordinates in
    strength order and the paired-validity mask.
    """
    n_cells = power.shape[0]
    n_r = n_cells - 1
    k = max_candidates
    # a segment can have fewer ratio cells than the candidate cap
    k_eff = min(k, n_r)

    if zero_floor:
        ratio = jnp.where(
            power[:-1] == 0.0, power[1:] / _FLT_MIN, power[1:] / power[:-1]
        )
    else:
        ratio = power[1:] / power[:-1]  # [n_r]
    rise = ratio > thresh
    fall = ratio < (1.0 / thresh)

    # next falling edge at ratio-index >= i (upper_bound equivalent):
    idx = jnp.arange(n_r, dtype=jnp.int32)
    fall_idx = jnp.where(fall, idx, _BIG)
    # reversed cumulative min -> nearest fall at or after each position
    next_fall = jnp.flip(jax.lax.cummin(jnp.flip(fall_idx)))

    # strongest-first rising edges. An infinite ratio (signal next to an
    # exactly-zero cell, e.g. zero-padded input) is a VALID rise and ranks
    # strongest, matching the reference's pwr[i+1]/pwr[i] > v comparison
    # (reference: lib/SegmentDetection_impl.cc:203-207) — so validity is
    # "> thresh", not isfinite.
    rise_strength = jnp.where(rise, ratio, -jnp.inf)
    if k_eff == n_r:
        # exact all-edges mode: the "top k of k" is a full sort. A total
        # strength order over n_r elements as a comparison matrix:
        # rank_j = #{i stronger than j} (ties by lower index, exactly
        # lax.top_k's stable order); the inverse permutation is an argmax
        # over the rank-match matrix (exact integer indexing).
        s_i = rise_strength[:, None]  # compared-to
        s_j = rise_strength[None, :]  # ranked
        stronger = (s_i > s_j) | (
            (s_i == s_j) & (idx[:, None] < idx[None, :])
        )
        rank = jnp.sum(stronger.astype(jnp.int32), axis=0)  # [n_r]
        top_i = jnp.argmax(
            rank[None, :] == idx[:, None], axis=1
        ).astype(jnp.int32)  # [k_eff]: position p holds the rank-p edge
        has_rise = rise[top_i]
    else:
        top_val, top_i = jax.lax.top_k(rise_strength, k_eff)  # [k_eff]
        has_rise = top_val > jnp.float32(thresh)
    nf = jnp.minimum(next_fall, n_r)[top_i]
    has_pair = has_rise & (nf < n_r)

    cand_s = top_i.astype(jnp.int32)  # start cell (the low cell before rise)
    cand_e = (nf + 1).astype(jnp.int32)  # end cell (exclusive)
    if k_eff < k:  # pad back to the static candidate shape
        pad = k - k_eff
        cand_s = jnp.pad(cand_s, (0, pad))
        cand_e = jnp.pad(cand_e, (0, pad))
        has_pair = jnp.pad(has_pair, (0, pad))
    return cand_s, cand_e, has_pair


def _greedy_accept_kernel(cs_ref, ce_ref, hp_ref, out_ref, *, k, rows):
    """Greedy non-overlap acceptance for ``rows`` blocks of one tile.

    Candidates in strength order along the columns; each of the K steps
    tests candidate j of every block against the accepted set so far,
    which stays in registers for the whole chain."""
    b0 = pl.program_id(0) * rows
    blk = pl.ds(b0, rows)
    cs = cs_ref[blk, :]  # [rows, Kp]
    ce = ce_ref[blk, :]
    col = jax.lax.broadcasted_iota(jnp.int32, cs.shape, 1)
    acc = jnp.zeros(cs.shape, jnp.int32)
    for j in range(k):
        cs_j = cs_ref[blk, j]  # [rows]
        ce_j = ce_ref[blk, j]
        ov = (cs_j[:, None] < ce) & (ce_j[:, None] >= cs)
        blocked = jnp.max(jnp.where(ov, acc, 0), axis=1)  # [rows]
        accept = (hp_ref[blk, j] != 0) & (blocked == 0)
        acc = jnp.where((col == j) & accept[:, None], 1, acc)
    out_ref[blk, :] = acc


def _greedy_accept_pallas(cand_s, cand_e, has_pair, interpret=False):
    b, k = cand_s.shape
    rows = 32
    kp = max(16, 1 << max(0, k - 1).bit_length())
    bp = -(-b // rows) * rows
    pad = ((0, bp - b), (0, kp - k))
    ins = [
        jnp.pad(a.astype(jnp.int32), pad)
        for a in (cand_s, cand_e, has_pair)
    ]
    out = pl.pallas_call(
        functools.partial(_greedy_accept_kernel, k=k, rows=rows),
        out_shape=jax.ShapeDtypeStruct((bp, kp), jnp.int32),
        grid=(bp // rows,),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="greedy_accept",
    )(*ins)
    return out[:b, :k] != 0


def _greedy_accept_jnp(cand_s, cand_e, has_pair):
    # batched form of detect_candidates' unrolled loop
    b, k = cand_s.shape
    ov = (cand_s[:, :, None] < cand_e[:, None, :]) & (
        cand_e[:, :, None] >= cand_s[:, None, :]
    )  # [B, K(j), K(i)]
    acc_v = jnp.zeros((b, k), bool)
    eye = jnp.eye(k, dtype=bool)
    for j in range(k):
        overlap = jnp.any(acc_v & ov[:, j, :], axis=1, keepdims=True)
        acc_v = acc_v | (
            eye[j][None, :] & (has_pair[:, j:j + 1] & ~overlap)
        )
    return acc_v


def greedy_accept_batch(cand_s, cand_e, has_pair, interpret=False):
    """Batched greedy overlap rejection: [B, K] candidate intervals in
    strength order -> [B, K] accepted mask (exact reference semantics,
    identical to the per-block loop in :func:`detect_candidates`).
    One kernel on the GPU (or in interpret mode); the unrolled jnp loop
    elsewhere."""
    if interpret or jax.default_backend() == "gpu":
        return _greedy_accept_pallas(cand_s, cand_e, has_pair, interpret)
    return _greedy_accept_jnp(cand_s, cand_e, has_pair)


def detect_candidates_batch(
    power: jax.Array,
    thresh: float,
    max_candidates: int,
    zero_floor: bool = False,
    interpret: bool = False,
):
    """Batched :func:`detect_candidates` over [B, n_cells] powers with
    the greedy acceptance as one kernel (see greedy_accept_batch) —
    the hot-path form used by SegmentDetector._packed_candidates.
    Returns ([B, K] cand_s, cand_e, valid) in CELL coordinates."""
    k = max_candidates
    cand_s, cand_e, has_pair = jax.vmap(
        lambda p: detect_edges(p, thresh, k, zero_floor=zero_floor)
    )(power)
    acc_v = greedy_accept_batch(cand_s, cand_e, has_pair,
                                interpret=interpret)
    return (
        jnp.where(acc_v, cand_s, 0),
        jnp.where(acc_v, cand_e, 0),
        acc_v,
    )


def detect_candidates(
    power: jax.Array,
    thresh: float,
    max_candidates: int,
    zero_floor: bool = False,
    greedy_unroll: int = 64,
):
    """Edge-detect carrier candidates in one block's decimated power spectrum.

    Mirrors get_active_channels (reference: lib/SegmentDetection_impl.cc:195-244):
    adjacent-cell power ratios; rising edges (> thresh, recorded at the lower
    cell index i), falling edges (< 1/thresh, recorded at cell i+1); rising
    edges processed strongest-first, each paired with the nearest following
    falling edge, rejected if overlapping an already accepted candidate
    (overlap test: start < acc_end && end >= acc_start).

    Args:
      power: [n_cells] decimated power values of one block.
      thresh: linear power-ratio threshold (> 1).
      max_candidates: K, static number of rising edges considered,
        strongest first. With K >= n_cells - 1 (callers pass this for
        max_candidates=0 "exact" mode) every possible rising edge is
        considered — identical to the reference's unbounded edge list;
        smaller K bounds the work to the strongest-K subset.
      zero_floor: the multi-segment vcm block replaces a zero-power
        DENOMINATOR with FLT_MIN before dividing
        (reference: lib/activity_detection_channelizer_vcm_impl.cc:701-705),
        so 0/0 gives ratio 0 — a FALLING edge — where SegmentDetection's
        plain division gives NaN (no edge). False = SegmentDetection
        semantics.

    Returns:
      (cand_start, cand_end, cand_valid): [K] int32 cell coordinates
      (start inclusive, end exclusive, in CELL units) and validity mask,
      in acceptance (strength) order.
    """
    k = max_candidates
    cand_s, cand_e, has_pair = detect_edges(
        power, thresh, k, zero_floor=zero_floor
    )

    # greedy overlap rejection in strength order, exact reference test.
    # Small K unrolls statically: candidate j only needs the accepted set
    # so far, so the chain needs no loop machinery. Larger K keeps the
    # lax.scan (``greedy_unroll`` is the threshold).
    if k <= greedy_unroll:
        # precompute the pairwise overlap matrix ONCE (fused elementwise);
        # the unrolled recurrence then only carries the accept vector and
        # each step is two ops (mask + any) plus a static one-hot OR —
        # no dynamic-update-slice per candidate
        ov = (cand_s[:, None] < cand_e[None, :]) & (
            cand_e[:, None] >= cand_s[None, :]
        )  # ov[j, i]: candidate j overlaps candidate i
        eye = jnp.eye(k, dtype=bool)
        acc_v = jnp.zeros(k, bool)
        for j in range(k):
            overlap = jnp.any(acc_v & ov[j])
            acc_v = acc_v | (eye[j] & (has_pair[j] & ~overlap))
        acc_s = jnp.where(acc_v, cand_s, 0)
        acc_e = jnp.where(acc_v, cand_e, 0)
        return acc_s, acc_e, acc_v

    def scan_body(carry, x):
        acc_s, acc_e, acc_v, j = carry
        s, e, ok = x
        overlap = jnp.any(acc_v & (s < acc_e) & (e >= acc_s))
        accept = ok & ~overlap
        acc_s = acc_s.at[j].set(jnp.where(accept, s, 0))
        acc_e = acc_e.at[j].set(jnp.where(accept, e, 0))
        acc_v = acc_v.at[j].set(accept)
        return (acc_s, acc_e, acc_v, j + 1), accept

    init = (
        jnp.zeros(k, jnp.int32),
        jnp.zeros(k, jnp.int32),
        jnp.zeros(k, bool),
        jnp.int32(0),
    )
    (acc_s, acc_e, acc_v, _), accepted = jax.lax.scan(
        scan_body, init, (cand_s, cand_e, has_pair)
    )
    return acc_s, acc_e, acc_v


def candidate_geometry(cand_s, cand_e, *, puffer: float, w_cap: int,
                       w_cap_log2: int, n: int):
    """New-channel geometry for candidate intervals (bin coordinates).

    Elementwise over any shape — the slot lifecycle uses it per block
    ([K], lax.scan path) and the Pallas path batch-computes it over [B, K]
    OUTSIDE the kernel (it does not depend on the slot table, so it has no
    place on the kernel's serial per-block chain).

    Mirrors the reference's activate() width/clamp math
    (reference: lib/SegmentDetection_impl.cc:290-344).

    Returns (wlog2, ext_start, too_big): extraction width exponent, clamped
    extraction start bin, and the over-w_cap rejection mask.
    """
    det_w = cand_e - cand_s
    ext_w_raw = jnp.ceil(
        det_w.astype(jnp.float32) * (1.0 + 2.0 * puffer)
    ).astype(jnp.int32)
    wl2 = ceil_log2(jnp.maximum(ext_w_raw, 1), w_cap_log2 + 1)
    ext_w = jnp.left_shift(jnp.int32(1), wl2)
    too_big = ext_w > w_cap

    mid = cand_s + det_w // 2
    es = mid - ext_w // 2
    ee = mid + ext_w // 2
    neg = es < 0
    es = jnp.where(neg, 0, es)
    ee = jnp.where(neg, ext_w, ee)
    over = ee > n
    es = jnp.where(over, n - ext_w, es)
    return wl2, es, too_big


def match_candidates(
    cand_start,
    cand_end,
    cand_valid,
    slot_active,
    slot_det_start,
    slot_det_stop,
    slot_order,
):
    """Match candidate intervals (bin coordinates) against the active slot table.

    Implements the reference's sequential consume-on-first-overlap semantics
    (reference: lib/SegmentDetection_impl.cc:246-288): channels are visited in
    activation order; each consumes every candidate overlapping it; consumed
    candidates are invisible to later channels. A slot is refreshed iff some
    candidate's *earliest-activated* overlapping slot is that slot.

    Args:
      cand_start/cand_end/cand_valid: [K] candidate bins (end exclusive... the
        reference's overlap test is start < det_stop && end >= det_start).
      slot_active: [S] bool (active and not tombstoned).
      slot_det_start/slot_det_stop: [S] int32 detection bounds.
      slot_order: [S] int32 activation sequence numbers (lower = earlier).

    Returns:
      (refreshed [S] bool, consumed [K] bool).
    """
    m = (
        slot_active[:, None]
        & cand_valid[None, :]
        & (cand_start[None, :] < slot_det_stop[:, None])
        & (cand_end[None, :] >= slot_det_start[:, None])
    )  # [S, K]

    order = jnp.where(slot_active, slot_order, _BIG)  # [S]
    order_m = jnp.where(m, order[:, None], _BIG)  # [S, K]
    first = jnp.argmin(order_m, axis=0)  # [K] slot index of earliest match
    consumed = jnp.any(m, axis=0)  # [K]

    s_idx = jnp.arange(slot_active.shape[0], dtype=jnp.int32)
    refreshed = jnp.any(
        m & (first[None, :] == s_idx[:, None]) & consumed[None, :], axis=1
    )
    return refreshed, consumed
