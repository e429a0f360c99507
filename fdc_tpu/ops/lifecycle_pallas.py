"""Pallas kernels (Triton route) for the sequential detection automata.

The detection slot lifecycle (match candidates -> refresh/age -> allocate
slots -> retire) and the burst hysteresis automaton are serial over blocks
but work on tiny vectors ([S] slots, [K] candidates, [C] burst channels).
As a ``lax.scan`` every block is one while-loop iteration that launches the
body's fusions, so a 512-block batch pays thousands of kernel launches.
These kernels walk the whole batch inside ONE launch instead, with
identical semantics to ``SegmentDetector.scan_slots``'s scan body
(reference behavior: lib/SegmentDetection_impl.cc:195-344) and
``PowerActivationBank.scan_flags`` (lib/PowerActivationChannel_impl.cc:
286-306).

Layout: one program per independent automaton. Segments are independent
(the reference runs one std::thread per segment,
lib/activity_detection_channelizer_vcm_impl.cc:293-304), so ``G`` segments
run as ``G`` programs of one kernel, each on its own SM. Every program
carries its slot table in registers through a ``fori_loop`` over blocks,
loads its own candidate rows and per-block counts from global memory, and
works on power-of-two padded tiles: candidates [Kp], slots [Sp], the match
matrix [Kp, Sp]. Padded candidate columns are invalid; padded slot lanes
enter as tombstones, so they are neither live nor free and never allocate.

Two closed forms shorten the serial chain on any machine:

- a CHUNK of blocks with no valid candidate is closed form (idle, or
  aging of live slots: a slot entering with age a0 retires at in-chunk
  block max(delay - a0, 0)), one [chunk, Sp] tile store per chunk;
- inside a walked chunk, a block without candidates takes the aging-only
  body (no match matrix, no allocation).

Candidates arrive PRE-ACCEPTED with their new-channel geometry
PRE-COMPUTED (``SegmentDetector._packed_candidates``): both are slot-table
independent and batch over [B, K] outside the kernel. Running the greedy
acceptance on the serial chain would cost B*K steps instead of K.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

__all__ = [
    "resolve_backend",
    "slot_lifecycle",
    "slot_lifecycle_multi",
    "powact_flags",
]

_BIG = 2**30
_N_STATE = 10  # active, tomb, det_start, det_stop, ext_start, wlog2,
#                phase, phase_inc, inactive, order


def resolve_backend(requested: str) -> str:
    """Resolve a ``lifecycle_backend`` setting to the implementation that
    runs: ``"auto"`` maps the default JAX platform to the kernel on the
    GPU and to the ``lax.scan`` reference on the CPU; any other platform
    raises. Explicit values (``"scan"``, ``"pallas"``, and the test-only
    ``"pallas_interpret"``) pass through unchanged."""
    if requested != "auto":
        return requested
    platform = jax.default_backend()
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "scan"
    raise RuntimeError(
        f"no lifecycle backend for platform {platform!r} (gpu or cpu)"
    )


def _pow2(n: int, floor: int = 16) -> int:
    return max(floor, 1 << max(0, int(n) - 1).bit_length())


def _num_warps(elems: int) -> int:
    # the [Kp, Sp] match matrix is the largest per-block tile; a warp
    # holds 32 lanes, so tiny tables want one warp (less cross-warp
    # reduction traffic on the serial chain)
    return max(1, min(8, elems // 1024))


def _age_closed(st, rows: int, delay, r):
    """Closed-form aging over ``rows`` candidate-free blocks.

    A live slot entering with age a0 is aged first, then emitted when its
    age exceeds ``delay``: it retires at in-run block j* = max(delay - a0,
    0), processes the blocks before it, and advances its phase once per
    processed block. Returns (flags [4 x [rows, Sp]], new state tuple)."""
    active, tomb, ds, de, es, wl, phase0, pinc, a0, order = st
    sp = active.shape[0]
    live0 = (active != 0) & (tomb == 0)
    jstar = jnp.maximum(delay - a0, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (rows, sp), 0)
    processed = live0[None, :] & (j < jstar[None, :])
    emit = live0[None, :] & (j == jstar[None, :])
    phase_used = jnp.where(
        live0[None, :],
        (phase0[None, :] + jnp.minimum(j, jstar[None, :]) * pinc[None, :])
        % r,
        phase0[None, :],
    )
    got = jnp.zeros((rows, sp), jnp.int32)
    n_steps = jnp.minimum(jstar, rows)
    tomb = jnp.where(live0 & (jstar < rows), 1, tomb)
    phase = jnp.where(live0, (phase0 + n_steps * pinc) % r, phase0)
    inactive = jnp.where(live0, a0 + jnp.minimum(jstar + 1, rows), a0)
    flags = (got, processed.astype(jnp.int32), emit.astype(jnp.int32),
             phase_used)
    new = (active, tomb, ds, de, es, wl, phase, pinc, inactive, order)
    return flags, new


def _lifecycle_kernel(
    cand_ref, nv_ref, cwork_ref, par_ref, st_ref, cnt_ref,
    o_st_ref, o_cnt_ref, o_flag_ref,
    *, n_blocks: int, chunk: int,
):
    """One program = one segment's slot lifecycle over the whole batch.

    Refs: cand [G, B, 7, Kp] (cand_start, cand_end, valid, wlog2,
    ext_start, ext_start % r, too_big per block, valid-first), nv [G, B]
    valid-candidate counts, cwork [G, n_chunks] per-chunk max counts,
    par [G, 2] (r, delay), state [G, 10, Sp], counters [G, 2]
    (alloc_counter, dropped). Outputs: state, counters, and one
    [G, 4, B, Sp] flag tensor (got, processed, emit, phase_used)."""
    g = pl.program_id(0)
    r = par_ref[g, 0]
    delay = par_ref[g, 1]

    def put_row(i, flags):
        for kind in range(4):
            o_flag_ref[g, kind, i, :] = flags[kind]

    def block_age(i, st):
        active, tomb, ds, de, es, wl, phase, pinc, inact, order = st
        live = (active != 0) & (tomb == 0)
        inact = jnp.where(live, inact + 1, inact)
        emit = live & (inact > delay)
        processed = live & ~emit
        put_row(i, (jnp.zeros_like(active), processed.astype(jnp.int32),
                    emit.astype(jnp.int32), phase))
        tomb = jnp.where(emit, 1, tomb)
        phase = jnp.where(processed, (phase + pinc) % r, phase)
        return (active, tomb, ds, de, es, wl, phase, pinc, inact, order)

    def block_full(i, st, cnt):
        active, tomb, ds, de, es_s, wl_s, phase, pinc, inact, order = st
        alloc, dropped = cnt
        cs = cand_ref[g, i, 0, :]  # [Kp] bin coords
        ce = cand_ref[g, i, 1, :]
        cv = cand_ref[g, i, 2, :] != 0
        wl2 = cand_ref[g, i, 3, :]
        es = cand_ref[g, i, 4, :]
        esr = cand_ref[g, i, 5, :]
        too_big = cand_ref[g, i, 6, :] != 0

        live = (active != 0) & (tomb == 0)
        # matching, first-match-consumes in activation order
        # (reference: lib/SegmentDetection_impl.cc:246-288); live slots
        # hold distinct orders, so "order == min" picks the one slot
        m = (
            live[None, :] & cv[:, None]
            & (cs[:, None] < de[None, :]) & (ce[:, None] >= ds[None, :])
        )  # [Kp, Sp]
        min_order = jnp.min(jnp.where(m, order[None, :], _BIG), axis=1)
        consumed = min_order < _BIG  # [Kp]
        hit = m & (order[None, :] == min_order[:, None])
        refreshed = jnp.max(hit.astype(jnp.int32), axis=0) > 0  # [Sp]
        inact = jnp.where(live, jnp.where(refreshed, 0, inact + 1), inact)

        # allocation: free slots in index order x new candidates in
        # acceptance order; masked sums instead of gathers
        new_mask = cv & ~consumed
        new_ok = new_mask & ~too_big
        free = (active == 0) & (tomb == 0)
        new_i = new_ok.astype(jnp.int32)
        free_i = free.astype(jnp.int32)
        rank = jnp.cumsum(new_i) - 1  # [Kp]
        free_rank = jnp.cumsum(free_i) - 1  # [Sp]
        a_i = (
            free[None, :] & new_ok[:, None]
            & (free_rank[None, :] == rank[:, None])
        ).astype(jnp.int32)  # [Kp, Sp], at most one hit per row/column
        got = jnp.max(a_i, axis=0) > 0

        def pick(arr_k, cur):
            return jnp.where(got, jnp.sum(a_i * arr_k[:, None], axis=0), cur)

        n_alloc = jnp.minimum(jnp.sum(new_i), jnp.sum(free_i))
        dropped = (
            dropped + (jnp.sum(new_i) - n_alloc)
            + jnp.sum((new_mask & too_big).astype(jnp.int32))
        )
        active = jnp.where(got, 1, active)
        ds = pick(cs, ds)
        de = pick(ce, de)
        es_s = pick(es, es_s)
        wl_s = pick(wl2, wl_s)
        pinc = pick(esr, pinc)
        inact = jnp.where(got, 0, inact)
        order = jnp.where(got, alloc + jnp.sum(a_i * rank[:, None], axis=0),
                          order)
        alloc = alloc + n_alloc

        # processing / retiring flags for this block
        live = (active != 0) & (tomb == 0)
        emit = live & ~got & (inact > delay)
        processed = live & ~emit
        put_row(i, (got.astype(jnp.int32), processed.astype(jnp.int32),
                    emit.astype(jnp.int32), jnp.where(got, pinc, phase)))
        tomb = jnp.where(emit, 1, tomb)
        phase = jnp.where(
            got, (2 * pinc) % r,
            jnp.where(processed, (phase + pinc) % r, phase),
        )
        st = (active, tomb, ds, de, es_s, wl_s, phase, pinc, inact, order)
        return st, (alloc, dropped)

    def walk(i, carry):
        return jax.lax.cond(
            nv_ref[g, i] > 0,
            lambda c: block_full(i, *c),
            lambda c: (block_age(i, c[0]), c[1]),
            carry,
        )

    carry = (
        tuple(st_ref[g, j, :] for j in range(_N_STATE)),
        (cnt_ref[g, 0], cnt_ref[g, 1]),
    )

    if chunk > 1:
        def chunk_body(c, carry):
            def closed(carry):
                flags, st = _age_closed(carry[0], chunk, delay, r)
                for kind in range(4):
                    o_flag_ref[g, kind, pl.ds(c * chunk, chunk), :] = (
                        flags[kind]
                    )
                return st, carry[1]

            def walked(carry):
                return jax.lax.fori_loop(
                    c * chunk, (c + 1) * chunk, walk, carry
                )

            return jax.lax.cond(cwork_ref[g, c] > 0, walked, closed, carry)

        carry = jax.lax.fori_loop(0, n_blocks // chunk, chunk_body, carry)
    else:
        carry = jax.lax.fori_loop(0, n_blocks, walk, carry)

    st, (alloc, dropped) = carry
    # step-end tombstone recycling (SegmentDetector._free_tombstones):
    # emitted slots stay tombstoned for the whole batch, then free here;
    # their geometry rows stay for the emitters' slot_meta reads
    active = jnp.where(st[1] != 0, 0, st[0])
    out = (active, jnp.zeros_like(st[1])) + tuple(st[2:])
    for j in range(_N_STATE):
        o_st_ref[g, j, :] = out[j]
    o_cnt_ref[g, 0] = alloc
    o_cnt_ref[g, 1] = dropped


@functools.partial(
    jax.jit,
    static_argnames=("n_cands", "rs", "delays", "chunk", "interpret"),
)
def slot_lifecycle_multi(
    cands, states, *, n_cands, rs, delays, chunk=32, interpret=False,
):
    """Run G segments' slot lifecycles over a batch, one program each.

    Args:
      cands: tuple of G [B, 7K_g] int32 arrays — per block the
        concatenation of (cand_start_bin, cand_end_bin, valid, wlog2,
        ext_start, ext_start % r, too_big), each [K_g], in that order
        (``SegmentDetector._packed_candidates``).
      states: tuple of G SegmentDetector slot-table dicts (init_state).
      n_cands/rs/delays: per-segment static config tuples.
      chunk: blocks per closed-form chunk (1 = walk every block; batches
        whose length is not a multiple fall back to 1).
      interpret: run in interpreter mode (CPU testing).

    Tombstoned (emitted) slots are FREED at step end — returned states
    match SegmentDetector._free_tombstones applied to the raw scan result.

    Returns a tuple of G (new_state, (got, processed, emit, phase_used))
    pairs, flags [B, S_g] (scan-order layout, same as the lax.scan path).
    """
    g_n = len(cands)
    nb = cands[0].shape[0]
    ss = tuple(st["active"].shape[0] for st in states)
    kp = _pow2(max(n_cands))
    sp = _pow2(max(ss))
    if nb % chunk != 0:
        chunk = 1

    packs, nvs = [], []
    for c, k in zip(cands, n_cands):
        c = c.astype(jnp.int32).reshape(nb, 7, k)
        nvs.append(jnp.sum((c[:, 2, :] != 0).astype(jnp.int32), axis=1))
        packs.append(jnp.pad(c, ((0, 0), (0, 0), (0, kp - k))))
    pack = jnp.stack(packs)  # [G, B, 7, Kp]
    nv = jnp.stack(nvs)  # [G, B]
    n_chunks = nb // chunk if chunk > 1 else 1
    cwork = jnp.max(nv.reshape(g_n, n_chunks, -1), axis=2)  # [G, n_chunks]

    keys = ("active", "tomb", "det_start", "det_stop", "ext_start", "wlog2",
            "phase", "phase_inc", "inactive", "order")
    rows = []
    for st, s in zip(states, ss):
        m = jnp.stack([st[kk].astype(jnp.int32) for kk in keys])  # [10, S]
        # padded lanes enter as tombstones: never live, never free
        pad = jnp.zeros((_N_STATE, sp - s), jnp.int32).at[1].set(1)
        rows.append(jnp.concatenate([m, pad], axis=1))
    st_in = jnp.stack(rows)  # [G, 10, Sp]
    cnt_in = jnp.stack([
        jnp.stack([jnp.asarray(st["alloc_counter"], jnp.int32),
                   jnp.asarray(st["dropped"], jnp.int32)])
        for st in states
    ])  # [G, 2]
    par = jnp.asarray([[r, d] for r, d in zip(rs, delays)], jnp.int32)

    o_st, o_cnt, o_flag = pl.pallas_call(
        functools.partial(_lifecycle_kernel, n_blocks=nb, chunk=chunk),
        out_shape=(
            jax.ShapeDtypeStruct((g_n, _N_STATE, sp), jnp.int32),
            jax.ShapeDtypeStruct((g_n, 2), jnp.int32),
            jax.ShapeDtypeStruct((g_n, 4, nb, sp), jnp.int32),
        ),
        grid=(g_n,),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=_num_warps(kp * sp), num_stages=1
        ),
        interpret=interpret,
        name="slot_lifecycle",
    )(pack, nv, cwork, par, st_in, cnt_in)

    results = []
    for g, s in enumerate(ss):
        o = o_st[g, :, :s]
        new_state = {kk: o[j] for j, kk in enumerate(keys)}
        new_state["active"] = o[0] != 0
        new_state["tomb"] = o[1] != 0
        new_state["alloc_counter"] = o_cnt[g, 0]
        new_state["dropped"] = o_cnt[g, 1]
        f = o_flag[g, :, :, :s]
        results.append((new_state, (f[0] != 0, f[1] != 0, f[2] != 0, f[3])))
    return tuple(results)


def slot_lifecycle(
    cand_packed, state,
    *, n_cand, r, delay, chunk=32, interpret=False,
):
    """Single-segment slot lifecycle (the G == 1 case of
    slot_lifecycle_multi)."""
    ((new_state, flags),) = slot_lifecycle_multi(
        (cand_packed,), (state,),
        n_cands=(n_cand,), rs=(r,), delays=(delay,),
        chunk=chunk, interpret=interpret,
    )
    return new_state, flags


# ---------------------------------------------------------------------------
# Power-activation hysteresis automaton
# ---------------------------------------------------------------------------


def _powact_kernel(
    rup_ref, rdn_ref, work_ref, st_ref, delta_ref, o_st_ref, o_flag_ref,
    *, n_blocks: int, r: int, chunk: int,
):
    """Chunked hysteresis automaton over [Cp] channel lanes.

    The power ratios are batch-precomputed outside the kernel (``lastpower``
    is always the previous block's power regardless of activity,
    reference: lib/PowerActivationChannel_impl.cc:286-306), so the serial
    chain only carries (active, phase). A chunk with no ratio edge cannot
    change any channel's activity: its flags and phase advance are closed
    form, one tile store per chunk."""
    delta = delta_ref[0, :]

    def put(rows, flags):
        for kind in range(4):
            o_flag_ref[kind, rows, :] = flags[kind]

    def body(i, carry):
        active, phase = carry
        rise = (active == 0) & (rup_ref[i, :] != 0)
        fall = (active != 0) & (rdn_ref[i, :] != 0)
        processed = rise | (active != 0)
        put(i, (rise.astype(jnp.int32), fall.astype(jnp.int32),
                processed.astype(jnp.int32), jnp.where(rise, delta, phase)))
        phase = jnp.where(
            rise, (2 * delta) % r,
            jnp.where(processed, (phase + delta) % r, phase),
        )
        active = jnp.where((active != 0) | rise, 1, 0)
        active = jnp.where(fall, 0, active)
        return active, phase

    carry = (st_ref[0, :], st_ref[1, :])
    if chunk > 1:
        def chunk_body(c, carry):
            def quiet(carry):
                active, phase0 = carry
                on = active != 0
                j = jax.lax.broadcasted_iota(
                    jnp.int32, (chunk, delta.shape[0]), 0
                )
                z = jnp.zeros((chunk, delta.shape[0]), jnp.int32)
                put(pl.ds(c * chunk, chunk), (
                    z, z, jnp.broadcast_to(active[None, :], z.shape),
                    jnp.where(on[None, :],
                              (phase0[None, :] + j * delta[None, :]) % r,
                              phase0[None, :]),
                ))
                return active, jnp.where(on, (phase0 + chunk * delta) % r,
                                         phase0)

            def edges(carry):
                return jax.lax.fori_loop(
                    c * chunk, (c + 1) * chunk, body, carry
                )

            return jax.lax.cond(work_ref[c] > 0, edges, quiet, carry)

        carry = jax.lax.fori_loop(0, n_blocks // chunk, chunk_body, carry)
    else:
        carry = jax.lax.fori_loop(0, n_blocks, body, carry)
    o_st_ref[0, :] = carry[0]
    o_st_ref[1, :] = carry[1]


@functools.partial(
    jax.jit, static_argnames=("r", "thresh", "chunk", "interpret")
)
def powact_flags(powers, state, delta, *, r, thresh, chunk=32,
                 interpret=False):
    """Run the burst hysteresis automaton over [B, C] powers in one kernel.

    Same semantics as PowerActivationBank.scan_flags's lax.scan (same
    float ratio expressions, batch-precomputed). Returns
    (new_state, (rise, fall, processed, phase_used)) with flags [C, B].
    """
    nb, c = powers.shape
    cp = _pow2(c)
    powers = powers.astype(jnp.float32)
    lastp = jnp.concatenate(
        [state["lastpower"].astype(jnp.float32)[None, :], powers[:-1]],
        axis=0,
    )  # [B, C]: lastpower entering each block
    thr = jnp.float32(thresh)
    lane_pad = ((0, 0), (0, cp - c))
    r_up = jnp.pad((powers / lastp >= thr).astype(jnp.int32), lane_pad)
    r_dn = jnp.pad((lastp / powers >= thr).astype(jnp.int32), lane_pad)
    if nb % chunk != 0:
        chunk = 1
    n_chunks = nb // chunk if chunk > 1 else 1
    work = jnp.max((r_up | r_dn).reshape(n_chunks, -1), axis=1)
    st_in = jnp.pad(
        jnp.stack([state["active"].astype(jnp.int32),
                   state["phase"].astype(jnp.int32)]),
        lane_pad,
    )  # [2, Cp]
    dl = jnp.pad(delta.astype(jnp.int32).reshape(1, c), lane_pad)
    o_st, o_flag = pl.pallas_call(
        functools.partial(_powact_kernel, n_blocks=nb, r=r, chunk=chunk),
        out_shape=(
            jax.ShapeDtypeStruct((2, cp), jnp.int32),
            jax.ShapeDtypeStruct((4, nb, cp), jnp.int32),
        ),
        grid=(1,),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="powact_flags",
    )(r_up, r_dn, work, st_in, dl)
    new_state = {
        "active": o_st[0, :c] != 0,
        "lastpower": powers[-1],
        "phase": o_st[1, :c],
    }
    f = o_flag[:, :, :c]
    flags = (
        (f[0] != 0).T,  # [C, B]
        (f[1] != 0).T,
        (f[2] != 0).T,
        f[3].T,
    )
    return new_state, flags
