"""Device-step timing utilities.

A high-latency host link makes per-dispatch wall-clock timing unreliable:
dispatch and transfer costs can dwarf compute. These helpers time a step
function with the iteration loop INSIDE jit — ``lax.scan`` over K steps,
outputs kept live through a checksum reduction — and difference K against
2K runs to cancel dispatch overhead.

This is also how bench.py measures the headline number; exposed here so
users can profile their own configurations the same way.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "checksum",
    "time_scanned",
    "time_scanned_stats",
    "time_scanned_paired",
    "measure_samples_per_sec",
]


def checksum(tree) -> jax.Array:
    """Tiny scalar that keeps every array leaf of a pytree live."""
    leaves = [x for x in jax.tree.leaves(tree) if hasattr(x, "dtype")]
    acc = jnp.float32(0.0)
    for x in leaves:
        acc = acc + jnp.sum(jnp.abs(x).astype(jnp.float32))
    return acc


def time_scanned(
    step: Callable,
    carry,
    *args,
    k: int = 8,
    repeats: int = 3,
    perturb_arg: int = 0,
) -> float:
    """Seconds per step of ``carry, out = step(carry, *args, t_index)``.

    Runs jitted scans of K and 2K steps (carry threaded, outputs
    checksummed) and returns the per-step difference, best of ``repeats``.

    ``perturb_arg`` names the positional arg (the sample buffer) that gets a
    loop-carried perturbation added each iteration: XLA's while-loop
    invariant code motion otherwise HOISTS any computation that depends only
    on the (constant-across-iterations) input buffer out of the scan —
    computing the FFT/extraction once for K steps and making throughput
    numbers fictitious. The perturbation is ``prev_checksum * 1e-38``
    (rounds to identity against O(1) float32 samples, but is opaque to the
    compiler, forcing every iteration to recompute from the 'new' input —
    exactly like a real stream feeding fresh buffers). Pass ``None`` only
    for steps whose body already depends on the carry everywhere that
    matters.
    """

    return time_scanned_stats(
        step, carry, *args, k=k, repeats=repeats, perturb_arg=perturb_arg
    )["median"]


def time_scanned_stats(
    step: Callable,
    carry,
    *args,
    k: int = 8,
    repeats: int = 3,
    perturb_arg: int = 0,
) -> dict:
    """:func:`time_scanned` with the SPREAD of the per-step differences.

    Returns {"median", "q25", "q75", "min", "max", "n"} in seconds/step
    (all floored at 1 ns). A single median cannot distinguish a
    regression from session drift — benchmark JSON should carry the
    quartiles so the reader can.
    """

    def make(kk):
        @jax.jit
        def run(c0):
            def body(cs, t):
                c, s = cs
                pargs = list(args)
                if perturb_arg is not None:
                    a = pargs[perturb_arg]
                    pargs[perturb_arg] = a + (s * jnp.float32(1e-38)).astype(
                        a.dtype
                    )
                c2, out = step(c, *pargs, t)
                val = checksum(out)
                return (c2, val), val

            ts = jnp.arange(kk, dtype=jnp.int32)
            (c_fin, _), sums = lax.scan(body, (c0, jnp.float32(0.0)), ts)
            return checksum(c_fin) + jnp.sum(sums)

        return run

    r1, r2 = make(k), make(2 * k)
    jax.block_until_ready(r1(carry))
    jax.block_until_ready(r2(carry))
    # one more untimed warm-up pair: the first timed dispatches after
    # compilation can spike
    jax.block_until_ready(r1(carry))
    jax.block_until_ready(r2(carry))
    # median of the K-vs-2K differences: the fixed dispatch cost
    # occasionally spikes, which makes min() (and any single
    # pair) unreliable — a spiked ta inverts the difference entirely
    diffs = []
    for _ in range(max(repeats, 5)):
        t0 = time.perf_counter()
        jax.block_until_ready(r1(carry))
        ta = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(r2(carry))
        tb = time.perf_counter() - t0
        diffs.append((tb - ta) / k)
    diffs.sort()
    n = len(diffs)

    def at(i):
        return max(diffs[i], 1e-9)

    return {
        "median": at(n // 2),
        "q25": at(n // 4),
        "q75": at((3 * n) // 4),
        "min": at(0),
        "max": at(n - 1),
        "n": n,
    }


def time_scanned_paired(specs, repeats: int = 15,
                        pairs_per_round: int = 1):
    """Interleaved :func:`time_scanned_stats` over several step functions.

    ``specs``: list of ``(step, carry, args_tuple, k, perturb_arg)``.
    Timing rounds alternate ROUND-ROBIN across the specs (one K/2K pair
    each per round) instead of timing each spec's repeats in a separate
    phase — slow drift then lands equally in every spec's samples, so
    RATIOS between specs (bench.py's vs_baseline) are more repeatable
    than ratios of independently-phased medians.

    ``pairs_per_round`` > 1 makes each round's value the MEDIAN of that
    many back-to-back K/2K diffs: dispatch spikes
    land in single dispatches, so a lone spiked pair otherwise poisons
    its round and fattens the ratio quartiles (bench.py's
    vs_baseline_iqr) far beyond the structural spread — a per-round
    median of 3 keeps a round honest unless two of its three pairs
    spike.

    Returns a list of stats dicts (fields of :func:`time_scanned_stats`)
    plus ``"rounds"``: the per-round per-step diffs, index-aligned across
    specs so callers can form per-round ratios (median-of-ratios cancels
    round-scale drift exactly).
    """

    runs = []
    for step, carry, args, k, perturb_arg in specs:
        def make(kk, step=step, args=args, perturb_arg=perturb_arg):
            @jax.jit
            def run(c0):
                def body(cs, t):
                    c, s = cs
                    pargs = list(args)
                    if perturb_arg is not None:
                        a = pargs[perturb_arg]
                        pargs[perturb_arg] = a + (
                            s * jnp.float32(1e-38)
                        ).astype(a.dtype)
                    c2, out = step(c, *pargs, t)
                    val = checksum(out)
                    return (c2, val), val

                ts = jnp.arange(kk, dtype=jnp.int32)
                (c_fin, _), sums = lax.scan(
                    body, (c0, jnp.float32(0.0)), ts
                )
                return checksum(c_fin) + jnp.sum(sums)

            return run

        r1, r2 = make(k), make(2 * k)
        # compile + post-compile warm-up pair (first timed dispatches
        # after compilation can spike)
        jax.block_until_ready(r1(carry))
        jax.block_until_ready(r2(carry))
        jax.block_until_ready(r1(carry))
        jax.block_until_ready(r2(carry))
        runs.append((r1, r2, carry, k))

    n_rounds = max(repeats, 5)
    ppr = max(int(pairs_per_round), 1)
    rounds = [[] for _ in runs]
    pair_rounds = [[] for _ in runs]  # per-round list of the raw diffs
    for _ in range(n_rounds):
        # pair-level interleave: spec A's pair p runs adjacent to spec
        # B's pair p, so second-scale drift segments land in BOTH specs'
        # round medians instead of skewing their ratio
        diffs = [[] for _ in runs]
        for _ in range(ppr):
            for i, (r1, r2, carry, k) in enumerate(runs):
                t0 = time.perf_counter()
                jax.block_until_ready(r1(carry))
                ta = time.perf_counter() - t0
                t0 = time.perf_counter()
                jax.block_until_ready(r2(carry))
                tb = time.perf_counter() - t0
                diffs[i].append(max((tb - ta) / k, 1e-9))
        for i in range(len(runs)):
            pair_rounds[i].append(list(diffs[i]))
            diffs[i].sort()
            rounds[i].append(diffs[i][ppr // 2])

    out = []
    for i in range(len(runs)):
        diffs = sorted(rounds[i])
        n = len(diffs)
        out.append({
            "median": diffs[n // 2],
            "q25": diffs[n // 4],
            "q75": diffs[(3 * n) // 4],
            "min": diffs[0],
            "max": diffs[n - 1],
            "n": n,
            "rounds": rounds[i],
            # raw per-pair diffs, index-aligned across specs: pair p of
            # spec A ran ADJACENT in time to pair p of spec B, so ratios
            # of matching pairs cancel drift at the ~0.3 s scale (the
            # round medians only cancel it at the ~1 s round scale)
            "pair_rounds": pair_rounds[i],
        })
    return out


def measure_samples_per_sec(channelizer, k: int = 8) -> float:
    """Steady-state device throughput (samples/s) of a channelizer's step.

    Feeds unit-amplitude noise; detection activity is whatever the noise
    triggers (matching the bench methodology). K auto-grows until the
    timed window covers >= 30 ms: fast configs otherwise sit under the
    dispatch-jitter floor.
    """
    import numpy as np

    from fdc_tpu.utils.cplx import c2f_host

    cfg = channelizer.config
    rng = np.random.default_rng(0)
    n = cfg.batch_blocks * cfg.inplen
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )
    xf = jax.device_put(jnp.asarray(c2f_host(x)))
    carry = channelizer._jit_init()

    def step(c, xf_in, t_idx):
        return channelizer._device_step(c, xf_in, t_idx * cfg.batch_blocks)

    # probe for K sizing, then a MEDIAN estimate (time_scanned's
    # best-of-repeats is a min-of-diffs — biased fast; CLAUDE.md timing
    # trap (b))
    dt = time_scanned(step, carry, xf, k=k)
    k2 = k
    if dt * k < 0.025:
        k2 = int(min(4096, max(k, 0.030 / max(dt, 1e-9))))
    dt = time_scanned_stats(step, carry, xf, k=k2, repeats=7)["median"]
    return n / dt
