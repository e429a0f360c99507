"""Benchmark: wideband complex Msamples/s/chip on the flagship workload.

Workload (BASELINE.json north-star metric): 4096-pt overlap-save FFT
front-end, 64 fixed channels, plus one power-activation channel and one
dynamic detection segment — the full device pipeline of
FrequencyDomainChannelizer, steady-state, device-resident carry.

Measurement methodology: the iteration loop runs INSIDE jit (lax.scan over
steps, carry threaded, outputs kept live via checksum reduction), and the
step time is the K->2K difference, which cancels per-call dispatch
overhead. A loop-carried perturbation of the input buffer defeats XLA's
while-loop invariant code motion, which would otherwise hoist the FFT and
extraction (the input is constant across scan iterations) and fabricate
throughput — see fdc_tpu.utils.profiling.time_scanned.

Needs a GPU: exits non-zero when JAX finds none. The JSON names the device
(platform, device_kind, count) and the card (name and power limit as
``nvidia-smi`` reports them).

``vs_baseline`` is the BASELINE-defined "≥95% of roofline FFT+windowing
throughput" ratio. The roofline runs the SAME batch through the overlap-save
framing + 4096-pt forward FFT + every consumer's windowed extraction
(slice·window·IFFT for all 64 throughput channels, the burst bank, and all
detection slots at full width, at compile-time-constant starts) — i.e. all
of the arithmetic the workload fundamentally requires, none of the
detection/lifecycle logic. The roofline uses the same float-pair output
layout as the pipeline (pairs=True; a complex-output roofline is ~10%
slower and would flatter the ratio). The FFT-front-end-only throughput is
also reported (``fft_only_msps``) for reference.

Prints ONE JSON line.
"""

import argparse
import json
import subprocess
import sys

import numpy as np


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=96, help="K (timed as 2K-K)")
    ap.add_argument("--batch-blocks", type=int, default=512)
    ap.add_argument("--repeats", type=int, default=51)
    # per-round median of this many back-to-back K/2K pairs (spike/drift
    # rejection inside a round; see time_scanned_paired)
    ap.add_argument("--pairs", type=int, default=5)
    args = ap.parse_args()

    import jax

    from fdc_tpu.utils.compile_cache import enable_compile_cache

    if jax.default_backend() != "gpu":
        print(f"bench: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    result = run_bench(args)
    dev = jax.devices()[0]
    result["device"] = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    result["card"] = card_line()
    print(json.dumps(result))
    return 0


def run_bench(args):
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _flagship
    from fdc_tpu.models.channelizer import FrequencyDomainChannelizer
    from fdc_tpu.ops.extract import (
        extract_bucket,
        extract_bucket_phased,
        extract_dynamic,
    )
    from fdc_tpu.ops.fft import forward_spectrum
    from fdc_tpu.ops.framing import frame_blocks
    from fdc_tpu.utils.cplx import c2f_host, f2c
    from fdc_tpu.utils.profiling import time_scanned_paired

    cfg = _flagship(batch_blocks=args.batch_blocks)
    fdc = FrequencyDomainChannelizer(cfg)
    sd = fdc.segments[0]
    pa = fdc.power_bank
    tp = fdc.throughput

    rng = np.random.default_rng(0)
    n = cfg.batch_blocks * cfg.inplen
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )
    xf = jax.device_put(jnp.asarray(c2f_host(x)))
    carry0 = fdc._jit_init()

    def step_full(carry, xf_in, t_idx):
        return fdc._device_step(
            carry, xf_in, t_idx * jnp.int32(cfg.batch_blocks)
        )

    # -- roofline: framing + FFT + every consumer's windowing/IFFT ----------
    # detection slots at the CONFIGURED extraction budgets (the pipeline
    # ships extract_budget wide rows + extract_budget_narrow narrow rows
    # per step — the roofline mirrors the same configured extraction work)
    def seg_tables(n_rows, width, wlog2):
        starts = jnp.asarray(
            np.linspace(100, cfg.blocksize - width - 4, n_rows).astype(
                np.int32
            )
        )
        wins = jnp.asarray(
            np.tile(sd.window_table[wlog2, :width], (n_rows, 1))
        )
        return starts, wins

    seg_buckets = [
        (sd.extract_budget, sd.w_cap, sd.w_cap_log2)
    ]
    if sd.extract_width_split:
        seg_buckets.append(
            (sd.extract_budget_narrow, sd.extract_width_split,
             sd.split_log2)
        )
    seg_tabs = [
        (seg_tables(nr, w, wl), w, wl) for nr, w, wl in seg_buckets
    ]

    def step_roofline(carry, xf_in, t0):
        xx = f2c(xf_in)
        blocks, hist = frame_blocks(xx, carry["hist"], cfg.blocksize)
        spec = forward_spectrum(blocks, use_mxu=cfg.use_mxu_fft)
        nc = dict(carry)
        nc["hist"] = hist
        spec_ext = jnp.concatenate([carry["prev_spec"][None], spec])
        nc["prev_spec"] = spec[-1]
        out = []
        # same routing as _step_from_spec: the fold (and its t0 ≡ 0 mod R
        # contract) only holds when batch_blocks is a multiple of relinvovl
        fold_phase = cfg.batch_blocks % cfg.relinvovl == 0
        for bucket in tp.buckets:
            if fold_phase:
                y = extract_bucket_phased(
                    spec, bucket.starts,
                    bucket.windows, cfg.relinvovl, gain=float(bucket.width),
                    use_mxu=cfg.use_mxu_fft,
                    keep_from=bucket.width - bucket.out_len,
                )
            else:
                y = extract_bucket(
                    spec, bucket.starts, bucket.windows,
                    gain=float(bucket.width), use_mxu=cfg.use_mxu_fft,
                    keep_from=bucket.width - bucket.out_len, pairs=True,
                )
            out.append(
                tp.finish_bucket(bucket, y, t0, pairs=True,
                                 prephased=fold_phase)
            )
        for bucket in pa.buckets:
            out.append(
                extract_bucket(
                    spec_ext, bucket.starts,
                    bucket.windows, use_mxu=cfg.use_mxu_fft,
                    keep_from=bucket.width - bucket.out_len, pairs=True,
                )
            )
        for (starts, wins), w, wl in seg_tabs:
            out.append(
                extract_dynamic(
                    spec_ext, starts,
                    jnp.full((starts.shape[0],), wl, jnp.int32),
                    wins, w, use_mxu=cfg.use_mxu_fft, pairs=True,
                )
            )
        return nc, out

    # -- FFT front-end alone (context, not the baseline denominator) --------
    def step_fft(carry, xf_in, t0):
        xx = f2c(xf_in)
        blocks, hist = frame_blocks(xx, carry["hist"], cfg.blocksize)
        spec = forward_spectrum(blocks, use_mxu=cfg.use_mxu_fft)
        nc = dict(carry)
        nc["hist"] = hist
        return nc, [spec]

    # INTERLEAVED timing (one K/2K pair of each step per round): with
    # phased timing, slow drift lands in the full/roofline RATIO;
    # vs_baseline is the median of per-round ratios, cancelling
    # round-scale drift exactly
    st_full, st_roof, st_fft = time_scanned_paired(
        [
            # full and roofline step get EQUAL K: equal windows give
            # equal relative jitter in the vs_baseline quartiles
            (step_full, carry0, (xf,), 2 * args.steps, 0),
            (step_roofline, carry0, (xf,), 2 * args.steps, 0),
            (step_fft, carry0, (xf,), 4 * args.steps, 0),
        ],
        repeats=args.repeats,
        # median of N back-to-back pairs per round: a lone dispatch
        # spike cannot poison its round's diff
        pairs_per_round=args.pairs,
    )
    dt_full = st_full["median"]
    dt_roof = st_roof["median"]
    dt_fft = st_fft["median"]

    # per-round ratio = median over the round's ADJACENT pairs (pair p
    # of the roofline ran ~0.3 s after pair p of the full step, vs ~1 s
    # between the two round medians) — the tightest drift cancellation
    # the interleaved schedule allows
    ratios = []
    for prs_f, prs_r in zip(st_full["pair_rounds"],
                            st_roof["pair_rounds"]):
        rr = sorted(r / f for f, r in zip(prs_f, prs_r))
        ratios.append(rr[len(rr) // 2])
    ratios.sort()
    nr = len(ratios)

    msps = n / dt_full / 1e6
    msps_roof = n / dt_roof / 1e6
    msps_fft = n / dt_fft / 1e6

    result = {
        "metric": "wideband_complex_Msamples_per_s_per_chip_4096fft_64ch",
        "value": round(msps, 3),
        "unit": "Msamples/s",
        "vs_baseline": round(ratios[nr // 2], 4),
        "roofline_msps": round(msps_roof, 1),
        "fft_only_msps": round(msps_fft, 1),
        "batch_blocks": cfg.batch_blocks,
        # spread of the per-step timing diffs: the IQR (in Msamples/s,
        # [q75-time, q25-time] => [lo, hi]) separates drift from a
        # regression. vs_baseline_iqr is the IQR of the per-round
        # roofline/full ratios (interleaved rounds, drift-cancelled).
        "value_iqr": [
            round(n / st_full["q75"] / 1e6, 1),
            round(n / st_full["q25"] / 1e6, 1),
        ],
        "roofline_iqr": [
            round(n / st_roof["q75"] / 1e6, 1),
            round(n / st_roof["q25"] / 1e6, 1),
        ],
        "vs_baseline_iqr": [
            round(ratios[nr // 4], 4),
            round(ratios[(3 * nr) // 4], 4),
        ],
        "timing_repeats": st_full["n"],
    }

    # utilization context: XLA's own cost model for one full step,
    # converted to sustained rates at the measured step time. The bare
    # step is a different module from time_scanned's scan wrapper, so
    # this is one extra compile.
    cost = (
        jax.jit(step_full).lower(carry0, xf, jnp.int32(0))
        .compile().cost_analysis()
    )
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    flops = float(cost.get("flops", 0.0)) if cost else 0.0
    byts = float(cost.get("bytes accessed", 0.0)) if cost else 0.0
    if flops > 0:
        result["sustained_tflops"] = round(flops / dt_full / 1e12, 3)
    if byts > 0:
        result["hbm_gbps"] = round(byts / dt_full / 1e9, 1)

    return result


if __name__ == "__main__":
    sys.exit(main())
