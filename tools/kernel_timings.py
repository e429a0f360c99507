"""Time each hand-written kernel against the plain version XLA compiles.

Runs on a GPU at the flagship shape (4096-point FFT, 64 throughput
channels, one burst channel, one detection segment, 512 blocks per batch):

- the full device step with every kernel, then with each one replaced by
  its plain reference (lifecycle + burst automata as ``lax.scan``, greedy
  acceptance as the unrolled jnp loop), and with the forward FFT / subband
  transforms as matmul DFTs (``use_mxu_fft``) instead of cuFFT;
- each kernel alone against its reference, on the capture's sparse
  traffic and on a churn batch (random carriers on every block);
- the error and time of the DFT matmuls at each precision, against a
  float64 NumPy FFT.

Times are host-clock medians over a warmed window of steps ending in
``block_until_ready``. Prints one ``key: value`` line per measurement;
``--out PATH`` also writes them as one JSON object.

Usage: python tools/kernel_timings.py [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _flagship  # noqa: E402
from chip_smoke import flagship_capture  # noqa: E402
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer  # noqa: E402
from fdc_tpu.ops import detect, fft  # noqa: E402
from fdc_tpu.ops.extract import extract_bucket  # noqa: E402
from fdc_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from fdc_tpu.utils.cplx import c2f_host  # noqa: E402

RESULTS = {}


def record(key, value):
    RESULTS[key] = value
    print(f"{key}: {value}", flush=True)


def median_time(fn, *args, reps=30, inner=1):
    """Median seconds per call over ``reps`` timed windows of ``inner``
    calls, after one warm-up call (compilation excluded)."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t) / inner)
    return statistics.median(ts)


def step_time(cfg, xf, configure=None, reps=20):
    """Median full-step time (ms) of a fresh channelizer, with carry
    threading, after ``configure(fdc)`` adjusts its components."""
    fdc = FrequencyDomainChannelizer(cfg)
    if configure:
        configure(fdc)
    step = jax.jit(fdc._device_step)
    carry = fdc._jit_init()
    t0 = jnp.int32(0)
    carry, out = step(carry, xf, t0)  # compile
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        carry, out = step(carry, xf, t0)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t)
    return statistics.median(ts) * 1e3, fdc, step, carry


def scan_backends(backend):
    def configure(fdc):
        for sd in fdc.segments:
            sd.lifecycle_backend = backend
        fdc.power_bank.lifecycle_backend = backend
    return configure


def full_step(cfg, xf):
    ms, fdc, step, carry = step_time(cfg, xf)
    record("step_ms.kernels", ms)
    hlo = step.lower(carry, xf, jnp.int32(0)).compile().as_text()
    record("step.fusions", hlo.count(" fusion("))
    record("step.triton_calls", hlo.count("xla.gpu.triton"))
    record("step_ms.automata_scan", step_time(cfg, xf,
                                              scan_backends("scan"))[0])
    orig = detect.greedy_accept_batch
    detect.greedy_accept_batch = (
        lambda cs, ce, hp, interpret=False:
        detect._greedy_accept_jnp(cs, ce, hp)
    )
    try:
        record("step_ms.greedy_jnp", step_time(cfg, xf)[0])
    finally:
        detect.greedy_accept_batch = orig
    record("step_ms.matmul_dft", step_time(cfg.replace(use_mxu_fft=True),
                                           xf)[0])
    # static stage alone (framing + FFT + extraction + measures + packing)
    spec_fn = jax.jit(lambda x: fdc._extract_static(
        *_spec_pair(fdc, x), jnp.int32(0)))
    record("static_stage_ms", median_time(spec_fn, xf) * 1e3)


def _spec_pair(fdc, xf):
    from fdc_tpu.ops.fft import forward_spectrum
    from fdc_tpu.ops.framing import frame_blocks
    from fdc_tpu.utils.cplx import f2c

    cfg = fdc.config
    blocks, _ = frame_blocks(
        f2c(xf), jnp.zeros((cfg.ovllen,), jnp.complex64), cfg.blocksize
    )
    spec = forward_spectrum(blocks, use_mxu=cfg.use_mxu_fft)
    spec_ext = jnp.concatenate([spec[:1], spec])
    return spec, spec_ext


def automata(cfg, xf):
    fdc = FrequencyDomainChannelizer(cfg)
    sd, pa = fdc.segments[0], fdc.power_bank
    spec, _ = jax.jit(lambda x: _spec_pair(fdc, x))(xf)
    sq = jnp.abs(spec) ** 2
    p_seg = sd.measure(spec, sq)
    p_pa = pa.measure(spec, sq)
    rng = np.random.default_rng(5)
    nc = sd.geometry.n_cells
    churn = np.full((cfg.batch_blocks, nc), 1e-6)
    for _ in range(40):
        c0 = int(rng.integers(0, nc - 4))
        on = int(rng.integers(0, cfg.batch_blocks - 8))
        churn[on:on + int(rng.integers(1, 60)),
              c0:c0 + int(rng.integers(1, 4))] += 1.0 + rng.random()
    traffic = {"capture": p_seg, "churn": jnp.asarray(churn, jnp.float32)}
    for name, power in traffic.items():
        packed, _ = jax.jit(sd._packed_candidates)(power)
        st = sd.init_state()
        for backend in ("pallas", "scan"):
            sd.lifecycle_backend = backend
            fn = jax.jit(lambda pk, s: sd.scan_slots(power, s, packed=pk))
            record(f"lifecycle_us.{name}.{backend}",
                   median_time(fn, packed, st) * 1e6)
        cs, ce, hp = jax.jit(jax.vmap(
            lambda p: detect.detect_edges(p, sd.thresh, sd.k_detect)
        ))(power)
        g_k = jax.jit(detect._greedy_accept_pallas)
        g_j = jax.jit(detect._greedy_accept_jnp)
        record(f"greedy_us.{name}.kernel", median_time(g_k, cs, ce, hp) * 1e6)
        record(f"greedy_us.{name}.jnp", median_time(g_j, cs, ce, hp) * 1e6)
        hlo = g_j.lower(cs, ce, hp).compile().as_text()
        record(f"greedy.{name}.jnp_fusions", hlo.count(" fusion("))
    sd.lifecycle_backend = "auto"
    st = pa.init_state()
    for backend in ("pallas", "scan"):
        pa.lifecycle_backend = backend
        fn = jax.jit(pa.scan_flags)
        record(f"powact_us.{backend}", median_time(fn, p_pa, st) * 1e6)
    pa.lifecycle_backend = "auto"


def precision(cfg, x):
    """Error vs a float64 FFT and time of the DFT matmuls per precision."""
    n = cfg.blocksize
    nb = len(x) // n
    blocks = x[: nb * n].reshape(nb, n)
    ref = np.fft.fftshift(np.fft.fft(blocks.astype(np.complex128)),
                          axes=-1) / n
    peak = np.abs(ref).max()
    xb = jnp.asarray(blocks)
    fdc = FrequencyDomainChannelizer(cfg)
    bucket = fdc.throughput.buckets[0]
    l = bucket.width
    ext_ref = []
    signs = np.where(np.arange(l) % 2 == 0, 1.0, -1.0)
    for s, w in zip(bucket.starts, bucket.windows):
        z = ref[:, s:s + l] * w
        ext_ref.append((np.fft.ifft(z, axis=-1) * l * l * signs)[
            :, l - bucket.out_len:])
    ext_ref = np.stack(ext_ref)
    ext_peak = np.abs(ext_ref).max()
    spec_in = jnp.asarray(ref.astype(np.complex64))
    variants = [("cufft", None)] + [
        (p.name, p) for p in (jax.lax.Precision.DEFAULT,
                              jax.lax.Precision.HIGH,
                              jax.lax.Precision.HIGHEST)
    ]
    saved = fft.DFT_PRECISION
    try:
        for name, prec in variants:
            if prec is not None:
                fft.DFT_PRECISION = prec
            use_mxu = prec is not None
            f_fft = jax.jit(lambda b, u=use_mxu: fft.forward_spectrum(
                b, use_mxu=u))
            got = np.asarray(f_fft(xb))
            record(f"fft.{name}.max_err_over_peak",
                   float(np.abs(got - ref).max() / peak))
            record(f"fft.{name}.us", median_time(f_fft, xb) * 1e6)
            f_ext = jax.jit(lambda s, u=use_mxu: extract_bucket(
                s, bucket.starts, bucket.windows, gain=float(l),
                use_mxu=u, keep_from=l - bucket.out_len, pairs=True))
            y = np.asarray(f_ext(spec_in))
            got = y[..., 0] + 1j * y[..., 1]
            record(f"extract.{name}.max_err_over_peak",
                   float(np.abs(got - ext_ref).max() / ext_peak))
            record(f"extract.{name}.us", median_time(f_ext, spec_in) * 1e6)
    finally:
        fft.DFT_PRECISION = saved


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        print("kernel_timings: no GPU", file=sys.stderr)
        return 1
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    record("card", card)
    record("device_kind", jax.devices()[0].device_kind)
    cfg = _flagship(batch_blocks=512)
    x = flagship_capture(cfg, 1, np.random.default_rng(0))
    xf = jax.device_put(jnp.asarray(c2f_host(x)))
    for name, fn, args in (("full_step", full_step, (cfg, xf)),
                           ("automata", automata, (cfg, xf)),
                           ("precision", precision, (cfg, x))):
        try:
            fn(*args)
        except Exception as exc:  # keep the other measurements
            record(f"{name}.error", f"{type(exc).__name__}: {exc}"[:2000])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(RESULTS, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
