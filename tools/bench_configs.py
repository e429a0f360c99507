"""BASELINE.md benchmark configs 1-5 on one chip (Msamples/s each).

The five workloads prescribed by BASELINE.json "configs":
  1 single static channel extract (tone+noise, 4096-pt overlap-save)
  2 static DAMA: 16 equally spaced fixed channels
  3 PowerActivationChannel mode: 32 defined channels with hysteresis
  4 dynamic activity-detection channelizer (SegmentDetection-style)
  5 pod-scale burst hunter: 512 dynamic slots (single-chip shard of the
    >=2-host config; time/chan sharding itself is validated on the CPU
    mesh and dry-run compiled by the driver)

Prints one JSON line per config: device Msamples/s (median-of-diffs scan
timing, fdc_tpu.utils.profiling) and the realtime factor against the
config's nominal sample rate.

Run:  python tools/bench_configs.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    from fdc_tpu.config import ChannelizerConfig
    from fdc_tpu.models.channelizer import FrequencyDomainChannelizer
    from fdc_tpu.utils.compile_cache import enable_compile_cache
    from fdc_tpu.utils.profiling import measure_samples_per_sec

    enable_compile_cache()

    print("devices:", jax.devices(), file=sys.stderr)

    n16 = [(-0.4 + 0.8 * (i + 0.5) / 16, 0.8 / 16 * 0.9) for i in range(16)]
    n32 = [(-0.4 + 0.8 * (i + 0.5) / 32, 0.8 / 32 * 0.9) for i in range(32)]

    configs = {
        # 1: single static channel, 1 MS/s capture
        "cfg1_single_static": (1e6, dict(
            blocksize=4096, relinvovl=4,
            throughput_channels=[(-0.2, 0.02)],
            freqmode="normalized", batch_blocks=512,
        )),
        # 2: static DAMA, 16 fixed channels on 8 MS/s wideband
        "cfg2_dama16": (8e6, dict(
            blocksize=4096, relinvovl=4,
            throughput_channels=n16,
            freqmode="normalized", batch_blocks=512,
        )),
        # 3: 32 power-activation channels, bursty 16 MS/s
        "cfg3_powact32": (16e6, dict(
            blocksize=4096, relinvovl=4,
            activity_controlled_channels=n32,
            act_contr_threshold=10.0,
            freqmode="normalized", batch_blocks=512,
        )),
        # 4: dynamic activity detection on 50 MS/s wideband (two-tier
        # extraction: +51% over a single wide bucket)
        "cfg4_segdet": (50e6, dict(
            blocksize=4096, relinvovl=4,
            activity_detection_segments=[(-0.45, 0.45)],
            act_det_threshold=6.0, minchandist=0.005,
            max_slots=32, max_candidates=16, max_extract_width=512,
            extract_budget=4, extract_width_split=64,
            extract_budget_narrow=16,
            freqmode="normalized", batch_blocks=512,
        )),
        # 5: pod-scale burst hunter shard: 512 dynamic slots, 200 MS/s;
        # two-tier extraction (most detections are narrow — 32 rows at
        # width 64, 8 wide rows at w_cap): 2x over a single wide bucket
        "cfg5_burst_hunter512": (200e6, dict(
            blocksize=4096, relinvovl=4,
            activity_detection_segments=[(-0.45, 0.45)],
            act_det_threshold=6.0, minchandist=0.005,
            max_slots=512, max_candidates=32, max_extract_width=512,
            extract_budget=8, extract_width_split=64,
            extract_budget_narrow=32,
            freqmode="normalized", batch_blocks=512,
        )),
        # 5b: the same burst-hunter band split into 4 independent
        # segments (the reference's natural multi-segment deployment,
        # one std::thread per segment) — the shape whose per-segment
        # lifecycle scans SHARD over the mesh chan axis
        # (parallel/sharded.py), dividing the replicated-logic Amdahl
        # term of the scaling model by n_chan.
        "cfg5b_burst_hunter_4seg": (200e6, dict(
            blocksize=4096, relinvovl=4,
            activity_detection_segments=[
                (-0.45, -0.225), (-0.225, 0.0), (0.0, 0.225),
                (0.225, 0.45),
            ],
            act_det_threshold=6.0, minchandist=0.005,
            max_slots=128, max_candidates=32, max_extract_width=512,
            extract_budget=2, extract_width_split=64,
            extract_budget_narrow=8,
            freqmode="normalized", batch_blocks=512,
        )),
    }

    for name, (rate, kw) in configs.items():
        t0 = time.time()
        fdc = FrequencyDomainChannelizer(ChannelizerConfig(**kw))
        # k=48: k=24 gave a ~19 ms timed window at the faster configs —
        # below the >=25 ms dispatch-jitter floor (one k=24 run read
        # cfg4 22% low; three k=48 repeats re-measured it in-family)
        sps = measure_samples_per_sec(fdc, k=48)
        print(json.dumps({
            "config": name,
            "msps": round(sps / 1e6, 1),
            "nominal_msps": rate / 1e6,
            "realtime_factor": round(sps / rate, 2),
        }), flush=True)
        print(f"  wall {time.time()-t0:.0f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
