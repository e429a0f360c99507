"""Pod-scale burst hunter (BASELINE config 5, scaled to this machine).

Demonstrates the distribution story: a (time, chan) device mesh, the
sharded channelizer step (ppermute history exchange, all-gathered
detection statistics, channel-sharded extraction), per-host sample feeding
via the multihost helpers, and waterfall-style detection messages.

On a real pod every host runs this same script after
``initialize_multihost()``; here it runs on an 8-device virtual CPU mesh
(or whatever devices exist) so the full multi-chip code path executes
anywhere:

    python examples/pod_burst_hunter.py [--devices 8] [--n-chan 2]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8,
                    help="virtual CPU devices (ignored with --accel)")
    ap.add_argument("--n-chan", type=int, default=2)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--accel", action="store_true",
                    help="use the real accelerator mesh instead of CPU")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import jax

    if not args.accel:
        # virtual CPU mesh; must be configured before any jax op runs
        # (env vars are read too early in this environment)
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.devices)

    from fdc_tpu.config import ChannelizerConfig
    from fdc_tpu.parallel.multihost import (
        global_mesh,
        host_local_batch,
        initialize_multihost,
    )
    from fdc_tpu.parallel.sharded import ShardedChannelizer
    from fdc_tpu.utils.waterfall import Waterfall

    proc = initialize_multihost()
    mesh = global_mesh(n_chan=args.n_chan)
    n_time = mesh.shape["time"]
    print(f"process {proc}: mesh time={n_time} chan={args.n_chan}")

    cfg = ChannelizerConfig(
        blocksize=1024,
        relinvovl=4,
        activity_detection_segments=[(-0.45, -0.02), (0.02, 0.45)],
        act_det_threshold=8.0,
        minchandist=0.01,
        freqmode="basebandfs",
        batch_blocks=4 * n_time,
        max_slots=64,   # scaled stand-in for "512+ dynamic channels"
        max_candidates=16,
        # pod-scale output compaction: two-tier extraction — most detected
        # carriers are narrow, so ship 16 rows at width 64 and only 4 at
        # the full width
        max_extract_width=512,
        extract_budget=4,
        extract_width_split=64,
        extract_budget_narrow=16,
        debug=True,
    )
    fdc = ShardedChannelizer(cfg, mesh=mesh)

    # synthesize a busy burst scene
    rng = np.random.default_rng(0)
    n = args.batches * fdc.batch_samples
    t = np.arange(n)
    x = (0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    n_blocks = n // cfg.inplen
    for _ in range(24):
        f = float(rng.uniform(-0.44, 0.44))
        if abs(f) < 0.03:
            continue
        on = int(rng.integers(0, n_blocks - 6))
        off = on + int(rng.integers(3, 12))
        m = np.zeros(n)
        m[on * cfg.inplen: off * cfg.inplen] = 1.0
        x += (1.5 * m * np.exp(2j * np.pi * f * t)).astype(np.complex64)

    # per-host feeding path (each host passes only its local shard run on a
    # real pod; single-process here, so local == global)
    from fdc_tpu.utils.cplx import c2f_host

    _ = host_local_batch(mesh, c2f_host(x[: fdc.batch_samples]))

    wf = Waterfall(blocklen=cfg.blocksize, width=512,
                   height=max(64, n_blocks))
    events = []
    res = fdc.process(x)
    events.extend(res.events)
    wf.feed_power(np.abs(res.debug_spectrum) ** 2)
    wf.feed_events(res.events)

    fin = [e for e in events if e.finalized]
    print(f"blocks processed: {res.blocks_processed}")
    print(f"events: {len(events)} ({len(fin)} finalized)")
    for e in fin[:12]:
        print(f"  {e.ID}  blocks=[{e.blockstart},{e.blockend}] "
              f"cfreq={e.rel_cfreq:.3f} bw={e.rel_bw:.4f} n={len(e.data)}")
    if args.out and wf.save_png(args.out):
        print(f"waterfall written to {args.out}")

    # event-dense deployments: split each wide segment into independent
    # sub-segment automata (cut reconciliation keeps detections exact)
    # and spread the scan chains over pipeline owner devices — the
    # churn-capacity transform
    from fdc_tpu.parallel.pipeline import PipelineChannelizer

    cfg_split = cfg.replace(
        batch_blocks=8,
        segment_splits=[(0, 2, 2), (1, 2, 2)],  # 2 segments -> 4 automata
        debug=False,
    )
    pipe = PipelineChannelizer(
        cfg_split, devices=jax.devices(), scan_owners=4,
    )
    res_p = pipe.process(x[: 2 * pipe.batch_samples])
    fin_p = [e for e in res_p.events if e.finalized]
    print(f"split multi-owner pipeline: {len(pipe.segments)} automata, "
          f"{res_p.blocks_processed} blocks, {len(fin_p)} finalized events")
    return 0


if __name__ == "__main__":
    sys.exit(main())
