"""Adversarial random sweep: split-vs-unsplit EVENT PARITY on random
geometry (blocksize, minchandist, thresholds, delays, batch sizes,
n_parts, margins >= 2), exact detection mode, random tone carriers with
cut-biased placement over noise — WITHOUT the width/spacing discipline
the in-repo parity tests hold to.

Purpose: probe the documented deviation bound, not assert exactness.
Run of record (2026-08-20, 60 seeds 500-559): 53/60 exactly
event-identical; all 7 deviating draws fall in the two documented
margin classes —

  (a) detections WIDER than the overlap margin at a cut (noise-blob /
      startup-transient candidates with rel_bw 0.125-1.0 against 2-4
      cell margins): truncated, split, or lost at the cut exactly as
      config.split_segment_geometry's bound states;
  (b) distinct carriers closer than ~1-2 decimated cells straddling a
      cut (below the minchandist resolution the decimation grid is
      designed around; e.g. seed 530: carriers at bins 71 and 77 with
      dec=3 and the cut at 77): the parts merge/suppress what the
      parent happened to resolve as two tracks.

Zero crashes, zero deviations outside those classes. Size
overlap_cells to the widest expected carrier (and keep carriers
minchandist apart — the reference's own design assumption) for exact
parity; the bounded-deviation regime is pinned by
tests/test_segment_split.py::test_split_under_margin_deviation_is_bounded.

Run:  JAX_PLATFORMS=cpu python tools/sweep_split_parity.py [n_seeds] [seed0]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import traceback

    from fdc_tpu.config import ChannelizerConfig
    from fdc_tpu.models.channelizer import FrequencyDomainChannelizer

    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 60
    seed0 = int(sys.argv[2]) if len(sys.argv) > 2 else 500

    def sig(evs):
        return sorted(
            (e.blockstart, e.blockend, round(e.rel_cfreq, 6),
             round(e.rel_bw, 6), round(float(np.abs(e.data).sum()), 2))
            for e in evs if e.finalized
        )

    def events(cfg, x):
        fdc = FrequencyDomainChannelizer(cfg)
        res = fdc.process(x)
        ev = list(res.events)
        ev.extend(fdc.flush(finalize=True).events)
        return ev

    fails = 0
    for seed in range(seed0, seed0 + n_seeds):
        rng = np.random.default_rng(seed)
        blocksize = int(2 ** rng.integers(8, 11))
        a = float(rng.uniform(0.05, 0.3))
        b = a + float(rng.uniform(0.3, 0.6))
        kw = dict(
            blocksize=blocksize, relinvovl=int(2 ** rng.integers(1, 3)),
            activity_detection_segments=[(a, min(b, 0.95))],
            act_det_threshold=float(rng.uniform(6.0, 11.0)),
            minchandist=float(rng.uniform(0.02, 0.05)),
            act_det_deactivation_delay=int(rng.integers(0, 3)),
            minchanflankpuffer=float(rng.uniform(0.05, 0.3)),
            batch_blocks=int(rng.choice([4, 8])),
            max_slots=8, max_candidates=0,
        )
        cfg_u = ChannelizerConfig(**kw)
        nc = FrequencyDomainChannelizer(cfg_u).segments[0].geometry.n_cells
        n_parts = int(rng.integers(2, min(5, max(3, nc // 4))))
        if nc < n_parts:
            continue
        ovl = int(rng.integers(2, 5))
        cfg_s = ChannelizerConfig(**kw, segment_splits=[(0, n_parts, ovl)])
        parts = FrequencyDomainChannelizer(cfg_s).segments
        cuts = [sd.core_bins[1] for sd in parts[:-1]]
        g = parts[0].geometry
        n = 36 * cfg_u.inplen
        t = np.arange(n)
        x = 0.004 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        for _ in range(int(rng.integers(0, 4))):
            if cuts and rng.random() < 0.6:
                bb = int(rng.choice(cuts)) + int(
                    rng.integers(-g.decimation, g.decimation + 1)
                )
            else:
                bb = int(rng.integers(parts[0].core_bins[0] + 4,
                                      parts[-1].core_bins[1] - 4))
            on = int(rng.integers(2, 24))
            off = on + int(rng.integers(3, 10))
            m = np.zeros(n)
            m[on * cfg_u.inplen: off * cfg_u.inplen] = 1.0
            x = x + float(rng.uniform(1.5, 3.0)) * m * np.exp(
                2j * np.pi * (bb / blocksize - 0.5) * t
            )
        x = x.astype(np.complex64)
        try:
            su, ss = sig(events(cfg_u, x)), sig(events(cfg_s, x))
            if su != ss:
                fails += 1
                print(f"DEVIATION seed={seed} n_parts={n_parts} ovl={ovl}")
                print("  U:", su)
                print("  S:", ss)
        except Exception:
            fails += 1
            print(f"ERROR seed={seed}")
            print(traceback.format_exc()[-500:])
    print(f"split-parity sweep: {n_seeds} seeds, {fails} deviations")


if __name__ == "__main__":
    main()
