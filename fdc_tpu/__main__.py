"""Command-line entry point: run a channelizer config over a capture file.

The reference's user entry point is a GRC flowgraph (file source ->
FrequencyDomainChannelizer -> file/message sinks, reference:
examples/FDC_example.grc); the equivalent here is a JSON config
(the declarative schema ``ChannelizerConfig.to_json`` mirrors the GRC
param schema, reference: grc/FDC_FrequencyDomainChannelizer.xml) driven
over a raw complex64 capture by the native streaming runtime.

Usage:
  python -m fdc_tpu template > config.json
  python -m fdc_tpu config config.json            # validate + show geometry
  python -m fdc_tpu run config.json capture.c64 --out-dir out/ \
      --events-jsonl events.jsonl --waterfall wf.png
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

__all__ = ["main"]


def _load_config(path: str):
    from fdc_tpu.config import ChannelizerConfig

    with open(path) as f:
        return ChannelizerConfig.from_json(f.read())


def _cmd_template(args) -> int:
    from fdc_tpu.config import ChannelizerConfig

    cfg = ChannelizerConfig(
        throughput_channels=((0.12, 0.05),),
        activity_controlled_channels=((0.22, 0.1),),
        activity_detection_segments=((0.30, 0.42),),
    )
    print(cfg.to_json())
    return 0


def _cmd_config(args) -> int:
    """Validate a config and print the solved channel geometry (the
    introspectable output of the config compiler, reference:
    python/FrequencyDomainChannelizer.py:322-345)."""
    from fdc_tpu.config import (
        solve_power_channel,
        solve_segment,
        solve_throughput_channel,
    )

    cfg = _load_config(args.config)
    print(f"blocksize={cfg.blocksize} relinvovl={cfg.relinvovl} "
          f"inplen={cfg.inplen} batch_blocks={cfg.batch_blocks}")
    for i, (f, bw) in enumerate(cfg.fdc_throughput_channels()):
        g = solve_throughput_channel(cfg.blocksize, cfg.relinvovl, f, bw)
        print(f"throughput[{i}]: start={g.start} width={g.width} "
              f"out_len={g.out_len} passband={g.passband:.3f} "
              f"stopband={g.stopband:.3f}")
    for i, (f, bw) in enumerate(cfg.fdc_activity_controlled_channels()):
        g = solve_power_channel(cfg.blocksize, cfg.relinvovl, f, bw)
        print(f"power_activation[{i}]: extract=[{g.extract_start},"
              f"{g.extract_stop}) width={g.extract_width} "
              f"measure=[{g.measure_start},{g.measure_stop}) "
              f"out_len={g.out_len}")
    splits = {idx: (n, ovl) for idx, n, ovl in cfg.segment_splits}
    for i, (a, b) in enumerate(cfg.fdc_activity_detection_segments()):
        g = solve_segment(cfg.blocksize, a, b, cfg.minchandist)
        print(f"segment[{i}]: bins=[{g.start},{g.stop}) dec={g.decimation} "
              f"cells={g.n_cells}")
        if i in splits:
            from fdc_tpu.config import split_segment_geometry

            n_parts, ovl = splits[i]
            for p, (gp, core) in enumerate(
                split_segment_geometry(g, n_parts, ovl)
            ):
                print(f"  part[{p}]: scan=[{gp.start},{gp.stop}) "
                      f"core=[{core[0]},{core[1]}) cells={gp.n_cells}")
    return 0


def _print_stats(n_in, blocks, n_events, wall, batches=None):
    print(f"samples in:       {n_in}")
    print(f"blocks processed: {blocks}")
    if batches is not None:
        print(f"batches:          {batches}")
    print(f"events:           {n_events}")
    if wall > 0:
        print(f"throughput:       {n_in / wall / 1e6:.3g} MS/s "
              f"(wall {wall:.1f}s, includes compile)")


def _write_stream_outputs(out_dir, tp_parts):
    """Write per-channel throughput streams; event payload files were
    already written by the channelizer's FileSink."""
    for i, parts in enumerate(tp_parts):
        if parts:
            path = os.path.join(out_dir, f"throughput_ch{i}.c64")
            np.concatenate(parts).astype(np.complex64).tofile(path)
            print(f"wrote {path}")
    print(f"event files in {out_dir}/ (<ID>.fin / <ID>.parted.<n>)")


def _write_events_jsonl(path, events):
    with open(path, "w") as f:
        for e in events:
            d = e.to_dict()
            d["nsamples"] = int(len(e.data))
            f.write(json.dumps(d) + "\n")
    print(f"wrote {path}")


def _apply_splits(cfg, args):
    """--split-segment IDX:N_PARTS[:OVERLAP_CELLS] entries -> config
    segment_splits (the churn remedy 'more segments = more scan owners'
    as a CLI knob; see config.split_segment_geometry)."""
    import dataclasses

    specs = getattr(args, "split_segment", None) or []
    if not specs:
        return cfg
    splits = list(cfg.segment_splits)
    for spec in specs:
        parts = spec.split(":")
        if len(parts) not in (2, 3):
            raise SystemExit(
                f"--split-segment {spec!r}: expected IDX:N_PARTS"
                f"[:OVERLAP_CELLS]"
            )
        idx, n = int(parts[0]), int(parts[1])
        ovl = int(parts[2]) if len(parts) == 3 else 2
        splits.append((idx, n, ovl))
    return dataclasses.replace(cfg, segment_splits=tuple(splits))


def _make_hostpipe(cfg, args):
    """Build the cross-process pipeline end for --hostpipe-owner /
    --hostpipe-worker (fdc_tpu.parallel.hostpipe): every participating
    host runs the SAME `run` command over the SAME capture; events and
    stream outputs come out of the owner process only."""
    import time as _time

    if args.hostpipe_owner and args.hostpipe_worker:
        raise SystemExit(
            "--hostpipe-owner and --hostpipe-worker are exclusive"
        )
    if args.hostpipe_owner:
        from fdc_tpu.parallel.hostpipe import HostPipelineOwner

        fdc = HostPipelineOwner(
            cfg, n_workers=args.hostpipe_owner, port=args.hostpipe_port,
        )
        print(f"hostpipe owner listening on port {fdc.port} "
              f"({args.hostpipe_owner} worker(s))", flush=True)
        if args.hostpipe_port_file:
            with open(args.hostpipe_port_file, "w") as f:
                f.write(str(fdc.port))
        fdc.accept_workers()
        print("hostpipe workers connected", flush=True)
        return fdc
    try:
        hid, n_hosts = (int(v) for v in args.hostpipe_worker.split(":"))
    except ValueError:
        raise SystemExit(
            f"--hostpipe-worker {args.hostpipe_worker!r}: expected "
            f"HOST_ID:N_HOSTS"
        )
    addr, _, port_s = (args.hostpipe_connect or "").rpartition(":")
    if not addr or not port_s.isdigit():
        raise SystemExit(
            "--hostpipe-worker requires --hostpipe-connect ADDR:PORT"
        )
    from fdc_tpu.parallel.hostpipe import HostPipelineWorker

    # the owner may not have bound yet — retry briefly
    deadline = _time.time() + 60
    while True:
        try:
            return HostPipelineWorker(
                cfg, host_id=hid, n_hosts=n_hosts,
                owner_addr=addr, owner_port=int(port_s),
            )
        except OSError:
            if _time.time() > deadline:
                raise
            _time.sleep(0.2)


def _cmd_run(args) -> int:
    if args.cpu or args.cpu_devices:
        import jax

        jax.config.update("jax_platforms", "cpu")
        if args.cpu_devices:
            jax.config.update("jax_num_cpu_devices", args.cpu_devices)

    import dataclasses

    from fdc_tpu.models.channelizer import FrequencyDomainChannelizer
    from fdc_tpu.runtime.stream import StreamDriver

    cfg = _load_config(args.config)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        cfg = dataclasses.replace(
            cfg, fileoutput=True, outputpath=args.out_dir
        )
    if args.waterfall and not cfg.debug:
        cfg = dataclasses.replace(cfg, debug=True)
    cfg = _apply_splits(cfg, args)
    if args.hostpipe_owner or args.hostpipe_worker:
        if (args.pipeline or args.time_shards > 1
                or args.chan_shards > 1):
            raise SystemExit(
                "--hostpipe-* and --pipeline/--time-shards/--chan-shards "
                "are exclusive"
            )
        fdc = _make_hostpipe(cfg, args)
    elif args.pipeline:
        if args.time_shards > 1 or args.chan_shards > 1:
            raise SystemExit(
                "--pipeline and --time-shards/--chan-shards are exclusive"
            )
        import jax

        from fdc_tpu.parallel import PipelineChannelizer

        devs = jax.devices()
        if args.pipeline > 0:
            devs = devs[: args.pipeline]
        fdc = PipelineChannelizer(
            cfg, devices=devs, dedicated_owner=args.dedicated_owner,
            shard_time=args.pipeline_shard_time,
            scan_owners=args.pipeline_scan_owners,
        )
    elif args.time_shards > 1 or args.chan_shards > 1:
        from fdc_tpu.parallel import ShardedChannelizer, make_mesh

        mesh = make_mesh(n_time=args.time_shards, n_chan=args.chan_shards)
        fdc = ShardedChannelizer(cfg, mesh=mesh)
    else:
        fdc = FrequencyDomainChannelizer(cfg)
    if args.resume:
        from fdc_tpu.runtime.checkpoint import load_checkpoint

        load_checkpoint(fdc, args.resume)
        print(f"resumed from {args.resume}")

    events = []
    tp_parts: list = [[] for _ in cfg.fdc_throughput_channels()]
    wf_hist = None
    if args.waterfall:
        from fdc_tpu.utils.waterfall import DecimatingPowerHistory

        # RAM-bounded: long captures auto-decimate instead of holding the
        # full debug-spectrum history (O(blocks x blocklen)) in memory
        wf_hist = DecimatingPowerHistory(max_rows=2048)
    t_start = time.time()

    def consume(res):
        events.extend(res.events)
        for i, s in enumerate(res.throughput):
            tp_parts[i].append(s)
        if wf_hist is not None and res.debug_spectrum is not None:
            wf_hist.add(np.abs(res.debug_spectrum) ** 2)

    try:
        driver = StreamDriver(fdc, use_native=not args.no_native)
    except RuntimeError:
        driver = StreamDriver(fdc, use_native=False)

    # with --checkpoint the tail must stay unprocessed (carried in the
    # checkpoint's pending buffer) instead of being zero-pad flushed
    do_flush = not args.checkpoint
    if driver.ring is not None:
        results = driver.run_file(args.capture, on_result=consume,
                                  flush=do_flush)
        assert not results  # streamed through on_result
    else:
        # Python fallback: read the whole capture, process in batches.
        x = np.fromfile(args.capture, dtype=np.complex64)
        driver.push(x)
        while True:
            res = driver.run_once(timeout=0.0)
            if res is None:
                break
            consume(res)
        if do_flush:
            res = driver.flush()
            if res is not None:
                consume(res)
    if args.checkpoint:
        driver.drain_pending()
    wall = time.time() - t_start

    _print_stats(driver.stats.samples_in, driver.stats.blocks_processed,
                 len(events), wall, batches=driver.stats.batches)

    if args.out_dir:
        _write_stream_outputs(args.out_dir, tp_parts)

    if args.checkpoint:
        from fdc_tpu.runtime.checkpoint import save_checkpoint

        save_checkpoint(fdc, args.checkpoint)
        print(f"wrote {args.checkpoint}")

    if args.events_jsonl:
        _write_events_jsonl(args.events_jsonl, events)

    if wf_hist is not None and wf_hist.n_blocks:
        from fdc_tpu.utils.waterfall import Waterfall

        rows = wf_hist.rows()
        wf = Waterfall(blocklen=cfg.blocksize, width=1024,
                       height=max(64, len(rows)),
                       blockdecimation=wf_hist.dec,
                       colorscheme=args.waterfall_colorscheme,
                       db_range=(args.waterfall_db[0],
                                 args.waterfall_db[1]),
                       tagmode=args.waterfall_tagmode)
        wf.feed_rows(rows)
        wf.feed_events(events)
        if wf.save_png(args.waterfall):
            print(f"wrote {args.waterfall}")
        else:
            print("matplotlib unavailable; waterfall PNG skipped",
                  file=sys.stderr)
    if args.hostpipe_owner or args.hostpipe_worker:
        fdc.close()
    return 0


def _cmd_serve(args) -> int:
    """Listen on a TCP port for one connection of interleaved complex64
    samples and channelize it live (the network analog of ``run``)."""
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    if args.cpu_devices:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu_devices)

    import dataclasses

    from fdc_tpu.models.channelizer import FrequencyDomainChannelizer
    from fdc_tpu.runtime.stream import StreamDriver

    cfg = _load_config(args.config)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        cfg = dataclasses.replace(
            cfg, fileoutput=True, outputpath=args.out_dir
        )
    cfg = _apply_splits(cfg, args)
    live = None
    if args.waterfall_follow:
        from fdc_tpu.utils.waterfall import LiveWaterfall, Waterfall

        if not cfg.debug:
            cfg = dataclasses.replace(cfg, debug=True)
        live = LiveWaterfall(
            Waterfall(blocklen=cfg.blocksize, width=1024, height=512,
                      blockdecimation=1,
                      colorscheme=args.waterfall_colorscheme,
                      db_range=(args.waterfall_db[0],
                                args.waterfall_db[1]),
                      tagmode=args.waterfall_tagmode),
            interval=args.waterfall_interval,
            png_path=args.waterfall_follow,
        )
    if args.pipeline:
        if args.time_shards > 1 or args.chan_shards > 1:
            raise SystemExit(
                "--pipeline and --time-shards/--chan-shards are exclusive"
            )
        import jax

        from fdc_tpu.parallel import PipelineChannelizer

        devs = jax.devices()
        if args.pipeline > 0:
            devs = devs[: args.pipeline]
        fdc = PipelineChannelizer(
            cfg, devices=devs, dedicated_owner=args.dedicated_owner,
            shard_time=args.pipeline_shard_time,
            scan_owners=args.pipeline_scan_owners,
        )
    elif args.time_shards > 1 or args.chan_shards > 1:
        from fdc_tpu.parallel import ShardedChannelizer, make_mesh

        mesh = make_mesh(n_time=args.time_shards,
                         n_chan=args.chan_shards)
        fdc = ShardedChannelizer(cfg, mesh=mesh)
    else:
        fdc = FrequencyDomainChannelizer(cfg)
    driver = StreamDriver(fdc)

    events = []
    tp_parts: list = [[] for _ in cfg.fdc_throughput_channels()]

    def consume(res):
        events.extend(res.events)
        for i, s in enumerate(res.throughput):
            tp_parts[i].append(s)
        if live is not None and res.debug_spectrum is not None:
            live.update(power_blocks=np.abs(res.debug_spectrum) ** 2,
                        events=res.events)

    bound_port = [args.port]

    def on_listen(p):
        bound_port[0] = p
        print(f"listening on {args.bind or '127.0.0.1'}:{p}", flush=True)
        if args.port_file:
            with open(args.port_file, "w") as f:
                f.write(str(p))

    # --max-conns: serve N sequential connections on the SAME port
    # (0 = forever, until interrupted). Connections concatenate into one
    # logical stream — the channelizer carry persists; each connection's
    # sub-batch tail is zero-pad flushed when the peer closes (the same
    # end-of-stream semantics as run_file).
    t_start = time.time()
    total_samples = 0
    conns = 0
    try:
        while True:
            driver.run_socket(
                port=bound_port[0],
                bind_addr=args.bind,
                on_result=consume,
                on_listen=on_listen,
            )
            total_samples += driver.stats.samples_in
            conns += 1
            if args.max_conns and conns >= args.max_conns:
                break
    except KeyboardInterrupt:
        print("interrupted — writing outputs", file=sys.stderr)
    wall = time.time() - t_start

    if conns > 1:
        print(f"connections:      {conns}")
    _print_stats(total_samples, driver.stats.blocks_processed,
                 len(events), wall, batches=driver.stats.batches)
    if live is not None:
        live.update(force=True)  # final frame
        print(f"wrote {args.waterfall_follow} ({live.frames} frames)")
    if args.out_dir:
        _write_stream_outputs(args.out_dir, tp_parts)
    if args.events_jsonl:
        _write_events_jsonl(args.events_jsonl, events)
    return 0


def _cmd_vcm(args) -> int:
    """Standalone multi-segment detector over a capture — the analog of
    wiring the reference's activity_detection_channelizer_vcm block
    behind an external FFT (reference:
    grc/FDC_activity_detection_channelizer_vcm.xml): an overlap-save
    FFT front-end feeds pre-FFT'd spectra into ActivityDetectionRunner.
    """
    if args.cpu:
        import jax as _jax

        _jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp

    from fdc_tpu.models.activity_detection import (
        ActivityDetectionChannelizer,
        ActivityDetectionRunner,
    )
    from fdc_tpu.ops.fft import forward_spectrum
    from fdc_tpu.ops.framing import frame_blocks
    from fdc_tpu.utils.cplx import c2f, c2f_host, f2c, f2c_host
    from fdc_tpu.utils.events import FileSink

    cfg = _load_config(args.config)
    if cfg.segment_splits:
        # fail loud rather than silently detect with unsplit segments:
        # the vcm block's segments are already independent automata, so
        # list the parts as separate segments instead
        raise SystemExit(
            "segment_splits is not supported by the vcm block (its "
            "segments are already independent — list the sub-bands as "
            "separate activity_detection_segments)"
        )
    segs = [list(s) for s in cfg.fdc_activity_detection_segments()]
    if not segs:
        print("config has no activity_detection_segments", file=sys.stderr)
        return 2
    adc = ActivityDetectionChannelizer(
        blocklen=cfg.blocksize,
        segments=segs,
        thresh_db=cfg.act_det_threshold,
        relinvovl=cfg.relinvovl,
        minchandist=cfg.minchandist,
        channel_deactivation_delay=cfg.act_det_deactivation_delay,
        window_flank_puffer=cfg.minchanflankpuffer,
        max_slots=cfg.max_slots,
        max_candidates=cfg.max_candidates,
        max_extract_width=cfg.max_extract_width,
        verbose=cfg.verbose,
        extract_budget=cfg.extract_budget,
        extract_width_split=cfg.extract_width_split,
        extract_budget_narrow=cfg.extract_budget_narrow,
    )
    sink = None
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        sink = FileSink(args.out_dir)
    runner = ActivityDetectionRunner(
        adc, maxblocks=cfg.act_det_maxblocks, file_sink=sink,
        msg_output=True, native_emission=cfg.native_emission,
    )

    blocklen, r = cfg.blocksize, cfg.relinvovl
    inplen = blocklen - blocklen // r

    @jax.jit
    def front(histf, xf):
        blocks, hist2 = frame_blocks(f2c(xf), f2c(histf), blocklen)
        return c2f(hist2), c2f(
            forward_spectrum(blocks, use_mxu=cfg.use_mxu_fft)
        )

    x = np.fromfile(args.capture, dtype=np.complex64)
    histf = jnp.asarray(c2f_host(np.zeros(blocklen // r, np.complex64)))
    if args.resume:
        from fdc_tpu.runtime.checkpoint import load_vcm_checkpoint

        extra = load_vcm_checkpoint(runner, args.resume)
        histf = jnp.asarray(extra["histf"])
        x = np.concatenate(
            [np.asarray(extra["pending"], np.complex64), x]
        )
        print(f"resumed from {args.resume}")
    nb_total = len(x) // inplen
    if nb_total == 0 and not args.checkpoint:
        print("capture shorter than one block", file=sys.stderr)
        return 2
    events = []
    t_start = time.time()
    step = cfg.batch_blocks * inplen
    # with --checkpoint, only whole batches run (never padded) — the
    # remainder is carried in the checkpoint so a split capture resumes
    # bit-identically (same contract as run --checkpoint)
    n_proc = (
        (len(x) // step) * step if args.checkpoint else nb_total * inplen
    )
    for off in range(0, n_proc, step):
        chunk = x[off: off + step]
        chunk = chunk[: (len(chunk) // inplen) * inplen]
        if not len(chunk):
            break
        if len(chunk) < step:
            # zero-pad the tail to the fixed batch shape so the jitted
            # front-end and runner step never recompile for a ragged final
            # chunk. Zeros drive in-band
            # power to zero, so open bursts see a falling edge and
            # finalize — the same end-of-stream semantics as
            # FrequencyDomainChannelizer.flush().
            chunk = np.concatenate(
                [chunk, np.zeros(step - len(chunk), np.complex64)]
            )
        histf, specf = front(histf, jnp.asarray(c2f_host(chunk)))
        events.extend(runner.process_spectra(f2c_host(np.asarray(specf))))
    if not args.checkpoint:
        # end-of-stream finalize (the flush(finalize=True) contract):
        # keep feeding silence batches until every slot has aged out, so
        # the emitted event set does not depend on the capture length
        # mod batch — a capture ending exactly on a batch boundary
        # finalizes identically to a ragged one. Bound shared with
        # FrequencyDomainChannelizer.flush (finalize_rounds_bound).
        from fdc_tpu.models.channelizer import finalize_rounds_bound

        zeros = jnp.asarray(c2f_host(np.zeros(step, np.complex64)))
        for _ in range(finalize_rounds_bound(adc.segments,
                                             cfg.batch_blocks)):
            if not runner.has_open_slots():
                break
            histf, specf = front(histf, zeros)
            events.extend(
                runner.process_spectra(f2c_host(np.asarray(specf)))
            )
    wall = time.time() - t_start

    if args.checkpoint:
        from fdc_tpu.runtime.checkpoint import save_vcm_checkpoint

        save_vcm_checkpoint(
            runner, args.checkpoint,
            extra={"histf": np.asarray(histf), "pending": x[n_proc:]},
        )
        print(f"wrote {args.checkpoint}")
        nb_done = n_proc // inplen
    else:
        nb_done = nb_total
    print(f"blocks processed: {nb_done}")
    print(f"events:           {len(events)}")
    print(f"throughput:       {nb_done * inplen / max(wall, 1e-9) / 1e6:.3g}"
          f" MS/s (wall {wall:.1f}s, includes compile)")
    if args.out_dir:
        print(f"event files in {args.out_dir}/")
    if args.events_jsonl:
        _write_events_jsonl(args.events_jsonl, events)
    return 0


def _add_waterfall_style_args(p):
    """The reference waterfall block's GRC style params
    (reference: grc/FDC_WaterfallMsgTagging.xml: colorscheme, dB range,
    tagmode) as CLI flags."""
    from fdc_tpu.utils.waterfall import COLOR_SCHEMES, Waterfall

    def scheme(x):
        # index or name; Waterfall validates names
        return int(x) if str(x).lstrip("-").isdigit() else x

    p.add_argument("--waterfall-colorscheme", default=0, type=scheme,
                   help="reference scheme index 0-3 or name "
                        f"({', '.join(COLOR_SCHEMES)})")
    p.add_argument("--waterfall-db", type=float, nargs=2,
                   default=(-100.0, 0.0), metavar=("MIN", "MAX"),
                   help="dB color-binning range")
    p.add_argument("--waterfall-tagmode", default="none",
                   choices=Waterfall.TAGMODES,
                   help="draw event labels: none / id / part")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fdc_tpu",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("template", help="print a starter config JSON")

    p_cfg = sub.add_parser("config", help="validate config, show geometry")
    p_cfg.add_argument("config")

    p_run = sub.add_parser("run", help="run a config over a capture file")
    p_run.add_argument("config")
    p_run.add_argument("capture", help="raw complex64 file")
    p_run.add_argument("--out-dir", default="",
                       help="write event files + throughput streams here")
    p_run.add_argument("--events-jsonl", default="",
                       help="write event metadata as JSON lines")
    p_run.add_argument("--waterfall", default="",
                       help="render a waterfall PNG with event overlays "
                            "(forces debug spectra on)")
    _add_waterfall_style_args(p_run)
    p_run.add_argument("--cpu", action="store_true", help="force CPU")
    p_run.add_argument("--no-native", action="store_true",
                       help="skip the native ring (pure-Python buffering)")
    p_run.add_argument("--pipeline", type=int, nargs="?", const=-1,
                       default=0, metavar="N",
                       help="MPMD batch pipeline over N devices (no N = "
                            "all); exclusive with --*-shards")
    p_run.add_argument("--dedicated-owner", action="store_true",
                       help="pipeline: the scan device does no "
                            "extraction (use at >= 4 devices)")
    p_run.add_argument("--pipeline-shard-time", type=int, default=1,
                       metavar="T",
                       help="pipeline x SPMD: each worker is a T-device "
                            "time-shard group (batch_blocks and "
                            "batch_blocks/T must stay multiples of "
                            "relinvovl)")
    p_run.add_argument("--hostpipe-owner", type=int, default=0,
                       metavar="N_WORKERS",
                       help="cross-process pipeline OWNER: run the scan "
                            "chain + merged emission here, accept "
                            "N_WORKERS worker processes (every host runs "
                            "the same run command over the same capture)")
    p_run.add_argument("--hostpipe-port", type=int, default=0,
                       help="owner listen port (0 = ephemeral)")
    p_run.add_argument("--hostpipe-port-file", default="",
                       help="owner: write the bound port here")
    p_run.add_argument("--hostpipe-worker", default="",
                       metavar="HOST_ID:N_HOSTS",
                       help="cross-process pipeline WORKER: run stages "
                            "A/C for this host's batches (outputs come "
                            "out of the owner process)")
    p_run.add_argument("--hostpipe-connect", default="",
                       metavar="ADDR:PORT",
                       help="worker: the owner's address")
    p_run.add_argument("--split-segment", action="append", default=[],
                       metavar="IDX:N_PARTS[:OVERLAP_CELLS]",
                       help="partition detection segment IDX into "
                            "N_PARTS sub-segments with OVERLAP_CELLS "
                            "(default 2) of scan margin at each cut — "
                            "more segments = more pipeline scan owners "
                            "(repeatable)")
    p_run.add_argument("--pipeline-scan-owners", type=int, default=1,
                       metavar="N",
                       help="pipeline: spread segment scan chains over "
                            "N owner devices (multi-segment configs)")
    p_run.add_argument("--time-shards", type=int, default=1,
                       help="shard time-blocks over this many devices")
    p_run.add_argument("--chan-shards", type=int, default=1,
                       help="shard channel groups over this many devices")
    p_run.add_argument("--cpu-devices", type=int, default=0,
                       help="force N virtual CPU devices (mesh testing)")
    p_run.add_argument("--checkpoint", default="",
                       help="save the streaming state here when done "
                            "(skips the end-of-stream flush: the "
                            "sub-batch tail is carried in the checkpoint)")
    p_run.add_argument("--resume", default="",
                       help="restore streaming state saved by --checkpoint")

    p_srv = sub.add_parser(
        "serve", help="channelize one TCP connection of complex64 samples"
    )
    p_srv.add_argument("config")
    p_srv.add_argument("--port", type=int, default=0,
                       help="TCP port (0 = ephemeral, printed on listen)")
    p_srv.add_argument("--bind", default="",
                       help="bind address (default 127.0.0.1)")
    p_srv.add_argument("--port-file", default="",
                       help="write the bound port here once listening "
                            "(for scripting with --port 0)")
    p_srv.add_argument("--max-conns", type=int, default=1,
                       help="serve this many sequential connections on "
                            "the same port (0 = forever); connections "
                            "concatenate into one logical stream")
    p_srv.add_argument("--waterfall-follow", default="",
                       help="live waterfall: overwrite this PNG as "
                            "batches arrive (forces debug spectra on)")
    p_srv.add_argument("--waterfall-interval", type=float, default=0.2,
                       help="minimum seconds between waterfall redraws")
    _add_waterfall_style_args(p_srv)
    p_srv.add_argument("--out-dir", default="",
                       help="write event files + throughput streams here")
    p_srv.add_argument("--events-jsonl", default="",
                       help="write event metadata as JSON lines")
    p_srv.add_argument("--cpu", action="store_true", help="force CPU")
    p_srv.add_argument("--pipeline", type=int, nargs="?", const=-1,
                       default=0, metavar="N",
                       help="MPMD batch pipeline over N devices (no N = "
                            "all); exclusive with --*-shards")
    p_srv.add_argument("--dedicated-owner", action="store_true",
                       help="pipeline: the scan device does no "
                            "extraction (use at >= 4 devices)")
    p_srv.add_argument("--pipeline-shard-time", type=int, default=1,
                       metavar="T",
                       help="pipeline x SPMD: each worker is a T-device "
                            "time-shard group")
    p_srv.add_argument("--split-segment", action="append", default=[],
                       metavar="IDX:N_PARTS[:OVERLAP_CELLS]",
                       help="partition detection segment IDX into "
                            "N_PARTS sub-segments with OVERLAP_CELLS "
                            "(default 2) of scan margin at each cut — "
                            "more segments = more pipeline scan owners "
                            "(repeatable)")
    p_srv.add_argument("--pipeline-scan-owners", type=int, default=1,
                       metavar="N",
                       help="pipeline: spread segment scan chains over "
                            "N owner devices (multi-segment configs)")
    p_srv.add_argument("--time-shards", type=int, default=1,
                       help="shard time-blocks over this many devices")
    p_srv.add_argument("--chan-shards", type=int, default=1,
                       help="shard channel groups over this many devices")
    p_srv.add_argument("--cpu-devices", type=int, default=0,
                       help="force N virtual CPU devices (mesh testing)")

    p_vcm = sub.add_parser(
        "vcm", help="standalone multi-segment detector (vcm semantics)"
    )
    p_vcm.add_argument("config")
    p_vcm.add_argument("capture", help="raw complex64 file")
    p_vcm.add_argument("--out-dir", default="",
                       help="write event payload files here")
    p_vcm.add_argument("--events-jsonl", default="",
                       help="write event metadata as JSON lines")
    p_vcm.add_argument("--cpu", action="store_true", help="force CPU")
    p_vcm.add_argument("--checkpoint", default="",
                       help="save the detector streaming state here when "
                            "done (whole batches only; the tail is "
                            "carried in the checkpoint)")
    p_vcm.add_argument("--resume", default="",
                       help="restore state saved by --checkpoint")
    args = ap.parse_args(argv)
    if args.cmd in ("run", "serve", "vcm"):
        from fdc_tpu.utils.compile_cache import enable_compile_cache

        enable_compile_cache()

    return {"template": _cmd_template,
            "config": _cmd_config,
            "run": _cmd_run,
            "serve": _cmd_serve,
            "vcm": _cmd_vcm}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
