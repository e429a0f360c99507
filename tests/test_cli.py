"""CLI tests: python -m fdc_tpu {template, config, run}.

The CLI is the analog of running the reference's GRC
flowgraph over a capture (reference: examples/FDC_example.grc); these
tests drive it in-process via fdc_tpu.__main__.main.
"""

import json

import numpy as np
import pytest

from fdc_tpu.__main__ import main


@pytest.fixture()
def config_path(tmp_path):
    from fdc_tpu.config import ChannelizerConfig

    cfg = ChannelizerConfig(
        blocksize=1024,
        relinvovl=4,
        throughput_channels=((0.12, 0.05),),
        activity_controlled_channels=((0.22, 0.1),),
        activity_detection_segments=((0.30, 0.42),),
        batch_blocks=16,
        max_slots=8,
    )
    p = tmp_path / "cfg.json"
    p.write_text(cfg.to_json())
    return p


def _capture(tmp_path, n_blocks=48, inplen=768):
    rng = np.random.default_rng(7)
    n = n_blocks * inplen
    t = np.arange(n)
    x = 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x = x + 0.9 * np.exp(2j * np.pi * 0.12 * t)
    burst = np.zeros(n)
    burst[n // 4: n // 2] = 1.0
    x = x + 0.8 * burst * np.exp(2j * np.pi * 0.22 * t)
    p = tmp_path / "capture.c64"
    x.astype(np.complex64).tofile(p)
    return p, n


def test_template_and_config(config_path, capsys):
    assert main(["template"]) == 0
    out = capsys.readouterr().out
    d = json.loads(out)
    assert d["blocksize"] == 4096

    assert main(["config", str(config_path)]) == 0
    out = capsys.readouterr().out
    assert "blocksize=1024" in out
    assert "throughput[0]:" in out
    assert "power_activation[0]:" in out
    assert "segment[0]:" in out


def _run(config_path, cap, out_dir, events_path, extra=()):
    argv = [
        "run", str(config_path), str(cap),
        "--out-dir", str(out_dir),
        "--events-jsonl", str(events_path),
        *extra,
    ]
    assert main(argv) == 0


def test_run_capture(config_path, tmp_path, capsys):
    cap, n = _capture(tmp_path)
    _run(config_path, cap, tmp_path / "out", tmp_path / "events.jsonl")
    out = capsys.readouterr().out
    assert f"samples in:       {n}" in out

    # throughput stream written and contiguous
    tp = np.fromfile(tmp_path / "out" / "throughput_ch0.c64", np.complex64)
    assert len(tp) > 0

    # burst event emitted: metadata JSONL + payload file in out_dir
    lines = [json.loads(s)
             for s in (tmp_path / "events.jsonl").read_text().splitlines()]
    assert len(lines) >= 1
    pa = [d for d in lines if "PowActChan" in d["ID"]]
    assert pa and pa[0]["nsamples"] > 0
    payloads = (list((tmp_path / "out").glob("*.fin"))
                + list((tmp_path / "out").glob("*.parted.*")))
    assert payloads

    # the pure-Python buffering path produces the identical stream
    _run(config_path, cap, tmp_path / "out2", tmp_path / "ev2.jsonl",
         extra=("--no-native",))
    tp2 = np.fromfile(tmp_path / "out2" / "throughput_ch0.c64", np.complex64)
    np.testing.assert_array_equal(tp, tp2)


def test_vcm_standalone(config_path, tmp_path, capsys):
    """vcm subcommand detects a scripted burst inside the segment and
    writes payload files + metadata JSONL."""
    # segment (0.30, 0.42) is normalized-freqmode, i.e. FDC coords
    # [0.80, 0.92); a carrier at normalized 0.35 (FDC 0.85) sits inside
    rng = np.random.default_rng(3)
    inplen = 768
    n = 64 * inplen
    t = np.arange(n)
    x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    burst = np.zeros(n)
    burst[16 * inplen: 40 * inplen] = 1.0
    x = x + 0.9 * burst * np.exp(2j * np.pi * 0.35 * t)
    cap = tmp_path / "vcm.c64"
    x.astype(np.complex64).tofile(cap)

    ev_path = tmp_path / "vcm_events.jsonl"
    assert main(["vcm", str(config_path), str(cap),
                 "--out-dir", str(tmp_path / "vout"),
                 "--events-jsonl", str(ev_path)]) == 0
    out = capsys.readouterr().out
    assert "blocks processed: 64" in out
    lines = [json.loads(s) for s in ev_path.read_text().splitlines()]
    assert lines, "burst in-segment must emit at least one event"
    hits = [d for d in lines
            if d["finalized"] and 0.80 < d["rel_cfreq"] < 0.92
            and d["blockend"] >= 16 and d["blockstart"] <= 40]
    assert hits, f"no finalized event matches the burst: {lines}"
    assert list((tmp_path / "vout").glob("*.fin"))


def test_serve_socket(config_path, tmp_path):
    """serve: a TCP client streams the capture, the CLI writes the same
    outputs run produces for the file."""
    import socket
    import threading
    import time

    cap, n = _capture(tmp_path)
    x = np.fromfile(cap, np.complex64)

    out_dir = tmp_path / "sout"
    port_file = tmp_path / "port.txt"
    wf_png = tmp_path / "live_wf.png"
    th = threading.Thread(
        target=main,
        args=(["serve", str(config_path), "--port", "0",
               "--port-file", str(port_file),
               "--waterfall-follow", str(wf_png),
               "--out-dir", str(out_dir)],),
        daemon=True,
    )
    th.start()
    deadline = time.time() + 30
    while not port_file.exists() or not port_file.read_text():
        assert time.time() < deadline, "serve never started listening"
        time.sleep(0.05)
    port = int(port_file.read_text())
    with socket.create_connection(("127.0.0.1", port), timeout=5) as conn:
        conn.settimeout(None)  # sendall must block, not flake on stalls
        conn.sendall(x.tobytes())
    th.join(timeout=60)
    assert not th.is_alive()

    tp = np.fromfile(out_dir / "throughput_ch0.c64", np.complex64)
    _run(config_path, cap, tmp_path / "fout", tmp_path / "fev.jsonl")
    tp_file = np.fromfile(tmp_path / "fout" / "throughput_ch0.c64",
                          np.complex64)
    np.testing.assert_array_equal(tp, tp_file)

    try:
        import matplotlib  # noqa: F401
        assert wf_png.exists() and wf_png.stat().st_size > 0
    except ImportError:
        pass


def test_run_missing_file_raises(config_path, tmp_path):
    with pytest.raises(IOError):
        main(["run", str(config_path), str(tmp_path / "nope.c64")])


def test_run_flushes_ragged_tail(config_path, tmp_path, capsys):
    """A capture that is not a whole number of batches still gets its
    tail processed (zero-pad flush), native and fallback paths equal."""
    cap, _ = _capture(tmp_path)
    x = np.fromfile(cap, np.complex64)[:-1000]  # 46.7 blocks
    x.tofile(cap)
    n_blocks = -(-len(x) // 768)  # ceil: 47

    _run(config_path, cap, tmp_path / "nat", tmp_path / "ev_n.jsonl")
    out = capsys.readouterr().out
    assert f"blocks processed: {n_blocks}" in out
    _run(config_path, cap, tmp_path / "pyf", tmp_path / "ev_p.jsonl",
         extra=("--no-native",))
    a = np.fromfile(tmp_path / "nat" / "throughput_ch0.c64", np.complex64)
    b = np.fromfile(tmp_path / "pyf" / "throughput_ch0.c64", np.complex64)
    np.testing.assert_array_equal(a, b)
    assert len(a) == n_blocks * 48  # out_len=48 for the 64-bin channel


def test_run_checkpoint_resume(config_path, tmp_path):
    """Splitting a capture across two runs with --checkpoint/--resume
    yields the same throughput stream as one uninterrupted run — even
    when the split point and the capture length are NOT batch multiples
    (the checkpoint carries the sub-batch tail; flush pads the end)."""
    cap, _ = _capture(tmp_path)  # 48 blocks = 3 exact batches
    x = np.fromfile(cap, np.complex64)[:-1000]  # ragged capture end
    x.tofile(cap)
    split = 2 * 16 * 768 + 777  # mid-batch split point
    (tmp_path / "a.c64").write_bytes(x[:split].tobytes())
    (tmp_path / "b.c64").write_bytes(x[split:].tobytes())
    ckpt = tmp_path / "state.ckpt"

    _run(config_path, cap, tmp_path / "full", tmp_path / "ev_f.jsonl")
    _run(config_path, tmp_path / "a.c64", tmp_path / "p1",
         tmp_path / "ev1.jsonl", extra=("--checkpoint", str(ckpt)))
    _run(config_path, tmp_path / "b.c64", tmp_path / "p2",
         tmp_path / "ev2.jsonl", extra=("--resume", str(ckpt)))

    full = np.fromfile(tmp_path / "full" / "throughput_ch0.c64",
                       np.complex64)
    a = np.fromfile(tmp_path / "p1" / "throughput_ch0.c64", np.complex64)
    b = np.fromfile(tmp_path / "p2" / "throughput_ch0.c64", np.complex64)
    np.testing.assert_array_equal(full, np.concatenate([a, b]))


def test_run_sharded_matches_plain(config_path, tmp_path):
    """--time-shards/--chan-shards produce the identical throughput stream
    (the conftest mesh provides 8 virtual CPU devices). Bit-identity
    holds on the matmul-DFT route (``use_mxu_fft``), whose per-row
    arithmetic does not depend on how many blocks a shard holds; the FFT
    library's rounding does (the sharded-vs-plain contract for that
    route is tests/test_parallel.py's rtol 2e-4 / atol 2e-5)."""
    from fdc_tpu.config import ChannelizerConfig

    cfg = ChannelizerConfig.from_json(config_path.read_text())
    config_path.write_text(cfg.replace(use_mxu_fft=True).to_json())
    cap, _ = _capture(tmp_path)
    _run(config_path, cap, tmp_path / "plain", tmp_path / "ev_p.jsonl")
    _run(config_path, cap, tmp_path / "shard", tmp_path / "ev_s.jsonl",
         extra=("--time-shards", "4", "--chan-shards", "2"))
    a = np.fromfile(tmp_path / "plain" / "throughput_ch0.c64", np.complex64)
    b = np.fromfile(tmp_path / "shard" / "throughput_ch0.c64", np.complex64)
    np.testing.assert_array_equal(a, b)


def test_run_pipeline_matches_plain(config_path, tmp_path):
    """--pipeline farms batches over the CPU-mesh devices via the MPMD
    pipeline driver; the throughput stream must equal the plain run's."""
    cap, _ = _capture(tmp_path)
    _run(config_path, cap, tmp_path / "plainp", tmp_path / "ev_pp.jsonl")
    _run(config_path, cap, tmp_path / "pipe", tmp_path / "ev_pl.jsonl",
         extra=("--pipeline", "4", "--dedicated-owner"))
    a = np.fromfile(tmp_path / "plainp" / "throughput_ch0.c64",
                    np.complex64)
    b = np.fromfile(tmp_path / "pipe" / "throughput_ch0.c64", np.complex64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_run_waterfall_style_flags(config_path, tmp_path):
    """The reference waterfall block's GRC style params are CLI flags
    (colorscheme index or name, dB range, tagmode); the PNG renders
    through the RAM-bounded decimating history path."""
    cap, _ = _capture(tmp_path)
    png = tmp_path / "wf.png"
    _run(config_path, cap, tmp_path / "o", tmp_path / "e.jsonl",
         extra=("--waterfall", str(png),
                "--waterfall-colorscheme", "black-rainbow",
                "--waterfall-db", "-80", "10",
                "--waterfall-tagmode", "id"))
    assert png.stat().st_size > 0
    # index form parses too
    _run(config_path, cap, tmp_path / "o2", tmp_path / "e2.jsonl",
         extra=("--waterfall", str(tmp_path / "wf2.png"),
                "--waterfall-colorscheme", "2"))
    assert (tmp_path / "wf2.png").stat().st_size > 0


def test_serve_max_conns(config_path, tmp_path):
    """serve --max-conns 2: two sequential connections on the SAME port
    concatenate into one logical stream (ring reopened between sources);
    outputs equal one connection carrying both halves."""
    import socket
    import threading
    import time

    cap, _ = _capture(tmp_path)
    x = np.fromfile(cap, np.complex64)
    half = len(x) // 2

    out_dir = tmp_path / "mout"
    port_file = tmp_path / "mport.txt"
    th = threading.Thread(
        target=main,
        args=(["serve", str(config_path), "--port", "0",
               "--port-file", str(port_file),
               "--max-conns", "2",
               "--out-dir", str(out_dir)],),
        daemon=True,
    )
    th.start()
    deadline = time.time() + 30
    while not port_file.exists() or not port_file.read_text():
        assert time.time() < deadline, "serve never started listening"
        time.sleep(0.05)
    port = int(port_file.read_text())
    mtime1 = port_file.stat().st_mtime_ns
    with socket.create_connection(("127.0.0.1", port), timeout=5) as conn:
        conn.settimeout(None)
        conn.sendall(x[:half].tobytes())
    # second connection: wait for the REBOUND listener (on_listen rewrites
    # the port file) — connecting earlier can land in the first listener's
    # kernel backlog and be dropped at its teardown
    deadline = time.time() + 30
    while port_file.stat().st_mtime_ns == mtime1:
        assert time.time() < deadline, "serve never re-listened"
        time.sleep(0.05)
    assert int(port_file.read_text()) == port  # same port across conns
    with socket.create_connection(("127.0.0.1", port), timeout=5) as conn:
        conn.settimeout(None)
        conn.sendall(x[half:].tobytes())
    th.join(timeout=60)
    assert not th.is_alive()

    tp = np.fromfile(out_dir / "throughput_ch0.c64", np.complex64)
    assert len(tp) > 0
    # single-connection reference over the same two halves with a flush
    # between (the per-connection tail is zero-pad flushed)
    from fdc_tpu.config import ChannelizerConfig
    from fdc_tpu.models.channelizer import FrequencyDomainChannelizer

    cfg = ChannelizerConfig.from_json(config_path.read_text())
    fdc = FrequencyDomainChannelizer(cfg)
    parts = []
    for seg in (x[:half], x[half:]):
        r = fdc.process(seg)
        parts.append(r.throughput[0])
        rf = fdc.flush()
        parts.append(rf.throughput[0])
    ref = np.concatenate(parts)
    np.testing.assert_array_equal(tp, ref)


def test_vcm_checkpoint_resume(config_path, tmp_path):
    """vcm --checkpoint/--resume: a mid-batch split resumes bit-identically
    to one uninterrupted run — detector carry, open-burst emitter state,
    front-end history, and the sub-batch sample tail all round-trip."""
    rng = np.random.default_rng(5)
    inplen = 768
    n = 64 * inplen
    t = np.arange(n)
    x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    burst = np.zeros(n)
    # burst OPEN at the split point (block 32) so emitter state matters
    burst[16 * inplen: 40 * inplen] = 1.0
    x = (x + 0.9 * burst * np.exp(2j * np.pi * 0.35 * t)).astype(
        np.complex64
    )
    cap = tmp_path / "vfull.c64"
    x.tofile(cap)
    split = 32 * inplen + 123  # mid-batch, mid-block, mid-burst
    (tmp_path / "va.c64").write_bytes(x[:split].tobytes())
    (tmp_path / "vb.c64").write_bytes(x[split:].tobytes())
    ckpt = tmp_path / "vstate.ckpt"

    def vcm(capture, ev, extra=()):
        assert main(["vcm", str(config_path), str(capture),
                     "--events-jsonl", str(ev), *extra]) == 0

    vcm(cap, tmp_path / "ev_full.jsonl")
    vcm(tmp_path / "va.c64", tmp_path / "ev_a.jsonl",
        extra=("--checkpoint", str(ckpt)))
    vcm(tmp_path / "vb.c64", tmp_path / "ev_b.jsonl",
        extra=("--resume", str(ckpt)))

    def norm(path):
        out = []
        for line in path.read_text().splitlines():
            d = json.loads(line)
            d["ID"] = d["ID"].split(".", 1)[1]  # drop wall-clock prefix
            out.append(d)
        return out

    full = norm(tmp_path / "ev_full.jsonl")
    split_evs = norm(tmp_path / "ev_a.jsonl") + norm(tmp_path / "ev_b.jsonl")
    assert full == split_evs
    assert len(full) > 0


def test_serve_sharded(config_path, tmp_path):
    """serve --time-shards/--chan-shards on a CPU mesh: the live TCP
    stream channelizes through the shard_map step; outputs match the
    plain file run within the sharded-vs-plain tolerance contract."""
    import socket
    import threading
    import time

    cap, _ = _capture(tmp_path)
    x = np.fromfile(cap, np.complex64)

    out_dir = tmp_path / "shout"
    port_file = tmp_path / "shport.txt"
    th = threading.Thread(
        target=main,
        args=(["serve", str(config_path), "--port", "0",
               "--port-file", str(port_file),
               "--cpu-devices", "8",
               "--time-shards", "2", "--chan-shards", "2",
               "--out-dir", str(out_dir)],),
        daemon=True,
    )
    th.start()
    deadline = time.time() + 60
    while not port_file.exists() or not port_file.read_text():
        assert time.time() < deadline, "sharded serve never listened"
        time.sleep(0.05)
    port = int(port_file.read_text())
    with socket.create_connection(("127.0.0.1", port), timeout=5) as conn:
        conn.settimeout(None)
        conn.sendall(x.tobytes())
    th.join(timeout=120)
    assert not th.is_alive()

    tp = np.fromfile(out_dir / "throughput_ch0.c64", np.complex64)
    _run(config_path, cap, tmp_path / "pout", tmp_path / "pev.jsonl")
    ref = np.fromfile(tmp_path / "pout" / "throughput_ch0.c64",
                      np.complex64)
    assert tp.shape == ref.shape
    np.testing.assert_allclose(tp, ref, rtol=2e-4, atol=2e-5)


def test_run_pipeline_composed_matches_plain(config_path, tmp_path):
    """--pipeline with --pipeline-shard-time: each worker is a time-shard
    group (pipeline x SPMD); stream must equal the plain run's."""
    cap, _ = _capture(tmp_path)
    _run(config_path, cap, tmp_path / "plainc", tmp_path / "ev_pc.jsonl")
    _run(config_path, cap, tmp_path / "comp", tmp_path / "ev_cm.jsonl",
         extra=("--pipeline", "4", "--pipeline-shard-time", "2",
                "--pipeline-scan-owners", "2"))
    a = np.fromfile(tmp_path / "plainc" / "throughput_ch0.c64",
                    np.complex64)
    b = np.fromfile(tmp_path / "comp" / "throughput_ch0.c64", np.complex64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_run_split_segment_flag(config_path, tmp_path):
    """--split-segment IDX:N[:OVL] expands the detection segment into
    sub-segments (config.segment_splits); the throughput stream is
    untouched and detection still fires (events present). Composes with
    --pipeline --pipeline-scan-owners (the flag's purpose)."""
    cap, _ = _capture(tmp_path)
    _run(config_path, cap, tmp_path / "plain_sp", tmp_path / "ev_a.jsonl")
    _run(config_path, cap, tmp_path / "split_sp", tmp_path / "ev_b.jsonl",
         extra=("--split-segment", "0:2:2", "--pipeline", "4",
                "--pipeline-scan-owners", "2", "--dedicated-owner"))
    a = np.fromfile(tmp_path / "plain_sp" / "throughput_ch0.c64",
                    np.complex64)
    b = np.fromfile(tmp_path / "split_sp" / "throughput_ch0.c64",
                    np.complex64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    ev = [json.loads(ln) for ln in
          (tmp_path / "ev_b.jsonl").read_text().splitlines()]
    assert any("DETECTED" in e["ID"] for e in ev)
    with pytest.raises(SystemExit):
        main(["run", str(config_path), str(cap),
              "--split-segment", "bogus"])
