"""REAL two-process jax.distributed validation of the multi-host path.

Spawns two separate Python processes that initialize jax.distributed
(gloo CPU collectives), build the same global (time, chan) mesh over both
processes' virtual devices, feed each process its own contiguous half of
every batch (fdc_tpu.parallel.multihost.host_local_batch), run the sharded
step as one SPMD program — the ppermute history exchange crosses the
process boundary — and check the emitted detection events against a
single-process FrequencyDomainChannelizer run.

This is the strongest validation of fdc_tpu/parallel/multihost.py possible
without pod hardware (the in-process CPU-mesh tests in test_parallel.py
never exercise a real coordination service or cross-process collectives).
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tools", "multihost_worker.py",
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("scenario", ["basic", "rich"])
def test_two_process_distributed_matches_single(scenario):
    """basic: one tp channel + one segment. rich:
    multi-channel width buckets, a tp+burst fused width family, and TWO
    segments — the per-segment scan ownership (chan rank i%2) and its
    psum broadcast cross the real process boundary."""
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), "2", str(port), scenario],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)

    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    assert "PROC0 MULTIHOST==SINGLE OK" in outs[0], outs[0][-3000:]
    # both processes see the identical replicated event stream
    line0 = [ln for ln in outs[0].splitlines() if ln.startswith("PROC0 EVENTS")]
    line1 = [ln for ln in outs[1].splitlines() if ln.startswith("PROC1 EVENTS")]
    assert line0 and line1
    assert line0[0].split("EVENTS", 1)[1] == line1[0].split("EVENTS", 1)[1]


_HOSTPIPE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tools", "hostpipe_worker.py",
)


@pytest.mark.parametrize("n_hosts", [2, 3])
def test_multiprocess_hostpipe_pipeline_matches_single(n_hosts):
    """REAL multi-process validation of the CROSS-PROCESS pipeline
    (fdc_tpu.parallel.hostpipe): the owner process
    runs the scan chain + merged emission, each worker process runs
    stages A/C for its round-robin batches over the TCP message
    protocol. n_hosts=3 exercises the owner's per-connection demux with
    batches interleaving across two workers. The owner asserts event
    parity against a single-process channelizer run and prints the OK
    marker checked here."""
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    cmds = [[sys.executable, _HOSTPIPE, "owner", str(port), str(n_hosts)]]
    for hid in range(1, n_hosts):
        cmds.append([sys.executable, _HOSTPIPE, "worker", str(port),
                     str(n_hosts), str(hid)])
    procs = [
        subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for cmd in cmds
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"{p.args} failed:\n{out[-3000:]}"
    assert "OWNER HOSTPIPE==SINGLE OK" in outs[0], outs[0][-3000:]
    for out in outs[1:]:
        assert "WORKER DONE" in out, out[-2000:]


def test_hostpipe_cli_two_process(tmp_path):
    """The --hostpipe-owner/--hostpipe-worker CLI surface: two `run`
    processes over the same capture; the owner's events must match a
    plain single-process `run` of the same capture."""
    import numpy as np

    from fdc_tpu.config import ChannelizerConfig

    cfg = ChannelizerConfig(
        blocksize=256, relinvovl=4,
        throughput_channels=[(-0.2, 0.05)],
        activity_detection_segments=[(0.1, 0.4)],
        act_det_threshold=8.0, minchandist=0.02,
        freqmode="basebandfs", batch_blocks=8,
    )
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    n = 6 * cfg.batch_blocks * cfg.inplen
    t = np.arange(n)
    rng = np.random.default_rng(5)
    x = (np.exp(2j * np.pi * -0.2 * t)
         + 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    m = np.zeros(n)
    m[9 * cfg.inplen: 30 * cfg.inplen] = 1.0
    x = (x + 2.0 * m * np.exp(2j * np.pi * 0.25 * t)).astype(np.complex64)
    cap = tmp_path / "cap.c64"
    x.tofile(cap)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()

    owner = subprocess.Popen(
        [sys.executable, "-m", "fdc_tpu", "run", str(cfg_path), str(cap),
         "--hostpipe-owner", "1", "--hostpipe-port", str(port),
         "--events-jsonl", str(tmp_path / "ev_owner.jsonl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=str(tmp_path),
    )
    worker = subprocess.Popen(
        [sys.executable, "-m", "fdc_tpu", "run", str(cfg_path), str(cap),
         "--hostpipe-worker", "1:2",
         "--hostpipe-connect", f"127.0.0.1:{port}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=str(tmp_path),
    )
    plain = subprocess.Popen(
        [sys.executable, "-m", "fdc_tpu", "run", str(cfg_path), str(cap),
         "--events-jsonl", str(tmp_path / "ev_plain.jsonl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=str(tmp_path),
    )
    outs = {}
    for name, p in (("owner", owner), ("worker", worker),
                    ("plain", plain)):
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in (owner, worker, plain):
                q.kill()
            raise
        outs[name] = out
        assert p.returncode == 0, f"{name} failed:\n{out[-3000:]}"

    import json as _json

    def sig(path):
        evs = [_json.loads(ln) for ln in path.read_text().splitlines()]
        return [(e["ID"].split(".", 1)[1], e["blockstart"], e["blockend"])
                for e in evs]

    s_owner = sig(tmp_path / "ev_owner.jsonl")
    s_plain = sig(tmp_path / "ev_plain.jsonl")
    assert s_owner == s_plain, (s_owner, s_plain)
    assert len(s_owner) >= 1
