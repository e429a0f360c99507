"""Measure the cross-process pipeline's handoff terms (hostpipe.py) on
loopback TCP: the per-batch PACKS->PLANS round-trip latency (the term
that rides the owner's serial chain) and the OUT payload ship rate (the
term that must stay under the batch period times the per-host worker
count).

Run:  JAX_PLATFORMS=cpu python tools/bench_hostpipe.py
"""
import json
import os
import socket
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from fdc_tpu.parallel.hostpipe import _recv_msg, _send_msg


def jax_free_state(sd):
    """A numpy replica of one segment's slot-state pytree (shapes only)."""
    s = sd.max_slots
    st = {k: np.zeros((s,), np.int32) for k in
          ("det_start", "det_stop", "ext_start", "wlog2", "phase",
           "phase_inc", "inactive", "order")}
    st["active"] = np.zeros((s,), bool)
    st["tomb"] = np.zeros((s,), bool)
    st["alloc_counter"] = np.int32(0)
    st["dropped"] = np.int32(0)
    return st


def main():
    # real flagship dimensions (B=512 batch)
    import __graft_entry__ as ge
    from fdc_tpu.models.channelizer import FrequencyDomainChannelizer

    B = 512
    cfg = ge._flagship(batch_blocks=B)
    fdc = FrequencyDomainChannelizer(cfg)
    sd = fdc.segments[0]
    k_pack = sd.k_pack

    packs = {
        "pa_powers": np.zeros(
            (B, len(fdc.power_bank.geometry)), np.float32
        ),
        "seg_packed": [
            np.zeros((B, 7 * s.k_pack), np.int32) for s in fdc.segments
        ],
    }
    states = [jax_free_state(s) for s in fdc.segments]
    plans_msg = {
        "states": states,
        "plans": [
            {"slot_ids": np.zeros((s.extract_budget,), np.int32)}
            for s in fdc.segments
        ],
    }
    out_msg = {
        "out_static": {
            "throughput_buckets": [
                np.zeros(
                    (len(b.channel_ids), B * b.out_len, 2), np.float32
                )
                for b in fdc.throughput.buckets
            ]
        },
        "pa_ext": {
            b.width: np.zeros(
                (len(b.channel_ids), B + 1, b.out_len, 2), np.float32
            )
            for b in fdc.power_bank.buckets
        },
        "seg_powers": [
            np.zeros((B, s.geometry.n_cells), np.float32)
            for s in fdc.segments
        ],
        "dbg": 0,
        "extracts": [
            {"extract": np.zeros(
                (s.extract_budget, B + 1, s.w_cap, 2), np.float32
            )}
            for s in fdc.segments
        ],
    }

    def tree_bytes(t):
        if isinstance(t, np.ndarray):
            return t.nbytes
        if isinstance(t, dict):
            return sum(tree_bytes(v) for v in t.values())
        if isinstance(t, (list, tuple)):
            return sum(tree_bytes(v) for v in t)
        return 0

    out_bytes = tree_bytes(out_msg)

    lsock = socket.socket()
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]

    def echo_server():
        s, _ = lsock.accept()
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                kind, b, payload = _recv_msg(s)
            except (ConnectionError, OSError):
                return
            if kind == "PACKS":
                _send_msg(s, "PLANS", b, plans_msg)
            elif kind == "BYE":
                s.close()
                return

    th = threading.Thread(target=echo_server, daemon=True)
    th.start()
    c = socket.create_connection(("127.0.0.1", port))
    c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    # warm + measure PACKS->PLANS round trip
    for _ in range(3):
        _send_msg(c, "PACKS", 0, packs)
        _recv_msg(c)
    n_it = 50
    t0 = time.perf_counter()
    for i in range(n_it):
        _send_msg(c, "PACKS", i, packs)
        _recv_msg(c)
    rt_ms = (time.perf_counter() - t0) / n_it * 1e3

    # OUT ship rate (send-only; the reader thread on the owner drains)
    for _ in range(2):
        _send_msg(c, "OUT", 0, out_msg)
    n_out = 20
    t0 = time.perf_counter()
    for i in range(n_out):
        _send_msg(c, "OUT", i, out_msg)
    out_ms = (time.perf_counter() - t0) / n_out * 1e3
    _send_msg(c, "BYE", -1, None)
    c.close()

    print(json.dumps({
        "packs_plans_roundtrip_ms": round(rt_ms, 3),
        "out_payload_mb": round(out_bytes / 1e6, 1),
        "out_ship_ms": round(out_ms, 3),
        "out_gbps": round(out_bytes * 8 / (out_ms / 1e3) / 1e9, 2),
    }))


if __name__ == "__main__":
    main()
