"""Cross-process (multi-host) batch pipeline: the MPMD pipeline's ≥2-host
leg.

The single-process :class:`~fdc_tpu.parallel.pipeline.PipelineChannelizer`
keeps one scan-owner chain and farms whole batches over local devices.
This module stretches the same decomposition over PROCESSES: the OWNER
host keeps the sequential stage-B scan chain (and the merged, in-order
emission), while every host — owner included — runs the heavy stages A
(front-end + static extraction + candidate packing) and C (slot
extraction) for its share of batches on its own local devices.

Only the pipeline's true dependencies cross hosts, exactly the fan-out
the reference runs across threads
(reference: lib/activity_detection_channelizer_vcm_impl.cc:293-304,
lib/SegmentDetection_impl.cc:367-397 — here across processes):

- worker -> owner  PACKS: the [B, 7K] packed candidate rows + powact
  power columns (KB scale);
- owner -> worker  PLANS: post-scan slot tables + extraction plans
  (KB scale);
- worker -> owner  OUT:   the batch's extraction outputs for host-merged
  emission and stream assembly (the bulk payload — it exists because the
  owner is the single event/stream sink, the PDU fan-in role of the
  reference hier block's msgout port).

Transport is a length-prefixed TCP message protocol carrying a typed
numpy pytree (no pickle — a fixed, versioned codec; see _enc/_dec).
Batches are assigned round-robin over hosts (batch b belongs to host
b % n_hosts); each host feeds the SAME sample stream to ``process`` (the
natural deployment has every host fronting the full digitizer stream;
a per-host stream splitter only needs to deliver each host its batches
plus one block of overlap). The owner consumes batches strictly in
order, so the merged event stream is identical to the single-process
pipeline's.

Scope: ``process`` (sample mode) is distributed; ``flush``/finalize runs
owner-local (rare, end-of-stream — correctness over parallelism), and
``process_spectra``/checkpointing keep the single-process paths. Use
jax.distributed + ShardedChannelizer (parallel/multihost.py) when SPMD
fits the workload instead; this module exists for the shapes where the
pipeline mechanism is the one that scales (extraction-dominated
configs).
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from queue import Queue
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from fdc_tpu.config import ChannelizerConfig
from fdc_tpu.parallel.pipeline import PipelineChannelizer
from fdc_tpu.utils.cplx import c2f_host

__all__ = ["HostPipelineOwner", "HostPipelineWorker"]


# ---------------------------------------------------------------------------
# typed numpy pytree codec (length-prefixed; no pickle)
# ---------------------------------------------------------------------------

_MAGIC = b"FDCP"
_VERSION = 1


def _enc_tree(obj, bufs):
    """obj -> JSON-able spec; numpy arrays appended to ``bufs``."""
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, (bool, np.bool_)):
        return {"t": "b", "v": bool(obj)}
    if isinstance(obj, (int, np.integer)):
        return {"t": "i", "v": int(obj)}
    if isinstance(obj, (float, np.floating)):
        return {"t": "f", "v": float(obj)}
    if isinstance(obj, str):
        return {"t": "s", "v": obj}
    if isinstance(obj, dict):
        keys = list(obj.keys())
        if not all(isinstance(k, (str, int)) for k in keys):
            raise TypeError(f"unsupported dict key types: {keys!r}")
        return {
            "t": "d",
            "k": [[("s" if isinstance(k, str) else "i"), k] for k in keys],
            "v": [_enc_tree(obj[k], bufs) for k in keys],
        }
    if isinstance(obj, tuple):
        return {"t": "t", "v": [_enc_tree(x, bufs) for x in obj]}
    if isinstance(obj, list):
        return {"t": "l", "v": [_enc_tree(x, bufs) for x in obj]}
    a = np.asarray(obj)  # numpy scalars/arrays and jax arrays
    a = np.ascontiguousarray(a)
    bufs.append(a.tobytes())
    return {"t": "a", "d": a.dtype.str, "sh": list(a.shape)}


def _dec_tree(spec, bufs, pos):
    t = spec["t"]
    if t == "none":
        return None, pos
    if t in ("b", "i", "f", "s"):
        return spec["v"], pos
    if t == "d":
        out = {}
        for (kt, k), v in zip(spec["k"], spec["v"]):
            out[k if kt == "s" else int(k)], pos = _dec_tree(v, bufs, pos)
        return out, pos
    if t in ("t", "l"):
        vals = []
        for v in spec["v"]:
            x, pos = _dec_tree(v, bufs, pos)
            vals.append(x)
        return (tuple(vals) if t == "t" else vals), pos
    if t == "a":
        a = np.frombuffer(bufs[pos], dtype=np.dtype(spec["d"])).reshape(
            spec["sh"]
        )
        return a, pos + 1
    raise ValueError(f"bad spec type {t!r}")


def _send_msg(sock: socket.socket, kind: str, batch: int, payload):
    bufs: List[bytes] = []
    spec = _enc_tree(payload, bufs)
    header = json.dumps(
        {"k": kind, "b": batch, "spec": spec, "n": [len(x) for x in bufs]}
    ).encode()
    parts = [
        _MAGIC, struct.pack("<II", _VERSION, len(header)), header
    ] + bufs
    sock.sendall(b"".join(parts))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        c = sock.recv(min(n, 1 << 20))
        if not c:
            raise ConnectionError("peer closed mid-message")
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _recv_msg(sock: socket.socket):
    magic = _recv_exact(sock, 4)
    if magic != _MAGIC:
        raise ConnectionError(f"bad magic {magic!r}")
    ver, hlen = struct.unpack("<II", _recv_exact(sock, 8))
    if ver != _VERSION:
        raise ConnectionError(f"protocol version {ver} != {_VERSION}")
    h = json.loads(_recv_exact(sock, hlen))
    bufs = [_recv_exact(sock, n) for n in h["n"]]
    payload, _ = _dec_tree(h["spec"], bufs, 0)
    return h["k"], h["b"], payload


# ---------------------------------------------------------------------------
# owner
# ---------------------------------------------------------------------------


class _WorkerConn:
    """One worker's connection: a reader thread demuxing messages by kind
    (PACKS and OUT interleave on the wire; the owner must never block on
    one kind while the other backs up the socket)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.queues = {"PACKS": Queue(), "OUT": Queue(), "BYE": Queue()}
        self._err: Optional[BaseException] = None
        self._th = threading.Thread(target=self._read_loop, daemon=True)
        self._th.start()

    def _read_loop(self):
        try:
            while True:
                kind, b, payload = _recv_msg(self.sock)
                self.queues[kind].put((b, payload))
                if kind == "BYE":
                    return
        except BaseException as e:  # surfaced on next get()
            self._err = e
            for q in self.queues.values():
                q.put((-1, None))

    def get(self, kind: str, timeout: float):
        from queue import Empty

        try:
            b, payload = self.queues[kind].get(timeout=timeout)
        except Empty:
            raise ConnectionError(
                f"timed out after {timeout:.0f}s waiting for a {kind} "
                f"message from the worker (is it still running?)"
            ) from None
        if b == -1 and self._err is not None:
            raise ConnectionError(
                f"worker connection failed: {self._err!r}"
            ) from self._err
        return b, payload

    def send(self, kind: str, batch: int, payload):
        _send_msg(self.sock, kind, batch, payload)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class HostPipelineOwner(PipelineChannelizer):
    """The owner-host end of the cross-process pipeline.

    Listens for ``n_workers`` worker connections, then ``process`` runs
    the shared stage-B scan chain for EVERY batch (in batch order) while
    stages A/C of remote batches run on the worker hosts. Events and
    stream outputs come out of the owner's result only, identical to the
    single-process pipeline (event-exact; pinned by
    tests/test_multihost_twoprocess.py::..._pipeline)."""

    def __init__(self, config: Optional[ChannelizerConfig] = None,
                 n_workers: int = 1, port: int = 0,
                 bind_addr: str = "127.0.0.1", timeout: float = 240.0,
                 **kwargs):
        super().__init__(config, **kwargs)
        if self.shard_time > 1 or self._owner_groups:
            raise ValueError(
                "HostPipelineOwner composes across HOSTS; in-process "
                "shard_time/scan_owners composition is not supported "
                "here (use PipelineChannelizer for those)"
            )
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.n_hosts = n_workers + 1
        self.timeout = float(timeout)
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((bind_addr, port))
        self._lsock.listen(n_workers)
        self.port = self._lsock.getsockname()[1]
        self._conns: List[Optional[_WorkerConn]] = [None] * n_workers
        self._local_only = False

    def accept_workers(self):
        """Block until every worker has connected and identified itself
        (HELLO carries its host id 1..n_workers)."""
        self._lsock.settimeout(self.timeout)
        pending = [i for i, c in enumerate(self._conns) if c is None]
        while pending:
            s, _ = self._lsock.accept()
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            kind, hid, payload = _recv_msg(s)
            if kind != "HELLO" or not 1 <= hid < self.n_hosts:
                s.close()
                raise ConnectionError(
                    f"bad worker hello: {kind} host={hid}"
                )
            if payload != self._config_fingerprint():
                s.close()
                raise ValueError(
                    "worker config fingerprint mismatch — all hosts must "
                    "construct the identical ChannelizerConfig"
                )
            self._conns[hid - 1] = _WorkerConn(s)
            pending = [i for i, c in enumerate(self._conns) if c is None]

    def _config_fingerprint(self) -> str:
        return self.config.to_json()

    def close(self):
        for c in self._conns:
            if c is not None:
                c.close()
        self._lsock.close()

    # -- distributed process -------------------------------------------------

    def process(self, samples: np.ndarray):
        if self._local_only:
            return super().process(samples)
        if any(c is None for c in self._conns):
            self.accept_workers()
        cfg = self.config
        if self._spectra_mode:
            raise RuntimeError(
                "process() called on a stream already driven by "
                "process_spectra()"
            )
        self._samples_mode = True
        if self._carry is None:
            self._carry = jax.device_put(self._jit_init(), self.owner)

        x = np.concatenate(
            [self._pending, np.asarray(samples, np.complex64)]
        )
        bs = self.batch_samples
        n_batches = len(x) // bs
        self._pending = x[n_batches * bs:]

        result = self._new_result()
        dbg = []
        inflight = []  # (batch_idx, host, local_parts_or_None, scans, t0)

        for b in range(n_batches):
            chunk = x[b * bs: (b + 1) * bs]
            host = self._batch_host(b)
            ov_flag = jnp.bool_(self._ov_flag)
            self._ov_flag = False
            if host == 0:
                parts, pa_powers, seg_packed, spec_ext, dev = (
                    self._stage_a_local(chunk, ov_flag)
                )
                scans, extracts = self._pipe_scan_extract(
                    dev, pa_powers, seg_packed, spec_ext
                )
                inflight.append(("local", b, parts, scans, extracts,
                                 self._t0))
            else:
                # the owner still advances the host framing tail so its
                # local batches stay continuous
                glue = np.concatenate([self._tail, chunk])
                self._tail = glue[-(cfg.inplen + cfg.ovllen):]
                conn = self._conns[host - 1]
                pb, packs = conn.get("PACKS", self.timeout)
                if pb != b:
                    raise ConnectionError(
                        f"worker {host} sent packs for batch {pb}, "
                        f"expected {b} (protocol desync)"
                    )
                scans = self._scan_remote_batch(conn, b, packs)
                inflight.append(("remote", b, None, scans, None, self._t0))
            self._t0 += cfg.batch_blocks
            if len(inflight) >= self.window * self.n_hosts:
                self._consume_one(inflight.pop(0), result, dbg)

        while inflight:
            self._consume_one(inflight.pop(0), result, dbg)
        if dbg:
            result.debug_spectrum = np.concatenate(dbg)
        return result

    def _batch_host(self, b: int) -> int:
        return b % self.n_hosts

    def _stage_a_local(self, chunk, ov_flag):
        """The single-process pipeline's stage-A dispatch for one local
        batch (same code path: host-fed framing tail, direct host->worker
        device placement)."""
        cfg = self.config
        dev = self.workers[
            (self._t0 // cfg.batch_blocks) % len(self.workers)
        ]
        x_ext = np.concatenate([self._tail[cfg.ovllen:], chunk])
        histf = jax.device_put(c2f_host(self._tail[: cfg.ovllen]), dev)
        xf = jax.device_put(c2f_host(x_ext), dev)
        glue = np.concatenate([self._tail, chunk])
        self._tail = glue[-(cfg.inplen + cfg.ovllen):]
        ov_row = jax.device_put(self._ov_row, dev)
        (out_static, pa_powers, pa_ext, seg_powers, seg_packed,
         spec_ext, dbgb) = self._jit_front(
            histf, xf, jnp.int32(self._t0), ov_row, ov_flag
        )
        parts = (out_static, pa_ext, seg_powers, dbgb)
        return parts, pa_powers, seg_packed, spec_ext, dev

    def _scan_remote_batch(self, conn, b, packs):
        """Stage B for a worker batch: scan on the owner device from the
        shipped packs, send the post-scan states + plans back."""
        pa_powers = packs.get("pa_powers")
        seg_packed = [
            jnp.asarray(p) for p in packs["seg_packed"]
        ]
        pa_o = (
            jax.device_put(jnp.asarray(pa_powers), self.owner)
            if pa_powers is not None else None
        )
        segk_o = [jax.device_put(p, self.owner) for p in seg_packed]
        self._carry, scans = self._jit_scan(self._carry, pa_o, segk_o)
        states = [
            jax.tree.map(np.asarray, st) for st, _ in scans["segs"]
        ]
        plans = [
            {
                k: np.asarray(so[k])
                for k in ("slot_ids", "slot_ids_narrow")
                if k in so
            }
            for _, so in scans["segs"]
        ]
        conn.send("PLANS", b, {"states": states, "plans": plans})
        return scans

    def _consume_one(self, entry, result, dbg):
        kind, b, parts, scans, extracts, t0_b = entry
        if kind == "local":
            out_static, pa_ext, seg_powers, dbgb = parts
            self._consume_pipeline_batch(
                (out_static, pa_ext, seg_powers, dbgb, scans, extracts,
                 t0_b),
                result, dbg,
            )
            return
        host = self._batch_host(b)
        conn = self._conns[host - 1]
        ob, payload = conn.get("OUT", self.timeout)
        if ob != b:
            raise ConnectionError(
                f"worker {host} sent outputs for batch {ob}, expected {b}"
            )
        self._consume_pipeline_batch(
            (payload["out_static"], payload["pa_ext"],
             payload["seg_powers"], payload["dbg"], scans,
             payload["extracts"], t0_b),
            result, dbg,
        )

    def flush(self, finalize: bool = True):
        """End-of-stream: the remainder + finalize batches run
        OWNER-LOCAL (correctness over parallelism at stream end)."""
        self._local_only = True
        try:
            return super().flush(finalize=finalize)
        finally:
            self._local_only = False

    def process_spectra(self, spectra):
        raise RuntimeError(
            "HostPipelineOwner distributes sample-mode process() only; "
            "for pre-FFT'd vector streams use PipelineChannelizer "
            "(single process) or ShardedChannelizer (SPMD multi-host)"
        )


# ---------------------------------------------------------------------------
# worker
# ---------------------------------------------------------------------------


class HostPipelineWorker(PipelineChannelizer):
    """A worker-host end of the cross-process pipeline: stages A and C of
    its batches on local devices, stage B round-tripped to the owner.
    ``process`` returns an EMPTY result — events and streams come out of
    the owner's merged result."""

    def __init__(self, config: Optional[ChannelizerConfig] = None,
                 host_id: int = 1, n_hosts: int = 2,
                 owner_addr: str = "127.0.0.1", owner_port: int = 0,
                 timeout: float = 240.0, **kwargs):
        super().__init__(config, **kwargs)
        if self.shard_time > 1 or self._owner_groups:
            raise ValueError(
                "HostPipelineWorker does not compose with in-process "
                "shard_time/scan_owners"
            )
        if not 1 <= host_id < n_hosts:
            raise ValueError("worker host_id must be in [1, n_hosts)")
        self.host_id = int(host_id)
        self.n_hosts = int(n_hosts)
        self.timeout = float(timeout)
        self._sock = socket.create_connection(
            (owner_addr, owner_port), timeout=timeout
        )
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _send_msg(self._sock, "HELLO", self.host_id,
                  self.config.to_json())

    def close(self):
        try:
            _send_msg(self._sock, "BYE", -1, None)
        except OSError:
            pass
        self._sock.close()

    def process(self, samples: np.ndarray):
        cfg = self.config
        self._samples_mode = True
        x = np.concatenate(
            [self._pending, np.asarray(samples, np.complex64)]
        )
        bs = self.batch_samples
        n_batches = len(x) // bs
        self._pending = x[n_batches * bs:]

        inflight = []
        for b in range(n_batches):
            chunk = x[b * bs: (b + 1) * bs]
            if self._batch_host(b) != self.host_id:
                glue = np.concatenate([self._tail, chunk])
                self._tail = glue[-(cfg.inplen + cfg.ovllen):]
                self._t0 += cfg.batch_blocks
                continue
            dev = self.workers[
                (b // self.n_hosts) % len(self.workers)
            ]
            x_ext = np.concatenate([self._tail[cfg.ovllen:], chunk])
            histf = jax.device_put(
                c2f_host(self._tail[: cfg.ovllen]), dev
            )
            xf = jax.device_put(c2f_host(x_ext), dev)
            glue = np.concatenate([self._tail, chunk])
            self._tail = glue[-(cfg.inplen + cfg.ovllen):]
            ov_row = jax.device_put(self._ov_row, dev)
            (out_static, pa_powers, pa_ext, seg_powers, seg_packed,
             spec_ext, dbgb) = self._jit_front(
                histf, xf, jnp.int32(self._t0), ov_row, jnp.bool_(False)
            )
            _send_msg(
                self._sock, "PACKS", b,
                {
                    "pa_powers": (
                        np.asarray(pa_powers)
                        if pa_powers is not None else None
                    ),
                    "seg_packed": [np.asarray(p) for p in seg_packed],
                },
            )
            kind, pb, plans_msg = _recv_msg(self._sock)
            if kind != "PLANS" or pb != b:
                raise ConnectionError(
                    f"expected PLANS for batch {b}, got {kind} {pb}"
                )
            states = [
                jax.device_put(
                    jax.tree.map(jnp.asarray, st), dev
                )
                for st in plans_msg["states"]
            ]
            plans = [
                {k: jax.device_put(jnp.asarray(v), dev)
                 for k, v in pl.items()}
                for pl in plans_msg["plans"]
            ]
            extracts = self._jit_slots(spec_ext, states, plans)
            inflight.append(
                (b, out_static, pa_ext, seg_powers, dbgb, extracts)
            )
            self._t0 += cfg.batch_blocks
            # ship window FIXED at 2 (not self.window): the owner's
            # consume frontier lags its scan frontier by
            # owner_window * n_hosts >= 2 * n_hosts batches, and this
            # worker's unshipped batches are spaced n_hosts apart — a
            # ship window of 2 therefore always ships the batch the
            # owner is waiting on BEFORE this worker blocks on its next
            # PLANS. A larger worker-side window (e.g. a worker with
            # more devices than the owner) could hold that batch while
            # the owner holds the worker's next PLANS: deadlock.
            if len(inflight) >= 2:
                self._ship_out(inflight.pop(0))

        while inflight:
            self._ship_out(inflight.pop(0))
        return self._new_result()  # outputs live on the owner

    def _batch_host(self, b: int) -> int:
        return b % self.n_hosts

    def _ship_out(self, entry):
        b, out_static, pa_ext, seg_powers, dbgb, extracts = entry
        to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
        cfg = self.config
        _send_msg(
            self._sock, "OUT", b,
            {
                "out_static": to_np(out_static),
                "pa_ext": to_np(pa_ext) if pa_ext is not None else None,
                "seg_powers": to_np(seg_powers),
                "dbg": to_np(dbgb) if cfg.debug else 0,
                "extracts": to_np(extracts),
            },
        )

    def flush(self, finalize: bool = True):
        """No-op on workers (end-of-stream batches run owner-local)."""
        return self._new_result()

    def process_spectra(self, spectra):
        raise RuntimeError(
            "HostPipelineWorker distributes sample-mode process() only "
            "(running the inherited vector-mode pipeline here would "
            "emit a duplicate event stream)"
        )
