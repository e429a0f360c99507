"""Two-process driver for the CROSS-PROCESS pipeline
(fdc_tpu.parallel.hostpipe): an owner host running the scan chain +
merged emission and a worker host running stages A/C for its batches,
talking over the real TCP message protocol. Launched by
tests/test_multihost_twoprocess.py (pipeline scenario) and usable
manually:

    JAX_PLATFORMS=cpu python tools/hostpipe_worker.py owner  <port> [n_hosts]
    JAX_PLATFORMS=cpu python tools/hostpipe_worker.py worker <port> [n_hosts] [host_id]

On one GPU machine each process must see only its own card:
``CUDA_VISIBLE_DEVICES=<i>`` per process.

The owner checks event parity against a single-process
FrequencyDomainChannelizer run of the same capture and prints
"OWNER HOSTPIPE==SINGLE OK".
"""
import os
import sys
import time

role, port = sys.argv[1], int(sys.argv[2])
n_hosts = int(sys.argv[3]) if len(sys.argv) > 3 else 2
host_id = int(sys.argv[4]) if len(sys.argv) > 4 else 1
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from fdc_tpu.config import ChannelizerConfig
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer
from fdc_tpu.parallel.hostpipe import HostPipelineOwner, HostPipelineWorker

cfg = ChannelizerConfig(
    blocksize=256, relinvovl=4,
    throughput_channels=[(-0.2, 0.05)],
    activity_controlled_channels=[(0.45, 0.05)],
    act_contr_threshold=10.0,
    activity_detection_segments=[(0.1, 0.28), (0.3, 0.42)],
    act_det_threshold=8.0, minchandist=0.02,
    freqmode="basebandfs", batch_blocks=8,
)

# deterministic capture: tone + three staggered bursts (both segments and
# the powact channel fire), 6 batches so each host owns 3
n_batches = 6
inplen = cfg.inplen
n = n_batches * cfg.batch_blocks * inplen
t = np.arange(n)
rng = np.random.default_rng(8)
x = (np.exp(2j * np.pi * -0.2 * t)
     + 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
for f, a, on, off in [(0.25, 2.0, 6, 16), (0.36, 2.5, 19, 29),
                      (0.45, 2.0, 34, 43)]:
    m = np.zeros(n)
    m[on * inplen: off * inplen] = 1.0
    x += a * m * np.exp(2j * np.pi * f * t)
x = x.astype(np.complex64)


def sig(events):
    return [(e.ID.split(".", 1)[1], e.blockstart, e.blockend,
             round(float(np.abs(e.data).sum()), 3)) for e in events]


if role == "owner":
    owner = HostPipelineOwner(cfg, n_workers=n_hosts - 1, port=port)
    owner.accept_workers()
    events = []
    half = len(x) // 2
    for chunk in (x[:half], x[half:]):  # two calls: streaming chunking
        events.extend(owner.process(chunk).events)
    events.extend(owner.flush(finalize=True).events)
    owner.close()
    print(f"OWNER EVENTS {sig(events)}", flush=True)

    ref = FrequencyDomainChannelizer(cfg)
    rev = []
    for chunk in (x[:half], x[half:]):
        rev.extend(ref.process(chunk).events)
    rev.extend(ref.flush(finalize=True).events)
    s, r = sig(events), sig(rev)
    assert any("PowActChan" in e[0] for e in r), r
    assert any(".0." in e[0] for e in r if "DETECTED" in e[0]), r
    assert any(".1." in e[0] for e in r if "DETECTED" in e[0]), r
    assert len(s) == len(r), (s, r)
    for a, b in zip(s, r):
        assert a[0] == b[0] and a[1] == b[1] and a[2] == b[2], (a, b)
        assert abs(a[3] - b[3]) < 2e-2 * max(1.0, b[3]), (a, b)
    print("OWNER HOSTPIPE==SINGLE OK", flush=True)
else:
    # the owner may not have bound yet — retry the connect briefly
    worker = None
    deadline = time.time() + 60
    while worker is None:
        try:
            worker = HostPipelineWorker(
                cfg, host_id=host_id, n_hosts=n_hosts, owner_port=port
            )
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.2)
    half = len(x) // 2
    for chunk in (x[:half], x[half:]):
        worker.process(chunk)
    worker.flush(finalize=True)
    worker.close()
    print("WORKER DONE", flush=True)
