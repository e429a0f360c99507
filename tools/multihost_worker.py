"""Multi-process jax.distributed CPU worker: runs the sharded channelizer
step across REAL separate processes (gloo collectives) and checks event
parity against a single-process run — the closest validation of the
multi-host pod path (fdc_tpu.parallel.multihost) available without pod
hardware. Launched by tests/test_multihost_twoprocess.py and usable
manually:

    JAX_PLATFORMS=cpu \
        python tools/multihost_worker.py <process_id> <num_processes> <port>
"""
import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
scenario = sys.argv[4] if len(sys.argv) > 4 else "basic"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_cpu_collectives_implementation", "gloo")
# distributed init MUST precede anything that can initialize the backend
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}",
    num_processes=nproc, process_id=pid,
)

import numpy as np

from fdc_tpu.config import ChannelizerConfig
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer
from fdc_tpu.parallel.multihost import global_mesh, host_local_batch
from fdc_tpu.parallel.sharded import ShardedChannelizer
from fdc_tpu.utils.cplx import c2f_host
from jax.experimental import multihost_utils

assert jax.process_index() == pid
assert jax.process_count() == nproc
mesh = global_mesh(n_chan=2)  # 2 procs x 4 local devices = (4, 2) mesh

if scenario == "rich":
    # exercise the chan axis with real content across
    # processes — multi-channel width buckets (static per-rank switch
    # tables), a tp+burst FUSED width family, and TWO detection segments
    # (per-segment scan ownership assigns one to each chan rank, so the
    # owner cond + psum broadcast cross the process boundary).
    cfg = ChannelizerConfig(
        blocksize=256, relinvovl=4,
        throughput_channels=[(-0.2, 0.05), (-0.35, 0.05), (0.05, 0.02)],
        activity_controlled_channels=[(0.45, 0.05)],
        act_contr_threshold=10.0,
        activity_detection_segments=[(0.1, 0.28), (0.3, 0.42)],
        act_det_threshold=8.0, minchandist=0.02,
        freqmode="basebandfs", batch_blocks=8,
    )
else:
    cfg = ChannelizerConfig(
        blocksize=256, relinvovl=4,
        throughput_channels=[(-0.2, 0.05)],
        activity_detection_segments=[(0.1, 0.4)],
        act_det_threshold=8.0, minchandist=0.02,
        freqmode="basebandfs", batch_blocks=8,
    )
sh = ShardedChannelizer(cfg, mesh=mesh)

# deterministic capture: tone + burst
n_batches = 3
n = n_batches * sh.batch_samples
t = np.arange(n)
rng = np.random.default_rng(8)
x = (np.exp(2j * np.pi * -0.2 * t)
     + 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
     ).astype(np.complex64)
m = np.zeros(n)
m[6 * cfg.inplen: 16 * cfg.inplen] = 1.0
x += (2.0 * m * np.exp(2j * np.pi * 0.25 * t)).astype(np.complex64)
if scenario == "rich":
    # a second-segment burst and a power-activation burst, staggered
    m2 = np.zeros(n)
    m2[9 * cfg.inplen: 19 * cfg.inplen] = 1.0
    x += (2.5 * m2 * np.exp(2j * np.pi * 0.36 * t)).astype(np.complex64)
    m3 = np.zeros(n)
    m3[4 * cfg.inplen: 13 * cfg.inplen] = 1.0
    x += (2.0 * m3 * np.exp(2j * np.pi * 0.45 * t)).astype(np.complex64)

# each process feeds its contiguous HALF of each batch's time run
carry = sh._jit_init()
events = []
t0 = 0
import jax.numpy as jnp
for i in range(n_batches):
    chunk = x[i * sh.batch_samples: (i + 1) * sh.batch_samples]
    xf = c2f_host(chunk)
    half = len(xf) // nproc
    arr = host_local_batch(mesh, xf[pid * half: (pid + 1) * half])
    carry, out = sh._jit_step(carry, arr, jnp.int32(t0))
    # outputs are replicated/addressable per spec; pull fully-replicated
    # leaves and the extraction (chan-sharded -> fully addressable? use
    # process-local view via jax.device_get on fully replicated output)
    out = jax.tree.map(
        lambda a: (np.asarray(a) if a.is_fully_replicated
                   else np.asarray(
                       multihost_utils.process_allgather(a, tiled=True))),
        out,
        is_leaf=lambda a: hasattr(a, "sharding"),
    )
    from fdc_tpu.utils.cplx import f2c_host
    if sh.power_bank is not None:
        po = dict(out["powact"])
        po["extract"] = {w: f2c_host(v) for w, v in po["extract"].items()}
        events.extend(sh.power_emitter.process_step(po, t0))
    for si in range(len(sh.segments)):
        so = dict(out[f"seg{si}"])
        so["extract"] = f2c_host(so["extract"])
        if "extract_narrow" in so:
            so["extract_narrow"] = f2c_host(so["extract_narrow"])
        events.extend(
            sh.segment_emitters[si].process_step(so, so["slot_meta"], t0)
        )
    t0 += cfg.batch_blocks

sig = [(e.ID.split(".", 1)[1], e.blockstart, e.blockend,
        round(float(np.abs(e.data).sum()), 3)) for e in events]
print(f"PROC{pid} EVENTS {sig}", flush=True)

# single-process reference (plain channelizer) on process 0
if pid == 0:
    ref = FrequencyDomainChannelizer(cfg)
    rev = []
    for i in range(n_batches):
        rev.extend(ref.process(
            x[i * sh.batch_samples: (i + 1) * sh.batch_samples]).events)
    rsig = [(e.ID.split(".", 1)[1], e.blockstart, e.blockend,
             round(float(np.abs(e.data).sum()), 3)) for e in rev]
    if scenario == "rich":
        # the scenario must actually exercise all three event sources
        assert any("PowActChan" in s[0] for s in rsig), rsig
        assert any(".0." in s[0] for s in rsig if "DETECTED" in s[0]), rsig
        assert any(".1." in s[0] for s in rsig if "DETECTED" in s[0]), rsig
    assert len(sig) == len(rsig), (sig, rsig)
    for a, b in zip(sig, rsig):
        assert a[0] == b[0] and a[1] == b[1] and a[2] == b[2], (a, b)
        assert abs(a[3] - b[3]) < 2e-2 * max(1.0, b[3]), (a, b)
    print("PROC0 MULTIHOST==SINGLE OK", flush=True)
