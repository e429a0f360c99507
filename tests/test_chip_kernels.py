"""The kernels as compiled for the GPU == their plain references.

The CPU lane runs the same kernels in interpret mode
(tests/test_lifecycle_pallas.py, tests/test_detection_ops.py); only the
card shows what its compiler makes of them. Run there with
``python -m pytest tests/ -m chip --chip -o addopts=``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fdc_tpu.models.power_activation import PowerActivationBank
from fdc_tpu.models.segment_detection import SegmentDetector, scan_slots_multi
from fdc_tpu.ops import detect

pytestmark = pytest.mark.chip


def _detector(backend, band, max_slots):
    return SegmentDetector(
        0, 4096, 4, band[0], band[1], 6.0, 0.005, 0.2,
        channel_deactivation_delay=2, max_slots=max_slots,
        max_extract_width=256, lifecycle_backend=backend,
    )


def _churn(nc, nb, rng, n=60):
    p = np.full((nb, nc), 1e-6)
    for _ in range(n):
        c0 = int(rng.integers(0, nc - 4))
        on = int(rng.integers(0, nb - 8))
        p[on:on + int(rng.integers(1, 60)),
          c0:c0 + int(rng.integers(1, 4))] += 1.0 + rng.random()
    return jnp.asarray(p, jnp.float32)


def _assert_trees_equal(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("max_slots", [16, 512])
def test_lifecycle_kernel_matches_scan_on_card(card, max_slots):
    """Two segments as two programs of one launch, 512 churned blocks,
    three batches of carried state."""
    rng = np.random.default_rng(max_slots)
    bands = ((0.05, 0.3), (0.35, 0.45))
    sd_k = [_detector("pallas", b, max_slots) for b in bands]
    sd_r = [_detector("scan", b, max_slots) for b in bands]
    run_k = jax.jit(lambda p, s: scan_slots_multi(sd_k, p, s))
    run_r = jax.jit(lambda p, s: scan_slots_multi(sd_r, p, s))
    st_k = st_r = [sd.init_state() for sd in sd_r]
    for _ in range(3):
        powers = [_churn(sd.geometry.n_cells, 512, rng) for sd in sd_r]
        out_k, out_r = run_k(powers, st_k), run_r(powers, st_r)
        _assert_trees_equal(out_k, out_r)
        st_k = [o[0] for o in out_k]
        st_r = [o[0] for o in out_r]


def test_burst_kernel_matches_scan_on_card(card):
    rng = np.random.default_rng(3)
    chans = [(0.1 * i + 0.05, 0.02) for i in range(9)]
    pa_k = PowerActivationBank(4096, 4, chans, 10.0, "pallas")
    pa_r = PowerActivationBank(4096, 4, chans, 10.0, "scan")
    st_k = st_r = pa_r.init_state()
    for _ in range(3):
        p = np.exp(rng.normal(0, 2.0, (512, pa_r.num_channels)))
        p[64:256] = p[63]  # quiet chunks take the closed form
        powers = jnp.asarray(p, jnp.float32)
        out_k = jax.jit(pa_k.scan_flags)(powers, st_k)
        out_r = jax.jit(pa_r.scan_flags)(powers, st_r)
        _assert_trees_equal(out_k, out_r)
        st_k, st_r = out_k[0], out_r[0]


def test_greedy_kernel_matches_jnp_on_card(card):
    rng = np.random.default_rng(5)
    power = _churn(34, 512, rng, n=200)
    cs, ce, hp = jax.jit(jax.vmap(
        lambda p: detect.detect_edges(p, 10 ** 0.6, 33)
    ))(power)
    got = jax.jit(detect._greedy_accept_pallas)(cs, ce, hp)
    ref = jax.jit(detect._greedy_accept_jnp)(cs, ce, hp)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    assert np.asarray(ref).any()
