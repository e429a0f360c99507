"""Checkpoint / resume of a streaming channelizer.

The reference has no checkpointing — all state lives in C++ members (hist
buffers, deques, counters; SURVEY.md §5) and a killed flowgraph loses every
open burst. Here the complete streaming state is explicit:

- the device carry pytree (overlap-save history, previous spectrum, burst
  flags, detection slot tables),
- the host emission state (open burst buffers, part counters, message IDs),
- the stream cursor (global block index, buffered residual samples).

``save_checkpoint`` snapshots all three to one file; ``load_checkpoint``
restores them into a channelizer built from the same config. Works for both
single-device and sharded channelizers (the carry is replicated).

Complex leaves are stored as float32 [..., 2] pairs, the same layout the
device step's outputs use (see fdc_tpu/utils/cplx.py).
"""

from __future__ import annotations

import pickle
from typing import TYPE_CHECKING

import jax
import jax.numpy as jnp
import numpy as np

from fdc_tpu.utils.cplx import c2f, f2c

if TYPE_CHECKING:
    from fdc_tpu.models.channelizer import FrequencyDomainChannelizer

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "save_vcm_checkpoint",
    "load_vcm_checkpoint",
]

_FORMAT_VERSION = 1


@jax.jit
def _pack_carry(carry):
    """Complex leaves -> float32 [..., 2]; others pass through."""
    return jax.tree.map(
        lambda x: c2f(x) if jnp.iscomplexobj(x) else x, carry
    )


_pack_leaf = jax.jit(c2f)


def _carry_to_host(carry):
    # pack PER LEAF, not as one jitted tree computation: the pipeline's
    # multi-owner mode leaves segment states resident on different owner
    # devices, and a single jit over the mixed-device carry would raise
    # (jit requires colocated inputs). Per-leaf jit runs each complex
    # pack on its leaf's own device; non-complex leaves fetch directly.
    iscomplex = jax.tree.map(lambda x: bool(jnp.iscomplexobj(x)), carry)
    packed = jax.tree.map(
        lambda x, c: np.asarray(_pack_leaf(x)) if c else np.asarray(x),
        carry, iscomplex,
    )
    return packed, iscomplex


def _carry_from_host(packed, iscomplex):
    """Upload float-packed carry; complex leaves re-complexified inside jit."""

    @jax.jit
    def up(tree):
        return jax.tree.map(
            lambda x, c: f2c(x) if c else x, tree, iscomplex
        )

    return up(jax.tree.map(jnp.asarray, packed))


def save_checkpoint(fdc: "FrequencyDomainChannelizer", path: str):
    """Snapshot the full streaming state to ``path``."""
    if fdc._carry is None:
        fdc._carry = fdc._jit_init()
    packed, iscomplex = _carry_to_host(fdc._carry)
    state = {
        "version": _FORMAT_VERSION,
        "carry": packed,
        "carry_iscomplex": iscomplex,
        "t0": fdc._t0,
        "pending": fdc._pending.copy(),
        "pending_spec": fdc._pending_spec.copy(),
        "spectra_mode": fdc._spectra_mode,
        "samples_mode": fdc._samples_mode,
        "power_emitter": (
            fdc.power_emitter.get_state() if fdc.power_emitter else None
        ),
        "segment_emitters": [e.get_state() for e in fdc.segment_emitters],
        # subclass-owned host state (e.g. the pipeline driver's framing
        # tail); _host_extra_state may also sync derived carry leaves, so
        # it runs BEFORE the carry snapshot below is taken... which is
        # why the carry is re-packed here if the hook touched it
        "host_extra": fdc._host_extra_state(),
    }
    if state["host_extra"]:
        packed, iscomplex = _carry_to_host(fdc._carry)
        state["carry"], state["carry_iscomplex"] = packed, iscomplex
    with open(path, "wb") as fh:
        pickle.dump(state, fh, protocol=pickle.HIGHEST_PROTOCOL)


def load_checkpoint(fdc: "FrequencyDomainChannelizer", path: str):
    """Restore a snapshot produced by ``save_checkpoint`` into ``fdc``.

    The channelizer must be configured identically to the one that saved
    the checkpoint (carry structure is validated).
    """
    with open(path, "rb") as fh:
        state = pickle.load(fh)
    if state.get("version") != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {state.get('version')}")

    ref = jax.eval_shape(_pack_carry, jax.eval_shape(fdc._device_init))
    if jax.tree_util.tree_structure(ref) != jax.tree_util.tree_structure(
        state["carry"]
    ) or jax.tree.map(lambda x: x.shape, ref) != jax.tree.map(
        lambda x: x.shape, state["carry"]
    ):
        raise ValueError(
            "checkpoint carry structure does not match this configuration"
        )

    fdc._carry = _carry_from_host(state["carry"], state["carry_iscomplex"])
    fdc._t0 = int(state["t0"])
    fdc._pending = np.asarray(state["pending"], np.complex64)
    # round-2 checkpoints predate the vector-mode buffer (absent => empty)
    ps = state.get("pending_spec")
    fdc._pending_spec = (
        np.asarray(ps, np.complex64)
        if ps is not None
        else np.zeros((0, fdc.config.blocksize), np.complex64)
    )
    fdc._spectra_mode = bool(state.get("spectra_mode", False))
    # older checkpoints predate the mode-exclusivity guard: infer samples
    # mode from "has processed or buffered samples and is not in vector
    # mode" so a restored stream keeps rejecting mixed entry points
    fdc._samples_mode = bool(
        state.get(
            "samples_mode",
            not fdc._spectra_mode
            and (fdc._t0 > 0 or len(fdc._pending) > 0),
        )
    )
    if state["power_emitter"] is not None:
        if fdc.power_emitter is None:
            raise ValueError("checkpoint has burst state but config has none")
        fdc.power_emitter.set_state(state["power_emitter"])
    if len(state["segment_emitters"]) != len(fdc.segment_emitters):
        raise ValueError("segment count mismatch")
    for e, st in zip(fdc.segment_emitters, state["segment_emitters"]):
        e.set_state(st)
    # subclass host state (pipeline framing tail / reach-back override);
    # absent in older checkpoints and for plain/sharded models
    fdc._restore_host_extra_state(state.get("host_extra") or {})


def save_vcm_checkpoint(runner, path: str, extra: dict = None):
    """Snapshot an ActivityDetectionRunner's streaming state (device
    carry, block cursor, open-burst emitter state) plus caller-owned
    ``extra`` leaves (e.g. the CLI front-end's overlap history and
    unprocessed sample tail). Same packing rules as save_checkpoint."""
    if runner._carry is None:
        runner._carry = runner._jit_init()
    packed, iscomplex = _carry_to_host(runner._carry)
    state = {
        "version": _FORMAT_VERSION,
        "kind": "vcm_runner",
        "carry": packed,
        "carry_iscomplex": iscomplex,
        "t0": runner._t0,
        "emitters": [e.get_state() for e in runner.emitters],
        "extra": extra or {},
    }
    with open(path, "wb") as fh:
        pickle.dump(state, fh, protocol=pickle.HIGHEST_PROTOCOL)


def load_vcm_checkpoint(runner, path: str) -> dict:
    """Restore a save_vcm_checkpoint snapshot; returns its ``extra``."""
    with open(path, "rb") as fh:
        state = pickle.load(fh)
    if (state.get("version") != _FORMAT_VERSION
            or state.get("kind") != "vcm_runner"):
        raise ValueError(
            f"not a vcm runner checkpoint "
            f"(version={state.get('version')}, kind={state.get('kind')})"
        )
    ref = jax.eval_shape(_pack_carry, jax.eval_shape(runner._device_init))
    if jax.tree_util.tree_structure(ref) != jax.tree_util.tree_structure(
        state["carry"]
    ) or jax.tree.map(lambda x: x.shape, ref) != jax.tree.map(
        lambda x: x.shape, state["carry"]
    ):
        raise ValueError(
            "checkpoint carry structure does not match this configuration"
        )
    runner._carry = _carry_from_host(
        state["carry"], state["carry_iscomplex"]
    )
    runner._t0 = int(state["t0"])
    if len(state["emitters"]) != len(runner.emitters):
        raise ValueError("segment count mismatch")
    for e, st in zip(runner.emitters, state["emitters"]):
        e.set_state(st)
    return state["extra"]
