"""fdc_tpu — a JAX frequency-domain channelizer framework.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of gr-FDC
(frequency-domain DAMA channelizers and wideband carrier detection,
reference: gereonsuch/gr-FDC). Instead of a graph of small stateful CPU
blocks, fdc_tpu is built around a handful of large batched pure functions
plus an explicit carry pytree, driven by a thin host streaming loop, and
scales over multi-device meshes by sharding time-blocks and channel
groups (`fdc_tpu.parallel`).

Public API
----------
- :class:`fdc_tpu.ChannelizerConfig` / :class:`fdc_tpu.FrequencyDomainChannelizer`
  — the top-level system, parameter-compatible with the reference hier block
  (reference: python/FrequencyDomainChannelizer.py:46).
- :mod:`fdc_tpu.ops` — windows, overlap-save framing, FFT front-end,
  channel-extraction kernels, detection primitives.
- :mod:`fdc_tpu.models` — the three channelization modes (throughput,
  power-activation, segment detection) as functional models.
- :mod:`fdc_tpu.parallel` — mesh construction and sharded step functions.
- :mod:`fdc_tpu.utils` — event records (PDU-equivalents), file sinks,
  waterfall rendering, structured logging.
"""

from fdc_tpu.config import (
    FreqMode,
    WindowType,
    VerboseMode,
    ChannelizerConfig,
    nextpow2,
    is_pow2,
)

__version__ = "0.1.0"

__all__ = [
    "FreqMode",
    "WindowType",
    "VerboseMode",
    "ChannelizerConfig",
    "FrequencyDomainChannelizer",
    "ShardedChannelizer",
    "PipelineChannelizer",
    "HostPipelineOwner",
    "HostPipelineWorker",
    "ActivityDetectionChannelizer",
    "StreamDriver",
    "Waterfall",
    "LiveWaterfall",
    "ChannelEvent",
    "make_mesh",
    "nextpow2",
    "is_pow2",
    "split_segment_geometry",
]

# Lazy imports keep `import fdc_tpu` light and avoid import cycles.
_LAZY = {
    "FrequencyDomainChannelizer": ("fdc_tpu.models.channelizer",
                                   "FrequencyDomainChannelizer"),
    "ShardedChannelizer": ("fdc_tpu.parallel.sharded", "ShardedChannelizer"),
    "PipelineChannelizer": ("fdc_tpu.parallel.pipeline",
                            "PipelineChannelizer"),
    "HostPipelineOwner": ("fdc_tpu.parallel.hostpipe", "HostPipelineOwner"),
    "HostPipelineWorker": ("fdc_tpu.parallel.hostpipe",
                           "HostPipelineWorker"),
    "split_segment_geometry": ("fdc_tpu.config", "split_segment_geometry"),
    "ActivityDetectionChannelizer": ("fdc_tpu.models.activity_detection",
                                     "ActivityDetectionChannelizer"),
    "StreamDriver": ("fdc_tpu.runtime.stream", "StreamDriver"),
    "Waterfall": ("fdc_tpu.utils.waterfall", "Waterfall"),
    "LiveWaterfall": ("fdc_tpu.utils.waterfall", "LiveWaterfall"),
    "ChannelEvent": ("fdc_tpu.utils.events", "ChannelEvent"),
    "make_mesh": ("fdc_tpu.parallel.mesh", "make_mesh"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'fdc_tpu' has no attribute {name!r}")
