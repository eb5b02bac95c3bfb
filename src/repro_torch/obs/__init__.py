"""Serving telemetry of the port (the port of ``repro/obs``):

  * metrics.py — ``Counter``/``Gauge``/``Histogram`` (log2 latency
    buckets) in a labeled ``MetricsRegistry`` with JSON snapshot and
    Prometheus text exposition; every service reports through one;
  * trace.py   — Chrome-trace/Perfetto span tracer, ring-buffered,
    activated process-wide by ``REPRO_TORCH_TRACE=path``;
  * device.py  — tick occupancy computed on the device from the tick's
    length tensor, returned with the tick's outputs; off by default.
"""

from repro_torch.obs.device import (
    acceptance_stats,
    decode_occupancy,
    env_device_counters,
    occupancy_stats,
    valid_stats,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    latency_summary,
    merge_histogram_rows,
)
from repro_torch.obs.trace import Tracer, get_tracer, trace

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_registry",
    "latency_summary", "merge_histogram_rows",
    "Tracer", "get_tracer", "trace",
    "acceptance_stats", "decode_occupancy", "env_device_counters",
    "occupancy_stats", "valid_stats",
]
