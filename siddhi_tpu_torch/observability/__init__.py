"""Cycle-correlated tracing and telemetry for the device batch pipeline.

The runtime overlaps one batch's life across four threads — H2D ingest
staging, the device step, the count-gated emit drain, and the async
checkpoint writer — and this package is the layer that makes that
overlap visible without touching the device hot path:

- ``trace``: a monotonic cycle id per device-engine batch, threaded
  through IngestStage/EmitQueue; each stage appends a fixed-size span
  record to a lock-light per-runtime ring (pure host bookkeeping,
  outside the device steps).
- ``recorder``: the black-box flight recorder over that ring — the last
  N complete cycle traces, dumped as JSON on poison quarantine, @OnError
  isolation, crash restore and fault-injector kills, exportable as
  Chrome ``chrome://tracing`` JSON.
- ``histograms``: fixed-bucket latency histograms (p50/p95/p99) shared
  by the per-stage span feed and ``util/statistics.py``'s per-query
  LatencyTracker.
- ``prometheus``: text-exposition rendering of every StatisticsManager
  counter/gauge/histogram for ``GET /metrics``.
"""

from .histograms import LatencyHistogram
from .prometheus import render_prometheus
from .recorder import FlightRecorder
from .trace import CycleToken, Tracer

__all__ = [
    "CycleToken",
    "FlightRecorder",
    "LatencyHistogram",
    "Tracer",
    "render_prometheus",
]
