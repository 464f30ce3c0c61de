"""Cycle-correlated span tracing for the device batch pipeline.

One :class:`Tracer` per app runtime hands out a monotonically
increasing cycle id per device-engine batch (``begin_cycle``).  The id
rides a :class:`CycleToken` through the existing async machinery:

    runtime ``process_stream_batch``          -> begin_cycle (t0)
    IngestStage.submit (put + step dispatched) -> tok.dispatched()  [ingest span]
    runtime ``_finish`` (count gate resolved)  -> tok.step_done(n)  [step span]
    EmitQueue.drain (batch materialized)       -> tok.emitted(t0)   [emit span]

plus free-running ``persist.capture`` / ``persist.write`` spans from
the checkpoint path (``record_span``), which draw ids from the same
counter so a capture and its async write stay ordered against the
batch cycles around them.

Everything here is host-side bookkeeping outside the device steps: a
span is a six-tuple appended to the flight recorder's deque
(GIL-atomic) plus a histogram bucket increment — no device tensor is
touched, fetched or waited on, so tracing adds no synchronisation to
the path: the step span ends where the runtime's count gate resolves.

Sampling (``@app:trace(sample='1/64')``) gates token creation: an
unsampled cycle pays one ``itertools.count`` tick and a modulo, and
every downstream hook short-circuits on ``token is None`` — that is
the whole default-on cost.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, Optional

from .histograms import LatencyHistogram
from .recorder import FlightRecorder

#: batch-cycle stages in pipeline order
STAGE_INGEST = "ingest"
STAGE_STEP = "step"
STAGE_EMIT = "emit"
#: checkpoint-path stages (free-running, engine kind 'persist')
STAGE_PERSIST_CAPTURE = "persist.capture"
STAGE_PERSIST_WRITE = "persist.write"
#: device-table stages (devtable/): join-probe dispatch and the
#: mutation scatter step
STAGE_TABLE_PROBE = "table.probe"
STAGE_TABLE_UPSERT = "table.upsert"
#: watchdog self-heal (robustness/watchdog.py): one span per trip,
#: covering the replan-driven restore-and-replay — recovery time is a
#: latency distribution like any other stage
STAGE_WATCHDOG_HEAL = "watchdog.heal"

_STAGES = (STAGE_INGEST, STAGE_STEP, STAGE_EMIT,
           STAGE_PERSIST_CAPTURE, STAGE_PERSIST_WRITE,
           STAGE_TABLE_PROBE, STAGE_TABLE_UPSERT,
           STAGE_WATCHDOG_HEAL)


class CycleToken:
    """One sampled batch cycle's identity + in-flight timestamps.

    Created by ``Tracer.begin_cycle`` and threaded through
    ``IngestStage.submit`` and ``PendingEmit`` — each hook records its
    span and stamps the start of the next."""

    __slots__ = ("tracer", "cycle", "engine", "n_events", "n_emit",
                 "t0", "t_dispatch")

    def __init__(self, tracer: "Tracer", cycle: int, engine: str,
                 n_events: int, t0: float):
        self.tracer = tracer
        self.cycle = cycle
        self.engine = engine
        self.n_events = n_events
        self.n_emit = 0
        self.t0 = t0
        self.t_dispatch = t0

    def dispatched(self) -> None:
        """Receive-time work done: conversion + H2D put + device step
        dispatch are all queued.  Ends the ingest span."""
        now = self.tracer.clock()
        self.tracer.record(self.cycle, STAGE_INGEST, self.engine,
                           self.t0, now, self.n_events)
        self.t_dispatch = now

    def step_done(self, n_emit: int) -> None:
        """Count gate resolved: the device step (and the H2D transfer
        it waited on) finished on device.  Ends the step span."""
        now = self.tracer.clock()
        self.n_emit = n_emit
        self.tracer.record(self.cycle, STAGE_STEP, self.engine,
                           self.t_dispatch, now, self.n_events)

    def emitted(self, t_fetch_start: float) -> None:
        """This cycle's batch materialized on the host (post coalesced
        fetch + callback).  Ends the emit span."""
        self.tracer.record(self.cycle, STAGE_EMIT, self.engine,
                           t_fetch_start, self.tracer.clock(), self.n_emit)

    def aborted(self, stage: str) -> None:
        """The cycle died inside ``stage`` (isolated fault): leave a
        zero-width tombstone span so the flight recorder shows where
        the batch was lost instead of a silent gap."""
        now = self.tracer.clock()
        self.tracer.record(self.cycle, f"{stage}.aborted", self.engine,
                           now, now, self.n_events)


class Tracer:
    """Per-app cycle-id source, span sink and flight-recorder owner."""

    #: default: record every 64th cycle (≤5%-throughput contract)
    DEFAULT_SAMPLE = 64
    #: default flight-recorder depth in cycles
    DEFAULT_CYCLES = 64

    def __init__(self, app_name: str, sample: int = DEFAULT_SAMPLE,
                 cycles: int = DEFAULT_CYCLES,
                 dump_dir: Optional[str] = None):
        self.app_name = app_name
        # 0 = tracing off; 1 = every cycle; N = every Nth cycle
        self.sample = max(0, int(sample))
        self.recorder = FlightRecorder(app_name, cycles=cycles,
                                       dump_dir=dump_dir)
        self.clock = time.perf_counter
        self._ids = itertools.count(1)
        # pre-created so hot-path record() never mutates the dict
        self.stage_hist: Dict[str, LatencyHistogram] = {
            stage: LatencyHistogram() for stage in _STAGES}

    # -- cycle ids -----------------------------------------------------------

    def next_id(self) -> int:
        return next(self._ids)

    def begin_cycle(self, engine: str, n_events: int) -> Optional[CycleToken]:
        """Start one batch cycle; None when this cycle is unsampled
        (every downstream hook no-ops on a None token)."""
        if not self.sample:
            return None
        cid = next(self._ids)
        if self.sample > 1 and cid % self.sample:
            return None
        return CycleToken(self, cid, engine, n_events, self.clock())

    # -- span sink -----------------------------------------------------------

    def record(self, cycle: int, stage: str, engine: str,
               t_start: float, t_end: float, n_events: int) -> None:
        self.recorder.record((cycle, stage, engine, t_start, t_end,
                              n_events))
        hist = self.stage_hist.get(stage)
        if hist is not None:
            hist.record_s(t_end - t_start)

    def record_span(self, stage: str, engine: str, t_start: float,
                    t_end: float, n_events: int = 0,
                    cycle: Optional[int] = None) -> int:
        """Free-running span (persist path): allocates its own cycle id
        from the shared counter unless the caller correlates one."""
        cid = cycle if cycle is not None else next(self._ids)
        self.record(cid, stage, engine, t_start, t_end, n_events)
        return cid

    # -- read-out ------------------------------------------------------------

    def stage_stats(self) -> Dict[str, Dict[str, float]]:
        """stage -> quantile read-out, only for stages that recorded
        (an app with no device engines reports nothing)."""
        out: Dict[str, Dict[str, float]] = {}
        for stage, hist in self.stage_hist.items():
            if hist.count == 0:
                continue
            out[stage] = {
                "spans": hist.count,
                "p50Ms": hist.p50_ms(),
                "p95Ms": hist.p95_ms(),
                "p99Ms": hist.p99_ms(),
                "maxMs": hist.max_ms,
            }
        return out

    def histograms(self):
        """(stage, LatencyHistogram) pairs with data — the Prometheus
        exposition's histogram families."""
        return [(stage, hist) for stage, hist in self.stage_hist.items()
                if hist.count]

    def dump(self, reason: str) -> dict:
        return self.recorder.dump(reason)

    def reset(self) -> None:
        for hist in self.stage_hist.values():
            hist.reset()
