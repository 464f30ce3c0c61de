"""Statistics: throughput / latency / buffer metrics.

Re-design of the reference ``util/statistics/`` (SiddhiStatisticsManager
behind Dropwizard MetricRegistry, ThroughputTracker per junction,
LatencyTracker marked in/out around each query chain, Level
OFF/BASIC/DETAIL from @app:statistics, runtime-switchable): plain host
counters — the event path is micro-batched, so tracker overhead is one
increment per batch, not per event.

Metric naming follows the reference convention
``io.siddhi.SiddhiApps.<app>.Siddhi.<kind>.<name>.<metric>``
(SiddhiAppRuntimeImpl.registerForBufferedEvents:802-821).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from siddhi_tpu_torch.observability.histograms import LatencyHistogram


class Level:
    OFF = "off"
    BASIC = "basic"
    DETAIL = "detail"

    _ORDER = {OFF: 0, BASIC: 1, DETAIL: 2}

    @classmethod
    def at_least(cls, level: str, needed: str) -> bool:
        return cls._ORDER.get(level, 0) >= cls._ORDER[needed]


class ThroughputTracker:
    """Events-seen counter with a windowed rate
    (reference: util/statistics/ThroughputTracker).

    ``events_per_second`` reports a recent-window rate: finished
    windows fold into an EMA, so the figure tracks what the stream is
    doing NOW.  The historical count-over-total-elapsed figure — which
    decays toward zero on any long-lived app whose traffic is not
    perfectly uniform — stays available as
    ``lifetime_events_per_second``.  ``clock`` is injectable for
    tests."""

    #: window width folded into the rate EMA
    WINDOW_S = 5.0
    #: EMA weight of the newest finished window
    ALPHA = 0.3

    def __init__(self, name: str, clock=time.monotonic):
        self.name = name
        self.count = 0
        self._clock = clock
        self._start = clock()
        self._win_start = self._start
        self._win_count = 0
        self._rate_ema: Optional[float] = None

    def _fold(self, now: float):
        """Close the current window into the EMA when it is old enough.
        A long idle stretch folds as several windows' worth at once —
        the EMA weight compounds with the elapsed window count, so the
        reported rate decays toward zero the way a live dashboard
        should instead of lingering on stale traffic."""
        dt = now - self._win_start
        if dt < self.WINDOW_S:
            return
        rate = self._win_count / dt
        alpha = 1.0 - (1.0 - self.ALPHA) ** (dt / self.WINDOW_S)
        self._rate_ema = (rate if self._rate_ema is None
                          else self._rate_ema + alpha
                          * (rate - self._rate_ema))
        self._win_start = now
        self._win_count = 0

    def add(self, n: int):
        self.count += n
        self._win_count += n
        self._fold(self._clock())

    def events_per_second(self) -> float:
        """Windowed rate; before the first window closes it equals the
        lifetime rate (identical to the historical read-out for young
        trackers)."""
        now = self._clock()
        self._fold(now)
        if self._rate_ema is None:
            dt = now - self._start
            return self.count / dt if dt > 0 else 0.0
        return self._rate_ema

    def lifetime_events_per_second(self) -> float:
        """Historical semantics: total count over total elapsed time."""
        dt = self._clock() - self._start
        return self.count / dt if dt > 0 else 0.0

    def reset(self):
        self.count = 0
        self._start = self._clock()
        self._win_start = self._start
        self._win_count = 0
        self._rate_ema = None


class LatencyTracker:
    """Per-query in-pipeline latency, marked around the chain
    (reference: util/statistics/LatencyTracker +
    ProcessStreamReceiver.java:79-87)."""

    def __init__(self, name: str):
        self.name = name
        self.batches = 0
        self.events = 0
        self.total_s = 0.0
        self.max_s = 0.0
        # fixed-bucket distribution behind the p50/p95/p99 read-outs
        # (observability/histograms.py; also scraped by /metrics)
        self.hist = LatencyHistogram()
        self._t0 = None

    def mark_in(self, n_events: int):
        self._t0 = time.perf_counter()
        self.events += n_events

    def mark_out(self, n_events: int):
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.batches += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)
        self.hist.record_s(dt)

    def avg_ms(self) -> float:
        return (self.total_s / self.batches) * 1000.0 if self.batches else 0.0

    def max_ms(self) -> float:
        return self.max_s * 1000.0

    def p50_ms(self) -> float:
        return self.hist.p50_ms()

    def p95_ms(self) -> float:
        return self.hist.p95_ms()

    def p99_ms(self) -> float:
        return self.hist.p99_ms()

    def reset(self):
        self.batches = 0
        self.events = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.hist.reset()


class BufferedEventsTracker:
    """Async-junction queue depth gauge (reference: buffer gauges in
    SiddhiAppRuntimeImpl.registerForBufferedEvents)."""

    def __init__(self, name: str, junction):
        self.name = name
        self.junction = junction

    def buffered(self) -> int:
        return self.junction.pending()


class EmitTransferTracker:
    """Device→host transfer counters of one device runtime's async emit
    pipeline (core/emit_queue.py EmitStats): a thin gauge view so the
    counters increment on the hot path without touching this module."""

    def __init__(self, name: str, emit_stats):
        self.name = name
        self.emit_stats = emit_stats

    def values(self) -> Dict[str, int]:
        return self.emit_stats.as_dict()


class IngestTracker:
    """Host→device staging counters of one device runtime's ingest
    pipeline (core/ingest_stage.py IngestStats): same thin-gauge pattern
    as EmitTransferTracker — the hot path increments its own counters,
    this view just reads them."""

    def __init__(self, name: str, ingest_stats):
        self.name = name
        self.ingest_stats = ingest_stats

    def values(self) -> Dict[str, int]:
        return self.ingest_stats.as_dict()


class FaultTracker:
    """Fault-injection / recovery counters (util/faults.py FaultStats):
    same thin-gauge pattern as EmitTransferTracker — the harness
    increments its own counters, this view just reads them."""

    def __init__(self, name: str, fault_stats):
        self.name = name
        self.fault_stats = fault_stats

    def values(self) -> Dict[str, int]:
        return self.fault_stats.as_dict()


class DurabilityTracker:
    """Checkpoint-pipeline counters (durability/writer.py
    DurabilityStats): same thin-gauge pattern as FaultTracker — the
    persist path increments its own counters, this view just reads
    them."""

    def __init__(self, name: str, durability_stats):
        self.name = name
        self.durability_stats = durability_stats

    def values(self) -> Dict[str, int]:
        return self.durability_stats.as_dict()


class RobustnessTracker:
    """Overload-protection counters (robustness/ RobustnessStats):
    same thin-gauge pattern as FaultTracker — the admission controller,
    breakers, watchdog and ladder increment their own counters, this
    view just reads them (and the health endpoint reads the SAME
    object, so feed and endpoint cannot disagree)."""

    def __init__(self, name: str, robustness_stats):
        self.name = name
        self.robustness_stats = robustness_stats

    def values(self) -> Dict[str, int]:
        return self.robustness_stats.as_dict()


class StatisticsManager:
    """Tracker registry + periodic console reporter
    (reference: util/statistics/metrics/SiddhiStatisticsManager.java:35)."""

    def __init__(self, app_name: str, interval_s: float = 60.0):
        self.app_name = app_name
        self.interval_s = interval_s
        self.throughput: Dict[str, ThroughputTracker] = {}
        self.latency: Dict[str, LatencyTracker] = {}
        self.buffers: Dict[str, BufferedEventsTracker] = {}
        # per-query device→host emit-transfer gauges (async emit
        # pipeline; one per device-lowered query)
        self.transfers: Dict[str, EmitTransferTracker] = {}
        # per-query host→device ingest-staging gauges (double-buffered
        # H2D pipeline; one per device-lowered query)
        self.ingests: Dict[str, IngestTracker] = {}
        # fault-injection / recovery gauges (@app:faults harness),
        # registered ungated so recovery events stay visible even at
        # statistics level 'off'
        self.faults: Dict[str, FaultTracker] = {}
        # checkpoint-pipeline gauges (async persist writer, durability/),
        # registered ungated like the fault counters — a degraded
        # durability pipeline must stay visible at statistics level 'off'
        self.durability: Dict[str, DurabilityTracker] = {}
        # overload-protection gauges (@app:limits, robustness/),
        # registered ungated — shedding and breaker trips must stay
        # visible at statistics level 'off'
        self.robustness: Dict[str, RobustnessTracker] = {}
        # persist-path degradations (unfreezable element → in-barrier
        # pickle, incremental store forcing sync): count + last reason,
        # keyed '<app>' or '<app>.<kind>:<element>', never silent
        self.persist_fallbacks: Dict[str, int] = {}
        self.persist_fallback_reasons: Dict[str, str] = {}
        # per-query engine placement ('host' | 'dense' | 'device'),
        # populated at app build — not a counter, but reported alongside
        # so execution('tpu') fallbacks are visible in the metrics feed
        self.lowering: Dict[str, str] = {}
        # queries that requested a mesh but fell back to a single
        # device (unsupported kind/feature): count + last reason per
        # query, populated by the planner so the downgrade is never
        # silent
        self.sharded_fallbacks: Dict[str, int] = {}
        self.sharded_fallback_reasons: Dict[str, str] = {}
        # queries (or partitions) under execution('tpu') that fell back
        # to a host engine — the dense/device/probe eligibility gates:
        # count + last reason, populated by the planner so the
        # downgrade is counted, not just logged
        self.device_fallbacks: Dict[str, int] = {}
        self.device_fallback_reasons: Dict[str, str] = {}
        # queries under @app:multiplex that could not be seated in a
        # shared engine (incompatible shape/feature): count + last
        # reason per query, populated by the multiplex planner; and the
        # placements that DID land, keyed by query with their group
        # fingerprint + seat occupancy at placement time
        self.multiplex_fallbacks: Dict[str, int] = {}
        self.multiplex_fallback_reasons: Dict[str, str] = {}
        self.multiplex_placements: Dict[str, str] = {}
        # queries under @app:fuse whose chain (or chain membership)
        # could not stay device-resident and went down the junction
        # path: count + last reason per query, populated by the fusion
        # planner so the downgrade is never silent
        self.fused_fallbacks: Dict[str, int] = {}
        self.fused_fallback_reasons: Dict[str, str] = {}
        # queries under @app:hotkeys that stayed on the plain dense
        # path (outside the scan class): count + last reason per query;
        # and the live routers that DID land, read each report for
        # their promotion/demotion/routed-event decision counters
        self.hotkey_fallbacks: Dict[str, int] = {}
        self.hotkey_fallback_reasons: Dict[str, str] = {}
        self.hotkey_routers: Dict[str, object] = {}
        # queries under @app:kernels whose kernel(s) could not
        # be enabled (probe failure, ineligible shape, lowering
        # rejection): count + last reason per query — the downgrade to
        # a plain formulation is never silent
        self.kernel_fallbacks: Dict[str, int] = {}
        self.kernel_fallback_reasons: Dict[str, str] = {}
        # queries/tables under @app:devtables that kept (or returned to)
        # the host table path — build-time eligibility gates, plan-time
        # join/mutation gates, mid-run demotions and per-batch generic
        # delegations: count + last reason, keyed '<query>' or
        # 'table:<id>'; and the live DeviceTable instances, read each
        # report for their rows/capacity/revision/demotion gauges
        self.devtable_fallbacks: Dict[str, int] = {}
        self.devtable_fallback_reasons: Dict[str, str] = {}
        self.devtables: Dict[str, object] = {}
        # cost-based planner feed (planner/costmodel.py): candidates the
        # cost gates rejected (count + last reason — same discipline as
        # every other fallback family), pins that LOST to a
        # higher-precedence pin (fuse > shard > multiplex > hotkeys),
        # the per-query PlanRecords behind /siddhi-plan, and the
        # app-wide replan history the PlanMonitor / forced-REST path
        # appends to
        self.planner_fallbacks: Dict[str, int] = {}
        self.planner_fallback_reasons: Dict[str, str] = {}
        self.planner_conflicts: Dict[str, int] = {}
        self.planner_conflict_reasons: Dict[str, str] = {}
        self.plans: Dict[str, object] = {}
        self.replans: List[Dict[str, object]] = []
        # batch-cycle tracer (observability/trace.py); registered ungated
        # at app build — stage_stats() only reports stages that actually
        # recorded spans, so host-only apps keep an empty feed
        self.tracer = None
        self._reporter: Optional[threading.Thread] = None
        self._running = False
        # generation counter: a restarted reporter invalidates the old
        # thread even if it is still asleep inside its interval
        self._generation = 0

    def _metric(self, kind: str, name: str, metric: str) -> str:
        return f"io.siddhi.SiddhiApps.{self.app_name}.Siddhi.{kind}.{name}.{metric}"

    def throughput_tracker(self, name: str) -> ThroughputTracker:
        return self.throughput.setdefault(name, ThroughputTracker(name))

    def latency_tracker(self, name: str) -> LatencyTracker:
        return self.latency.setdefault(name, LatencyTracker(name))

    def buffer_tracker(self, name: str, junction) -> BufferedEventsTracker:
        return self.buffers.setdefault(name, BufferedEventsTracker(name, junction))

    def transfer_tracker(self, name: str, emit_stats) -> EmitTransferTracker:
        return self.transfers.setdefault(
            name, EmitTransferTracker(name, emit_stats))

    def ingest_tracker(self, name: str, ingest_stats) -> IngestTracker:
        return self.ingests.setdefault(
            name, IngestTracker(name, ingest_stats))

    def fault_tracker(self, name: str, fault_stats) -> FaultTracker:
        return self.faults.setdefault(name, FaultTracker(name, fault_stats))

    def durability_tracker(self, name: str,
                           durability_stats) -> DurabilityTracker:
        return self.durability.setdefault(
            name, DurabilityTracker(name, durability_stats))

    def robustness_tracker(self, name: str,
                           robustness_stats) -> RobustnessTracker:
        return self.robustness.setdefault(
            name, RobustnessTracker(name, robustness_stats))

    def record_persist_fallback(self, name: str, reason: str):
        """A persist degraded (element pickled in-barrier, async forced
        sync); counted with the last reason kept."""
        self.persist_fallbacks[name] = (
            self.persist_fallbacks.get(name, 0) + 1)
        self.persist_fallback_reasons[name] = reason

    def record_sharded_fallback(self, qname: str, reason: str):
        """A query that requested mesh sharding is running
        single-device; counted per query with the last reason kept."""
        self.sharded_fallbacks[qname] = (
            self.sharded_fallbacks.get(qname, 0) + 1)
        self.sharded_fallback_reasons[qname] = reason

    def record_device_fallback(self, qname: str, reason: str):
        """A query (or partition) that requested execution('tpu') is
        running on a host engine; counted with the last reason kept."""
        self.device_fallbacks[qname] = (
            self.device_fallbacks.get(qname, 0) + 1)
        self.device_fallback_reasons[qname] = reason

    def record_multiplex_fallback(self, qname: str, reason: str):
        """A query under @app:multiplex is running on a dedicated
        engine; counted per query with the last reason kept."""
        self.multiplex_fallbacks[qname] = (
            self.multiplex_fallbacks.get(qname, 0) + 1)
        self.multiplex_fallback_reasons[qname] = reason

    def record_fused_fallback(self, qname: str, reason: str):
        """A query under @app:fuse is hopping through its junction
        instead of a fused device chain; counted per query with the
        last reason kept."""
        self.fused_fallbacks[qname] = (
            self.fused_fallbacks.get(qname, 0) + 1)
        self.fused_fallback_reasons[qname] = reason

    def record_hotkey_fallback(self, qname: str, reason: str):
        """A query under @app:hotkeys is running plain dense routing;
        counted per query with the last reason kept."""
        self.hotkey_fallbacks[qname] = (
            self.hotkey_fallbacks.get(qname, 0) + 1)
        self.hotkey_fallback_reasons[qname] = reason

    def record_kernel_fallback(self, qname: str, reason: str):
        """A query (or aggregation) under @app:kernels is running the
        plain formulation for at least one kernel kind; counted per
        query with the last reason kept."""
        self.kernel_fallbacks[qname] = (
            self.kernel_fallbacks.get(qname, 0) + 1)
        self.kernel_fallback_reasons[qname] = reason

    def record_devtable_fallback(self, name: str, reason: str):
        """A query or table under @app:devtables is using the host
        table path (ineligible, demoted, or a batch delegated to the
        generic callback); counted with the last reason kept."""
        self.devtable_fallbacks[name] = (
            self.devtable_fallbacks.get(name, 0) + 1)
        self.devtable_fallback_reasons[name] = reason

    def record_planner_fallback(self, qname: str, reason: str):
        """The cost model rejected a candidate lowering (or refused a
        replan) for a query; counted per query with the last reason
        kept — a cost-gate rejection is never silent."""
        self.planner_fallbacks[qname] = (
            self.planner_fallbacks.get(qname, 0) + 1)
        self.planner_fallback_reasons[qname] = reason

    def record_planner_conflict(self, qname: str, reason: str):
        """Two pinned annotations applied to one query and the
        lower-precedence pin lost (fuse > shard > multiplex > hotkeys);
        counted per query with the last reason kept."""
        self.planner_conflicts[qname] = (
            self.planner_conflicts.get(qname, 0) + 1)
        self.planner_conflict_reasons[qname] = reason

    def register_plan(self, qname: str, record):
        """The chosen PlanRecord for a query (planner/costmodel.py):
        candidates with costs, the pick, pins, and the per-query
        re-plan history — the payload behind /siddhi-plan/<app>."""
        self.plans[qname] = record

    def record_replan(self, qname: str, old: str, new: str,
                      forced: bool, reason: str):
        """A live re-lowering switched a query's plan; appended to the
        app-wide history and the query's PlanRecord."""
        entry = {"query": qname, "from": old, "to": new,
                 "forced": forced, "reason": reason, "ts": time.time()}
        self.replans.append(entry)
        rec = self.plans.get(qname)
        if rec is not None:
            rec.note_replan(old, new, forced, reason)

    def register_devtable(self, tname: str, table):
        """A live DeviceTable; its ``devtable_metrics()`` gauges (live
        rows, capacity, revision, scatter steps, compactions,
        demotions) join the feed under ``Tables.<name>.*``."""
        self.devtables[tname] = table

    def register_hotkey_router(self, qname: str, router):
        """A live HotKeyRouterRuntime; its ``hot_metrics()`` gauges
        (promotions/demotions/routed events/active keys) join the
        feed."""
        self.hotkey_routers[qname] = router

    def record_multiplex_placement(self, qname: str, fingerprint: str,
                                   occupied: int):
        """A query seated in a shared multiplex group."""
        self.multiplex_placements[qname] = (
            f"{fingerprint[:12]}:{occupied}")

    def register_tracer(self, tracer):
        """The app's batch-cycle tracer; its per-stage span histograms
        join the feed as ``Stages.<stage>.<metric>`` keys."""
        self.tracer = tracer

    def stats(self) -> Dict[str, object]:
        """Metric name -> value.  Values are floats except the
        ``Queries.<name>.loweredTo`` /
        ``Queries.<name>.shardedFallbackReason`` keys, whose values are
        strings."""
        out: Dict[str, object] = {}
        # snapshot the registries: _apply_statistics_level repopulates
        # them from another thread while the reporter iterates
        for t in list(self.throughput.values()):
            out[self._metric("Streams", t.name, "throughput")] = t.events_per_second()
            out[self._metric("Streams", t.name, "totalEvents")] = t.count
        for l in list(self.latency.values()):
            out[self._metric("Queries", l.name, "latencyAvgMs")] = l.avg_ms()
            out[self._metric("Queries", l.name, "latencyMaxMs")] = l.max_ms()
            out[self._metric("Queries", l.name, "latencyP50Ms")] = l.p50_ms()
            out[self._metric("Queries", l.name, "latencyP95Ms")] = l.p95_ms()
            out[self._metric("Queries", l.name, "latencyP99Ms")] = l.p99_ms()
            out[self._metric("Queries", l.name, "events")] = l.events
        for b in list(self.buffers.values()):
            out[self._metric("Streams", b.name, "bufferedEvents")] = b.buffered()
        for tt in list(self.transfers.values()):
            for metric, v in tt.values().items():
                out[self._metric("Queries", tt.name, metric)] = v
        for it in list(self.ingests.values()):
            for metric, v in it.values().items():
                out[self._metric("Queries", it.name, metric)] = v
        for ft in list(self.faults.values()):
            for metric, v in ft.values().items():
                out[self._metric("Faults", ft.name, metric)] = v
        for dt in list(self.durability.values()):
            for metric, v in dt.values().items():
                out[self._metric("Durability", dt.name, metric)] = v
        for rt in list(self.robustness.values()):
            for metric, v in rt.values().items():
                out[self._metric("Robustness", rt.name, metric)] = v
        for name, n in list(self.persist_fallbacks.items()):
            out[self._metric("Durability", name, "persistFallbacks")] = n
            out[self._metric("Durability", name, "persistFallbackReason")] = (
                self.persist_fallback_reasons.get(name, ""))
        for qname, engine in list(self.lowering.items()):
            out[self._metric("Queries", qname, "loweredTo")] = engine
        for qname, n in list(self.sharded_fallbacks.items()):
            out[self._metric("Queries", qname, "shardedFallbacks")] = n
            out[self._metric("Queries", qname, "shardedFallbackReason")] = (
                self.sharded_fallback_reasons.get(qname, ""))
        for qname, n in list(self.device_fallbacks.items()):
            out[self._metric("Queries", qname, "deviceFallbacks")] = n
            out[self._metric("Queries", qname, "deviceFallbackReason")] = (
                self.device_fallback_reasons.get(qname, ""))
        for qname, n in list(self.multiplex_fallbacks.items()):
            out[self._metric("Queries", qname, "multiplexFallbacks")] = n
            out[self._metric("Queries", qname, "multiplexFallbackReason")] = (
                self.multiplex_fallback_reasons.get(qname, ""))
        for qname, gp in list(self.multiplex_placements.items()):
            out[self._metric("Queries", qname, "multiplexGroup")] = gp
        for qname, n in list(self.fused_fallbacks.items()):
            out[self._metric("Queries", qname, "fusedFallbacks")] = n
            out[self._metric("Queries", qname, "fusedFallbackReason")] = (
                self.fused_fallback_reasons.get(qname, ""))
        for qname, n in list(self.hotkey_fallbacks.items()):
            out[self._metric("Queries", qname, "hotkeyFallbacks")] = n
            out[self._metric("Queries", qname, "hotkeyFallbackReason")] = (
                self.hotkey_fallback_reasons.get(qname, ""))
        for qname, router in list(self.hotkey_routers.items()):
            for metric, v in router.hot_metrics().items():
                out[self._metric("Queries", qname, metric)] = v
        for qname, n in list(self.kernel_fallbacks.items()):
            out[self._metric("Queries", qname, "kernelFallbacks")] = n
            out[self._metric("Queries", qname, "kernelFallbackReason")] = (
                self.kernel_fallback_reasons.get(qname, ""))
        for qname, n in list(self.devtable_fallbacks.items()):
            out[self._metric("Queries", qname, "devtableFallbacks")] = n
            out[self._metric("Queries", qname, "devtableFallbackReason")] = (
                self.devtable_fallback_reasons.get(qname, ""))
        for qname, n in list(self.planner_fallbacks.items()):
            out[self._metric("Queries", qname, "plannerFallbacks")] = n
            out[self._metric("Queries", qname, "plannerFallbackReason")] = (
                self.planner_fallback_reasons.get(qname, ""))
        for qname, n in list(self.planner_conflicts.items()):
            out[self._metric("Queries", qname, "plannerConflicts")] = n
            out[self._metric("Queries", qname, "plannerConflictReason")] = (
                self.planner_conflict_reasons.get(qname, ""))
        for qname, rec in list(self.plans.items()):
            # legacy-mode records are informational (the REST plan dump
            # reads them); they stay off the metrics feed so un-annotated
            # apps keep their pre-cost-model statistics surface
            if rec.mode == "legacy" and not rec.replans:
                continue
            out[self._metric("Queries", qname, "plannerPath")] = rec.chosen
            out[self._metric("Queries", qname, "plannerPredictedCost")] = (
                rec.predicted_cost)
            out[self._metric("Queries", qname, "plannerReplans")] = (
                len(rec.replans))
        for tname, table in list(self.devtables.items()):
            for metric, v in table.devtable_metrics().items():
                out[self._metric("Tables", tname, metric)] = v
        if self.tracer is not None:
            for stage, metrics in self.tracer.stage_stats().items():
                for metric, v in metrics.items():
                    out[self._metric("Stages", stage, metric)] = v
        return out

    def reset(self):
        for t in list(self.throughput.values()):
            t.reset()
        for l in list(self.latency.values()):
            l.reset()

    # -- console reporter ---------------------------------------------------

    def start_reporting(self):
        import logging

        if self._running:
            return
        self._running = True
        self._generation += 1
        gen = self._generation
        log = logging.getLogger(__name__)

        def loop():
            while self._running and gen == self._generation:
                time.sleep(self.interval_s)
                if not self._running or gen != self._generation:
                    break
                try:
                    for k, v in sorted(self.stats().items()):
                        log.info("%s = %s", k, v)
                except Exception:  # noqa: BLE001 — reporter must survive
                    log.exception("statistics reporter failed; continuing")

        self._reporter = threading.Thread(
            target=loop, name=f"stats-{self.app_name}", daemon=True
        )
        self._reporter.start()

    def stop_reporting(self):
        self._running = False
        self._generation += 1
