"""Partitions: ``partition with (expr of Stream) begin ... end``.

Port of the dense half of the JAX package's ``core/partition.py``.  A
partition whose body is pattern queries lowers to ONE dense engine per
query with the partition key interned onto the engine's partition axis:
per-key state rows on the device, no per-key Python instances.  The
value-partition executor evaluates the key expression once per batch
and ``DensePartitionReceiver`` advances every pattern runtime that
reads the stream, passing the raw key values along: a query with an
aggregating selector keeps its per-key state through them (the match
rows' partition-key side channel).

``@purge(enable='true', interval=, idle.period=)`` makes the partition
an app scheduler task: every ``interval`` it reclaims the rows of keys
idle for ``idle.period`` in each dense query runtime (``purge_idle``).

Where the reference falls back to per-key host instances (a body it
cannot lower, no ``@app:execution('tpu')``, a rate-limited query), the
port raises: host instances and range partitions are ``ROADMAP.md`` §1
item 7, single-stream queries in a partition item 6 or 7.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from siddhi_tpu_torch.compiler.parser import parse_time_string
from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError, later_slice
from siddhi_tpu_torch.planner.expr import (
    N_KEY,
    TS_KEY,
    CompiledExpression,
    ExpressionCompiler,
    Scope,
)
from siddhi_tpu_torch.planner.query_planner import plan_dense_state
from siddhi_tpu_torch.query_api import (
    CountStateElement,
    EveryStateElement,
    InsertIntoStream,
    LogicalStateElement,
    NextStateElement,
    Partition,
    Query,
    ReturnStream,
    StateInputStream,
    StreamStateElement,
    ValuePartitionType,
)
from siddhi_tpu_torch.query_api.annotation import find_annotation

_INSTANCES = later_slice(7, "per-key host instances")


class ValuePartitionExecutor:
    """Key = expression value, evaluated on the host columns."""

    def __init__(self, compiled: CompiledExpression):
        self.compiled = compiled

    def keys_array(self, batch: EventBatch) -> np.ndarray:
        """Raw key column (native dtype, no per-element boxing); the
        dense path interns straight from this."""
        env = dict(batch.columns)
        env[TS_KEY] = batch.timestamps
        env[N_KEY] = len(batch)
        return np.broadcast_to(np.asarray(self.compiled.fn(env)),
                               (len(batch),))


class DensePartitionReceiver:
    """Subscriber on a partitioned stream's junction: evaluates the
    partition executor once per batch and advances every dense pattern
    runtime that reads this stream, in query plan order."""

    def __init__(self, stream_id: str, executor, runtimes: List):
        self.stream_id = stream_id
        self.executor = executor
        self.runtimes = runtimes

    def receive(self, batch: EventBatch):
        cur = batch.only(ev.CURRENT)
        if len(cur) == 0:
            return
        keys = self.executor.keys_array(cur)
        if keys.dtype == object:
            # string keys: re-infer a native '<U' dtype so the vectorized
            # intern index applies
            keys = np.asarray(keys.tolist())
        for rt in self.runtimes:
            part = rt.intern_keys(keys)
            rt.process_stream_batch(self.stream_id, cur, part, keys)


def _pattern_stream_ids(st: StateInputStream) -> List[str]:
    """Junction keys of every source stream of a pattern (``#`` inner and
    ``!`` fault prefixes kept, so they never pass for a partitioned
    stream)."""
    out: List[str] = []

    def walk(el):
        if isinstance(el, NextStateElement):
            walk(el.element)
            walk(el.next)
        elif isinstance(el, EveryStateElement):
            walk(el.element)
        elif isinstance(el, CountStateElement):
            walk(el.stream_state)
        elif isinstance(el, LogicalStateElement):
            walk(el.element1)
            walk(el.element2)
        elif isinstance(el, StreamStateElement):
            s = el.stream
            prefix = "#" if s.is_inner else ("!" if s.is_fault else "")
            if prefix + s.stream_id not in out:
                out.append(prefix + s.stream_id)

    walk(st.state)
    return out


class PartitionRuntime:
    """One ``partition ... begin ... end`` block, lowered to the dense
    path."""

    def __init__(self, partition: Partition, app, index: int):
        self.partition = partition
        self.name = f"partition_{index}"
        ctx = app.app_context
        # @purge(enable='true', interval='..', idle.period='..')
        self._purge_interval_ms: Optional[int] = None
        self._purge_idle_ms: Optional[int] = None
        self._next_purge: Optional[int] = None
        purge = find_annotation(partition.annotations, "purge")
        if purge is not None and (purge.element("enable") or "false"
                                  ).lower() == "true":
            self._purge_interval_ms = parse_time_string(
                purge.element("interval") or "1 min")
            self._purge_idle_ms = parse_time_string(
                purge.element("idle.period") or "15 min")
        if ctx.execution_mode != "tpu":
            raise SiddhiAppCreationError(
                f"{self.name}: the port runs partitions on the dense device "
                "path only (add @app:execution('tpu'))" + _INSTANCES)

        self.partitioned_defs = {}
        executors: Dict[str, ValuePartitionExecutor] = {}
        for pt in partition.partition_types:
            sid = pt.stream_id
            if sid not in app.definitions:
                raise SiddhiAppCreationError(
                    f"{self.name}: partitioned stream '{sid}' is not defined")
            if not isinstance(pt, ValuePartitionType):
                raise SiddhiAppCreationError(
                    f"{self.name}: range partitions" + _INSTANCES)
            definition = app.definitions[sid]
            self.partitioned_defs[sid] = definition
            scope = Scope()
            for a in definition.attributes:
                scope.add(sid, a.name, a.name, a.type)
            executors[sid] = ValuePartitionExecutor(
                ExpressionCompiler(scope).compile(pt.expression))

        # validate every query before planning any
        for q in partition.queries:
            if not isinstance(q, Query):
                raise SiddhiAppCreationError("nested element not a query")
            out = q.output_stream
            if isinstance(out, InsertIntoStream) and out.is_inner:
                raise SiddhiAppCreationError(
                    f"{self.name}: 'insert into #inner' needs per-key "
                    "instances" + _INSTANCES)
            if not isinstance(out, (InsertIntoStream, ReturnStream)) \
                    and out is not None:
                raise SiddhiAppCreationError(
                    f"{self.name}: table outputs need per-key instances"
                    + _INSTANCES)
            st = q.input_stream
            if not isinstance(st, StateInputStream):
                raise SiddhiAppCreationError(
                    f"{self.name}: non-pattern queries run on the "
                    "reference's device query path in partition mode "
                    "(ROADMAP.md §1 item 6) or in per-key instances"
                    + _INSTANCES)
            for sid in _pattern_stream_ids(st):
                if sid not in self.partitioned_defs:
                    raise SiddhiAppCreationError(
                        f"pattern input '{sid}' is not a partitioned stream")

        # query name -> QueryRuntime (its pattern_processor is the dense
        # runtime or the hot-key router wrapping it)
        self.dense_query_runtimes: Dict[str, object] = {}
        for qi, q in enumerate(partition.queries):
            info = find_annotation(q.annotations, "info")
            name = ((info.element("name") if info else None)
                    or f"{self.name}_q{qi}")
            self.dense_query_runtimes[name] = plan_dense_state(
                app, q, name, q.input_stream,
                n_partitions=ctx.tpu_partitions)
        for sid, ex in executors.items():
            runtimes = [
                qr.pattern_processor
                for qr in self.dense_query_runtimes.values()
                if sid in qr.pattern_processor.engine.stream_keys]
            if runtimes:
                app.junctions[sid].subscribe(
                    DensePartitionReceiver(sid, ex, runtimes))
        if self._purge_interval_ms is not None:
            ctx.scheduler.register_task(self)

    # -- idle-key purge (scheduler task) -------------------------------------

    def next_wakeup(self) -> Optional[int]:
        return self._next_purge

    def on_start(self, now: int):
        if self._purge_interval_ms is not None:
            self._next_purge = now + self._purge_interval_ms

    def fire(self, now: int):
        """Reclaim the rows of idle keys in every dense query runtime."""
        while self._next_purge is not None and self._next_purge <= now:
            self._next_purge += self._purge_interval_ms
        for qr in self.dense_query_runtimes.values():
            qr.pattern_processor.purge_idle(now, self._purge_idle_ms)
