"""Partitions: ``partition with (expr of Stream) begin ... end``.

Port of the device half of the JAX package's ``core/partition.py``.  A
partition lowers every query of its body to ONE device engine with the
partition key on the engine's key axis: per-key state rows on the
device, no per-key Python instances.  A pattern query runs on the dense
engine, the key interned onto its partition axis; a filter, window or
group-by query runs on the device query engine in partition mode, the
key composed into its group axis and scoping its windows per key.  The
value-partition executor evaluates the key expression once per batch
and ``DensePartitionReceiver`` advances every runtime that reads the
stream in query plan order, passing the raw key values along (a dense
query with an aggregating selector keeps its per-key state through
them, the match rows' partition-key side channel).

``@purge(enable='true', interval=, idle.period=)`` makes the partition
an app scheduler task: every ``interval`` it reclaims the rows of keys
idle for ``idle.period`` in each query runtime (``purge_idle``).

Where the reference falls back to per-key host instances (a body it
cannot lower, such as a tumbling window, a rate limit or order by; no
``@app:execution('tpu')``), the port raises: per-key host instances are
``ROADMAP.md`` §1 item 7.  Range partitions key each row by the label
of the first range it meets, and drop the rows no range takes.
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
from siddhi_tpu_torch.planner.query_planner import (
    device_query_engine,
    plan_dense_state,
    plan_device_single,
)
from siddhi_tpu_torch.query_api import (
    CountStateElement,
    EveryStateElement,
    InsertIntoStream,
    LogicalStateElement,
    NextStateElement,
    Partition,
    Query,
    RangePartitionType,
    ReturnStream,
    SingleInputStream,
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

    def keyed(self, batch: EventBatch):
        """The batch and its raw key column (native dtype, no
        per-element boxing); the dense path interns straight from it."""
        env = dict(batch.columns)
        env[TS_KEY] = batch.timestamps
        env[N_KEY] = len(batch)
        return batch, np.broadcast_to(np.asarray(self.compiled.fn(env)),
                                      (len(batch),))


class RangePartitionExecutor:
    """Key = the label of the first range condition a row meets; a row
    that meets none is dropped."""

    def __init__(self, ranges):
        self.ranges = ranges  # [(CompiledExpression, label)]

    def keyed(self, batch: EventBatch):
        """The rows some range takes, and their labels."""
        n = len(batch)
        env = dict(batch.columns)
        env[TS_KEY] = batch.timestamps
        env[N_KEY] = n
        out = np.full(n, None, dtype=object)
        assigned = np.zeros(n, dtype=bool)
        for cond, label in self.ranges:
            m = np.broadcast_to(np.asarray(cond.fn(env)), (n,)) & ~assigned
            out[m] = label
            assigned |= m
        if not assigned.all():
            batch, out = batch.mask(assigned), out[assigned]
        return batch, out


class DensePartitionReceiver:
    """Subscriber on a partitioned stream's junction: evaluates the
    partition executor once per batch and advances every device runtime
    that reads this stream, in query plan order, with the raw key
    column (``process_partitioned``)."""

    def __init__(self, stream_id: str, executor, runtimes: List):
        self.stream_id = stream_id
        self.executor = executor
        self.runtimes = runtimes

    def receive(self, batch: EventBatch):
        cur = batch.only(ev.CURRENT)
        if len(cur) == 0:
            return
        cur, keys = self.executor.keyed(cur)
        if len(cur) == 0:
            return
        if keys.dtype == object:
            # string keys: re-infer a native '<U' dtype so the vectorized
            # intern index applies
            keys = np.asarray(keys.tolist())
        for rt in self.runtimes:
            rt.process_partitioned(self.stream_id, cur, keys)


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
    """One ``partition ... begin ... end`` block, lowered to the device
    paths."""

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
            definition = app.definitions[sid]
            self.partitioned_defs[sid] = definition
            scope = Scope()
            for a in definition.attributes:
                scope.add(sid, a.name, a.name, a.type)
            compiler = ExpressionCompiler(scope)
            if isinstance(pt, ValuePartitionType):
                executors[sid] = ValuePartitionExecutor(
                    compiler.compile(pt.expression))
            elif isinstance(pt, RangePartitionType):
                executors[sid] = RangePartitionExecutor(
                    [(compiler.compile(c), label) for c, label in pt.ranges])
            else:
                raise SiddhiAppCreationError(
                    f"{self.name}: unknown partition type {pt!r}")

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
            if isinstance(st, StateInputStream):
                for sid in _pattern_stream_ids(st):
                    if sid not in self.partitioned_defs:
                        raise SiddhiAppCreationError(
                            f"pattern input '{sid}' is not a partitioned "
                            "stream")
            elif isinstance(st, SingleInputStream):
                if st.is_inner or st.is_fault:
                    raise SiddhiAppCreationError(
                        f"{self.name}: inner and fault stream inputs need "
                        "per-key instances" + _INSTANCES)
                if st.stream_id not in self.partitioned_defs:
                    raise SiddhiAppCreationError(
                        f"{self.name}: input '{st.stream_id}' is not a "
                        "partitioned stream" + _INSTANCES)
            else:
                raise SiddhiAppCreationError(
                    f"{self.name}: join queries inside partitions need "
                    "per-key instances" + _INSTANCES)
        # every single-stream engine before any query is planned: the
        # reference moves the whole body to per-key instances when one
        # query cannot lower
        engines = {}
        for qi, q in enumerate(partition.queries):
            if isinstance(q.input_stream, SingleInputStream):
                try:
                    engines[qi] = device_query_engine(
                        app, q, q.input_stream, partition_mode=True)
                except SiddhiAppCreationError as e:
                    raise SiddhiAppCreationError(
                        f"{self.name}: {e}" + _INSTANCES) from e

        # query name -> QueryRuntime (its pattern_processor is the dense
        # runtime or the hot-key router wrapping it; its device_runtime
        # the device query runtime)
        self.dense_query_runtimes: Dict[str, object] = {}
        for qi, q in enumerate(partition.queries):
            info = find_annotation(q.annotations, "info")
            name = ((info.element("name") if info else None)
                    or f"{self.name}_q{qi}")
            if qi in engines:
                qr = plan_device_single(app, q, name, q.input_stream,
                                        engines[qi], subscribe=False)
            else:
                qr = plan_dense_state(app, q, name, q.input_stream,
                                      n_partitions=ctx.tpu_partitions)
            self.dense_query_runtimes[name] = qr
        for sid, ex in executors.items():
            runtimes = [rt for rt in self._runtimes() if rt.reads(sid)]
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

    def _runtimes(self) -> List:
        """Each query's device runtime, in plan order."""
        return [qr.device_processor
                for qr in self.dense_query_runtimes.values()]

    def fire(self, now: int):
        """Reclaim the rows of idle keys in every query runtime."""
        while self._next_purge is not None and self._next_purge <= now:
            self._next_purge += self._purge_interval_ms
        for rt in self._runtimes():
            rt.purge_idle(now, self._purge_idle_ms)
