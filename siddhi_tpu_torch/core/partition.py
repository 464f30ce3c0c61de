"""Partitions: ``partition with (expr of Stream, ...) begin ... end``.

Port of the JAX package's ``core/partition.py`` (the reference's
PartitionRuntimeImpl.java:75, PartitionStreamReceiver.java:44,
ValuePartitionExecutor.java:34, RangePartitionExecutor.java).  A
partition runs in one of two forms, chosen as the reference chooses:

- per-key instances, the reference's default mode: the partition
  executor evaluates the key once per batch, the rows are grouped by
  key in order of first appearance, and each key's sub-batch goes to
  that key's ``PartitionInstance``, a copy of the body planned lazily on
  the key's first event.  An instance plans through a facade
  (``InstancePlanner``) whose junctions are its own (the partitioned
  streams and ``#inner`` streams), whose outputs are the app's, and
  whose scheduler records what the instance registers (windows, rate
  limits, pattern deadlines), so that an idle-key purge unregisters
  them.  Everything in an instance runs on the host, patterns on the
  host pattern engine, and allocates nothing on the card.  An inert
  ``__template__`` instance, planned at creation and closed, creates the
  output junctions and surfaces plan errors then;
- under ``@app:execution('tpu')``, the device form: every query of the
  body lowers to ONE device engine with the partition key on the
  engine's key axis.  A pattern query runs on the dense engine, the key
  interned onto its partition axis; a filter, window or group-by query
  runs on the device query engine in partition mode, the key composed
  into its group axis.  ``DensePartitionReceiver`` evaluates the key
  once per batch and advances every runtime that reads the stream in
  query plan order, passing the raw key values along.  When one query
  of the body cannot lower (a tumbling window, a rate limit, order by,
  ``#inner`` streams, a host-only pattern shape), the partition logs a
  WARNING with the reason, unregisters what the lowered queries
  registered, and moves the whole body to per-key instances, as the
  reference does.

``@purge(enable='true', interval=, idle.period=)`` makes the partition
an app scheduler task: every ``interval`` it drops the instances (or
reclaims the device rows) of keys idle for ``idle.period``.  Range
partitions key each row by the label of the first range it meets, and
drop the rows no range takes.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from siddhi_tpu_torch.compiler.parser import parse_time_string
from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import (
    KernelUnavailableError,
    SiddhiAppCreationError,
)
from siddhi_tpu_torch.core.stream import StreamJunction
from siddhi_tpu_torch.planner.host_expr import (
    N_KEY,
    TS_KEY,
    CompiledExpression,
    ExpressionCompiler,
)
from siddhi_tpu_torch.planner.query_planner import (
    device_query_engine,
    plan_dense_state,
    plan_device_single,
    plan_query,
    scope_for_definition,
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
    StreamDefinition,
    StreamStateElement,
    ValuePartitionType,
)
from siddhi_tpu_torch.query_api.annotation import find_annotation

log = logging.getLogger("siddhi_tpu_torch")


def _batch_env(batch: EventBatch) -> Dict:
    env = dict(batch.columns)
    env[TS_KEY] = batch.timestamps
    env[N_KEY] = len(batch)
    return env


class ValuePartitionExecutor:
    """Key = expression value, evaluated on the host columns."""

    def __init__(self, compiled: CompiledExpression):
        self.compiled = compiled

    def keyed(self, batch: EventBatch):
        """The batch and its raw key column (native dtype, no
        per-element boxing); the dense path interns straight from it."""
        return batch, np.broadcast_to(
            np.asarray(self.compiled.fn(_batch_env(batch))), (len(batch),))


class RangePartitionExecutor:
    """Key = the label of the first range condition a row meets; a row
    that meets none is dropped."""

    def __init__(self, ranges):
        self.ranges = ranges  # [(CompiledExpression, label)]

    def keyed(self, batch: EventBatch):
        """The rows some range takes, and their labels."""
        n = len(batch)
        env = _batch_env(batch)
        out = np.full(n, None, dtype=object)
        assigned = np.zeros(n, dtype=bool)
        for cond, label in self.ranges:
            m = np.broadcast_to(np.asarray(cond.fn(env)), (n,)) & ~assigned
            out[m] = label
            assigned |= m
        if not assigned.all():
            batch, out = batch.mask(assigned), out[assigned]
        return batch, out


# -- the device form ----------------------------------------------------------


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


# -- per-key instances ----------------------------------------------------------


class _ScopedScheduler:
    """The app scheduler as one instance sees it: records what the
    instance registers, so that a purged (or the template) instance
    unregisters all of it and leaves no ghost window ticks or tasks."""

    def __init__(self, real):
        self._real = real
        self._items: List[Tuple[str, object]] = []

    def register_window(self, query_runtime, window):
        self._real.register_window(query_runtime, window)
        self._items.append(("window", (query_runtime, window)))

    def register_task(self, task):
        self._real.register_task(task)
        self._items.append(("task", task))

    def unregister_all(self):
        for kind, item in self._items:
            if kind == "window":
                self._real.unregister_window(*item)
            else:
                self._real.unregister_task(item)
        self._items = []


def _junction_key(s) -> str:
    if s.is_inner:
        return "#" + s.stream_id
    if s.is_fault:
        return "!" + s.stream_id
    return s.stream_id


class InstancePlanner:
    """The planner's ``app`` for one partition key: local junctions for
    the partitioned streams and ``#inner`` streams, the app's output
    junctions, a scoped scheduler; everything else is the app's."""

    # the planner plans single-stream queries and patterns on the host
    # here: the device form of a partition is ONE engine with the keys
    # on its key axis, not an engine a key
    in_partition_instance = True

    def __init__(self, app, partitioned_defs: Dict[str, StreamDefinition]):
        self._app = app
        self.app_context = app.app_context
        self.extensions = app.extensions
        self.scheduler = _ScopedScheduler(app.scheduler)
        # the input namespace is local only: a query inside a partition
        # reads the partitioned streams or '#inner' ones (a global read
        # would make every key's instance a duplicate subscriber)
        self.junctions: Dict[str, StreamJunction] = {}
        self.local_definitions: Dict[str, StreamDefinition] = {}
        for sid, definition in partitioned_defs.items():
            self.junctions[sid] = StreamJunction(definition, app.app_context)
            self.local_definitions[sid] = definition

    def resolve_stream_definition(self, s) -> StreamDefinition:
        d = self.local_definitions.get(_junction_key(s))
        return d if d is not None else self._app.resolve_stream_definition(s)

    def junction_for_input(self, s) -> StreamJunction:
        key = _junction_key(s)
        if key in self.junctions:
            return self.junctions[key]
        raise SiddhiAppCreationError(
            f"stream '{key}': queries inside a partition can only read "
            "the partitioned streams or '#inner' streams")

    def output_junction(self, out_def: StreamDefinition,
                        is_inner: bool = False) -> StreamJunction:
        if not is_inner:
            return self._app.output_junction(out_def)
        key = "#" + out_def.id
        if key not in self.junctions:
            d = StreamDefinition(id=out_def.id,
                                 attributes=list(out_def.attributes))
            self.junctions[key] = StreamJunction(d, self.app_context)
            self.local_definitions[key] = d
        return self.junctions[key]


class PartitionInstance:
    """One key's planned copy of the partition's queries."""

    def __init__(self, key, partition: Partition, app, partitioned_defs):
        self.key = key
        self.planner = InstancePlanner(app, partitioned_defs)
        self.query_runtimes: Dict[str, object] = {}
        for qi, q in enumerate(partition.queries):
            qr = plan_query(self.planner, q, qi)
            self.query_runtimes[qr.name] = qr
        self.last_used = 0

    def send(self, stream_id: str, batch: EventBatch, now: int):
        self.last_used = now
        self.planner.junctions[stream_id].send(batch)

    def close(self):
        """Unregister every scheduler hook this instance planted."""
        self.planner.scheduler.unregister_all()


class PartitionStreamReceiver:
    """Subscriber on a partitioned stream's junction: evaluates the
    partition executor once per batch, groups the rows by key in order
    of first appearance (a null key drops its row) and sends each key's
    rows, in order, to its instance (reference:
    PartitionStreamReceiver.receive:82-118)."""

    def __init__(self, partition_runtime: "PartitionRuntime",
                 stream_id: str, executor):
        self.partition_runtime = partition_runtime
        self.stream_id = stream_id
        self.executor = executor

    def receive(self, batch: EventBatch):
        pr = self.partition_runtime
        now = pr.app_context.timestamp_generator.current_time()
        batch, keys = self.executor.keyed(batch)
        index: Dict = {}
        codes = []
        for k in keys.tolist():
            if k is None:
                codes.append(-1)
                continue
            c = index.get(k)
            if c is None:
                c = index[k] = len(index)
            codes.append(c)
        if not index:
            return
        if len(index) == 1 and -1 not in codes:
            pr.instance_for(next(iter(index))).send(self.stream_id, batch,
                                                    now)
            return
        codes = np.asarray(codes)
        # the rows of each key, contiguous and in arrival order (the null
        # keys' rows sort first and are left out)
        order = np.argsort(codes, kind="stable")
        counts = np.bincount(codes + 1)
        ordered = batch.take(order[counts[0]:])
        bounds = np.concatenate(([0], np.cumsum(counts[1:])))
        for k, c in index.items():
            lo, hi = int(bounds[c]), int(bounds[c + 1])
            pr.instance_for(k).send(self.stream_id,
                                    _rows(ordered, lo, hi), now)


def _rows(batch: EventBatch, lo: int, hi: int) -> EventBatch:
    """Rows ``[lo, hi)`` of ``batch`` as views."""
    return EventBatch(
        batch.stream_id, batch.attribute_names,
        {a: c[lo:hi] for a, c in batch.columns.items()},
        batch.timestamps[lo:hi], batch.types[lo:hi])


# -- the partition ----------------------------------------------------------------


class PartitionRuntime:
    """All instances (or the device engines) of one ``partition ...
    begin ... end`` block."""

    def __init__(self, partition: Partition, app, index: int):
        self.partition = partition
        self.app = app
        self.app_context = ctx = app.app_context
        self.name = f"partition_{index}"
        self.instances: Dict[object, PartitionInstance] = {}

        self.partitioned_defs: Dict[str, StreamDefinition] = {}
        self._executors: Dict[str, object] = {}
        for pt in partition.partition_types:
            sid = pt.stream_id
            if sid not in app.definitions:
                raise SiddhiAppCreationError(
                    f"{self.name}: partitioned stream '{sid}' is not defined")
            definition = app.definitions[sid]
            self.partitioned_defs[sid] = definition
            compiler = ExpressionCompiler(scope_for_definition(definition,
                                                               sid))
            if isinstance(pt, ValuePartitionType):
                ex = ValuePartitionExecutor(compiler.compile(pt.expression))
            elif isinstance(pt, RangePartitionType):
                ex = RangePartitionExecutor(
                    [(compiler.compile(c), label) for c, label in pt.ranges])
            else:
                raise SiddhiAppCreationError(f"unknown partition type {pt!r}")
            self._executors[sid] = ex

        # query name -> QueryRuntime of the device form (its
        # pattern_processor the dense runtime or the hot-key router, its
        # device_runtime the device query runtime)
        self.dense_query_runtimes: Dict[str, object] = {}
        self.is_dense = False
        if ctx.execution_mode == "tpu":
            try:
                self._plan_dense(partition, app)
                self.is_dense = True
                log.info("%s: lowered to the dense TPU path (%d queries, "
                         "%d key rows)", self.name,
                         len(self.dense_query_runtimes), ctx.tpu_partitions)
            except KernelUnavailableError:
                raise
            except SiddhiAppCreationError as e:
                self.dense_query_runtimes = {}
                # execution('tpu') was asked for and this partition gets
                # per-key host instances: visible, as in the reference
                log.warning("%s: dense TPU path unavailable (%s); using "
                            "per-key instances", self.name, e)

        if not self.is_dense:
            for sid, ex in self._executors.items():
                app.junctions[sid].subscribe(
                    PartitionStreamReceiver(self, sid, ex))
            # an inert template instance, planned now: it creates the
            # output junctions (downstream queries and callbacks bind at
            # build time) and surfaces plan errors at app creation
            PartitionInstance("__template__", partition, app,
                              self.partitioned_defs).close()

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
            app.scheduler.register_task(self)

    def _plan_dense(self, partition: Partition, app):
        """Lower every query of the body to a device engine or raise (the
        caller falls back to per-key instances wholesale: a mixed body
        would split one partition's semantics across two engines)."""
        # every query checked before any is planned
        for q in partition.queries:
            if not isinstance(q, Query):
                raise SiddhiAppCreationError("nested element not a query")
            st = q.input_stream
            out = q.output_stream
            if isinstance(out, InsertIntoStream) and out.is_inner:
                raise SiddhiAppCreationError(
                    "'insert into #inner' needs per-key instances")
            elif (not isinstance(out, (InsertIntoStream, ReturnStream))
                  and out is not None):
                raise SiddhiAppCreationError(
                    "table/window outputs need per-key instances")
            if isinstance(st, StateInputStream):
                for sid in _pattern_stream_ids(st):
                    if sid not in self.partitioned_defs:
                        raise SiddhiAppCreationError(
                            f"pattern input '{sid}' is not a partitioned "
                            "stream")
            elif isinstance(st, SingleInputStream):
                if st.is_inner or st.is_fault:
                    raise SiddhiAppCreationError(
                        "inner/fault stream inputs need per-key instances")
                if st.stream_id not in self.partitioned_defs:
                    raise SiddhiAppCreationError(
                        f"input '{st.stream_id}' is not a partitioned "
                        "stream")
            else:
                raise SiddhiAppCreationError(
                    "join queries inside partitions need per-key instances")

        planned = []
        try:
            for qi, q in enumerate(partition.queries):
                name = self._query_name(q, qi)
                if isinstance(q.input_stream, StateInputStream):
                    qr = plan_dense_state(
                        app, q, name, q.input_stream,
                        n_partitions=app.app_context.tpu_partitions)
                else:
                    engine = device_query_engine(app, q, q.input_stream,
                                                 partition_mode=True)
                    qr = plan_device_single(app, q, name, q.input_stream,
                                            engine, subscribe=False)
                planned.append((name, qr))
        except SiddhiAppCreationError:
            # unregister the lowered siblings' scheduler tasks before the
            # wholesale fallback to per-key instances
            for _n, qr in planned:
                for task in qr.scheduler_tasks:
                    app.scheduler.unregister_task(task)
            raise
        for name, qr in planned:
            self.dense_query_runtimes[name] = qr
        for sid, ex in self._executors.items():
            runtimes = [rt for rt in self._runtimes() if rt.reads(sid)]
            if runtimes:
                app.junctions[sid].subscribe(
                    DensePartitionReceiver(sid, ex, runtimes))

    def _runtimes(self) -> List:
        """Each query's device runtime, in plan order."""
        return [qr.device_processor
                for qr in self.dense_query_runtimes.values()]

    def query_lowering(self) -> Dict[str, str]:
        """Engine placement of every query of the body: the device form
        per query; a per-key instance body is host throughout."""
        if self.is_dense:
            return {n: qr.lowered_to
                    for n, qr in self.dense_query_runtimes.items()}
        return {self._query_name(q, qi): "host"
                for qi, q in enumerate(self.partition.queries)}

    def _query_name(self, q, qi: int) -> str:
        """A body query's name in ``lowering()``: its ``@info(name)``, or
        ``<partition>_q<i>``.  (An unnamed query's instances name it
        ``query_<i>``, as in the reference.)"""
        info = find_annotation(getattr(q, "annotations", []), "info")
        return (info.element("name") if info else None) \
            or f"{self.name}_q{qi}"

    def instance_for(self, key) -> PartitionInstance:
        inst = self.instances.get(key)
        if inst is None:
            inst = PartitionInstance(key, self.partition, self.app,
                                     self.partitioned_defs)
            self.instances[key] = inst
        return inst

    # -- idle-key purge (scheduler task) -------------------------------------

    def next_wakeup(self) -> Optional[int]:
        return self._next_purge

    def on_start(self, now: int):
        if self._purge_interval_ms is not None:
            self._next_purge = now + self._purge_interval_ms

    def fire(self, now: int):
        """Drop the instances of idle keys, or reclaim their rows in
        every device runtime."""
        while self._next_purge is not None and self._next_purge <= now:
            self._next_purge += self._purge_interval_ms
        if self.is_dense:
            for rt in self._runtimes():
                rt.purge_idle(now, self._purge_idle_ms)
            return
        dead = [k for k, inst in self.instances.items()
                if now - inst.last_used >= self._purge_idle_ms]
        for k in dead:
            self.instances.pop(k).close()

    # -- snapshot contract -----------------------------------------------------

    def snapshot(self) -> Dict:
        """Each key's query states (or the device form's, under
        ``__dense__``), in the JAX package's layout."""
        if self.is_dense:
            return {"__dense__": {n: qr.snapshot_state() for n, qr in
                                  self.dense_query_runtimes.items()}}
        return {k: {n: qr.snapshot_state()
                    for n, qr in inst.query_runtimes.items()}
                for k, inst in self.instances.items()}

    def restore(self, state: Dict):
        """Replace every key's state with ``state`` (a ``snapshot``, or
        the JAX package's with each pattern instance in its plain-dict
        form, ``PatternProcessor.restore``)."""
        if self.is_dense:
            for n, qs in state.get("__dense__", {}).items():
                qr = self.dense_query_runtimes.get(n)
                if qr is not None:
                    qr.restore_state(qs)
            return
        for inst in self.instances.values():
            inst.close()
        self.instances.clear()
        now = int(time.time() * 1000)
        for k, qstates in state.items():
            inst = self.instance_for(k)
            # fresh instances must not look idle to the purge task
            inst.last_used = now
            for n, qs in qstates.items():
                qr = inst.query_runtimes.get(n)
                if qr is not None:
                    qr.restore_state(qs)
