"""One running Siddhi app: junctions, planned queries and partitions,
aggregations, callbacks.

Port of the part of the JAX package's ``core/app_runtime.py`` (and the
app planner's wiring) that the ported slices need: stream junctions for
the defined streams, ``insert into`` output streams (``#inner`` ones
too, as in the reference), single-stream queries on the host query
runtime (the reference's default mode) or, under
``@app:execution('tpu')``, on the device query engine, pattern queries
on the host pattern engine or, under ``@app:execution('tpu')``, on the
dense path (outside a partition at one partition), joins (with the
device probe under ``@app:execution('tpu')``), partitions lowered to
the device paths or run on per-key host instances, tables (in-memory,
or ``@store`` record tables over a store extension), named windows
(each a scheduler task with its own junction), triggers, incremental
aggregations subscribed to their input junctions, on-demand queries
(``query()``: FIND over tables, named windows and aggregations, and
table writes), stream and query callbacks,
input handlers, the app scheduler (window ticks, rate limits,
absent-deadline timers, timeBatch panes and ``@purge``) with the
``@app:playback(idle.time, increment)`` idle heartbeat, exception
listeners, ``start``, ``shutdown``, ``lowering()`` and the introspection
of ``get_stream_definitions()``, ``query_names()`` and
``pattern_state()``.  User functions (``define function`` scripts and
``function`` extensions) compile from the app's copy of its manager's
extension registry.  Persistence: ``persist(mode)`` (sync, or async
through the checkpoint writer thread), ``snapshot``/``restore`` of raw
bytes, ``restore_revision``/``restore_last_revision`` (walking back
past a revision that does not restore) with the input journal's replay,
``clear_all_revisions`` and the ``@app:persist(interval)`` daemon
(sources paused around each capture).  ``@source``/``@sink`` transports
start and stop with the runtime (``sources``, ``sinks``);
``@OnError(action='STREAM')`` streams have their ``!name`` fault
junction, read by ``from !S`` and written by ``insert into !S``.
Under ``@app:multiplex`` a query may take a seat in a shared engine
(``lowering()`` gives ``'multiplex'``), which its shutdown frees.

The operations layer: ``statistics()`` and ``set_statistics_level``
(the app's ``StatisticsManager``; the fault, durability and robustness
counters register whatever the level), ``health()`` (``@app:limits``:
admission, breakers, watchdog, ladder), the watchdog and its ladder,
started and stopped with the runtime, ``debug()`` (a
``SiddhiDebugger`` at every query's IN and OUT terminals) and
``replan(pins)``: a live re-plan that rebuilds every engine from a
fresh parse under per-query path pins and replays the input journal's
whole history through the suppressing output ledger, on this same
runtime object.  Under ``@app:plan(auto='true', interval=)`` the plan
monitor (``planner/monitor.py``) starts and stops with the runtime and
calls ``replan`` when the statistics feed shows a cheaper lowering
past the hysteresis margin.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Union

from siddhi_tpu_torch.aggregation.runtime import AggregationRuntime
from siddhi_tpu_torch.compiler.parser import parse_time_string
from siddhi_tpu_torch.core.exceptions import (
    CannotRestoreSiddhiAppStateError,
    DefinitionNotExistError,
    NoPersistenceStoreError,
    OnErrorAction,
    SiddhiAppCreationError,
    SiddhiAppRuntimeError,
)
from siddhi_tpu_torch.core.partition import PartitionRuntime
from siddhi_tpu_torch.core.stream import (
    FunctionQueryCallback,
    FunctionStreamCallback,
    InputHandler,
    QueryCallback,
    StreamCallback,
    StreamJunction,
    notify_listeners,
)
from siddhi_tpu_torch.core.trigger import TriggerRuntime
from siddhi_tpu_torch.core.window import NamedWindowRuntime
from siddhi_tpu_torch.devtable import DeviceTable
from siddhi_tpu_torch.durability.writer import (
    AsyncCheckpointWriter,
    DurabilityStats,
)
from siddhi_tpu_torch.extension.function import build_functions
from siddhi_tpu_torch.extension.validator import validate_extension_args
from siddhi_tpu_torch.planner.app_planner import (
    attach_transports,
    note_fallback,
    note_fused_conflicts,
    plan_app_context,
    transport_config,
)
from siddhi_tpu_torch.planner.fusion import plan_fused_chains
from siddhi_tpu_torch.planner.host_expr import ExpressionCompiler, Scope
from siddhi_tpu_torch.planner.query_planner import plan_query
from siddhi_tpu_torch.query_api import (
    Attribute,
    AttrType,
    Query,
    SingleInputStream,
    StreamDefinition,
)
from siddhi_tpu_torch.query_api.annotation import find_annotation
from siddhi_tpu_torch.table import InMemoryTable, RecordTableRuntime, TableCache
from siddhi_tpu_torch.util.persistence import IncrementalPersistenceStore
from siddhi_tpu_torch.util.snapshot import SnapshotService
from siddhi_tpu_torch.util.statistics import Level

log = logging.getLogger("siddhi_tpu_torch")


# the paths a replan pin may name ('+' joins them), as the reference's
# planner reads them
_PIN_PATHS = frozenset(("host", "device", "dense", "hotkey", "fuse",
                        "multiplex", "shard"))


class SiddhiAppRuntime:
    def __init__(self, siddhi_app, device, siddhi_context, prepare=None,
                 name: Optional[str] = None):
        """``prepare(app_context)`` and ``name``: a live re-plan's, the
        hook run on the planned context before any engine is built
        (pins, the carried robustness state, the shared app lock) and
        the app's name (its input journal is found by it)."""
        self.siddhi_app = siddhi_app
        self.app_context = plan_app_context(siddhi_app, device,
                                            siddhi_context, app_name=name)
        if prepare is not None:
            prepare(self.app_context)
        self.name = self.app_context.name
        self.siddhi_context = siddhi_context
        # a copy of the manager's registry: the built-ins and the user
        # extensions set before this app was created
        self.extensions = siddhi_context.extensions.copy()
        # name -> host function builder: function extensions and
        # ``define function`` scripts
        self.functions = build_functions(self.extensions,
                                         siddhi_app.function_definitions)
        self._running = False
        # (handler manager, element id) of each source, sink and
        # record-table handler, unregistered at shutdown
        self._handler_registrations: List = []
        # the @source and @sink transports of the defined streams
        self.sources: List = []
        self.sinks: List = []
        self.definitions = dict(siddhi_app.stream_definitions)
        self.junctions: Dict[str, StreamJunction] = {}
        for d in list(self.definitions.values()):
            self._define_junction(d)
        self.partitions: Dict[str, PartitionRuntime] = {}
        # unpartitioned queries by name (host queries, dense patterns)
        self.query_runtimes: Dict[str, object] = {}
        self._playback_stop = None
        self._playback_thread = None
        self._persist_stop = None
        self._persist_thread = None
        self._snapshot_svc = None
        self._durab_stats = None
        self._ckpt_writer = None
        self._on_demand_cache: Dict[str, object] = {}
        self.tables: Dict[str, object] = {
            td.id: self._build_table(td)
            for td in siddhi_app.table_definitions.values()}
        self.named_windows: Dict[str, NamedWindowRuntime] = {}
        for wd in siddhi_app.window_definitions.values():
            self.named_windows[wd.id] = self._build_named_window(wd)
        self.trigger_runtimes: Dict[str, TriggerRuntime] = {}
        for td in siddhi_app.trigger_definitions.values():
            # the trigger defines its stream
            tr = TriggerRuntime(td, self.junctions[td.id], self.app_context)
            self.trigger_runtimes[td.id] = tr
            self.scheduler.register_task(tr)
        self.aggregations: Dict[str, AggregationRuntime] = {}
        for ad in siddhi_app.aggregation_definitions.values():
            ar = AggregationRuntime(ad, self)
            self.aggregations[ad.id] = ar
            self.junctions[ad.input_stream.stream_id].subscribe(
                _AggregationReceiver(ar, self.app_context))
        # @app:fuse pre-pass: chains of device queries linked by
        # exclusive `insert into` streams come back planned, keyed by the
        # query's identity; the others plan one by one below
        # (@app:plan(auto=) and a replan pin naming 'fuse' run the pass
        # too)
        ctx = self.app_context
        want_fuse = (ctx.fuse or ctx.plan_auto
                     or any("fuse" in str(p).split("+")
                            for p in ctx.plan_pins.values()))
        fused = plan_fused_chains(self) if want_fuse else {}
        qi = pi = 0  # the reference numbers queries and partitions apart
        for el in siddhi_app.execution_elements:
            if isinstance(el, Query):
                qr = fused.pop(id(el), None)
                if qr is not None:
                    note_fused_conflicts(self.app_context, qr.name)
                else:
                    qr = plan_query(self, el, qi)
                qi += 1
                if qr.name in self.query_runtimes:
                    raise SiddhiAppCreationError(
                        f"duplicate query name '{qr.name}'")
                self.query_runtimes[qr.name] = qr
                continue
            pr = PartitionRuntime(el, self, pi)
            pi += 1
            self.partitions[pr.name] = pr
        # input handlers by stream: a live re-plan re-points them, so a
        # handler the user holds keeps working
        self._input_handlers: Dict[str, InputHandler] = {}
        # (target, callback) as registered, re-attached by a re-plan
        self._user_callbacks: List = []
        self._watchdog = None
        self._ladder = None
        # @app:plan(auto, interval): the plan monitor's sweep
        self._plan_monitor = None
        # set by the manager that registered this runtime, with the app
        # text a re-plan parses afresh
        self._manager = None
        self._app_string = ""
        self._register_trackers()

    def _define_junction(self, d, key: Optional[str] = None
                         ) -> StreamJunction:
        """A defined stream's junction, registered under ``key`` (its id
        by default) with its definition and its transports (reference:
        ``siddhi_tpu/planner/app_planner.py`` ``define_stream``):
        ``@async(buffer.size, batch.size.max)`` makes it asynchronous;
        ``@OnError(action='STREAM')`` defines its fault stream ``!id``
        (the attributes and ``_error``), where failing batches go."""
        key = key or d.id
        if key in self.junctions:
            return self.junctions[key]
        kw = {}
        async_ann = find_annotation(d.annotations, "async")
        if async_ann is not None:
            bs = async_ann.element("buffer.size")
            bm = async_ann.element("batch.size.max")
            kw.update(is_async=True, buffer_size=int(bs) if bs else 1024,
                      batch_size_max=int(bm) if bm else None)
        onerror = find_annotation(d.annotations, "OnError")
        if (onerror is not None
                and (onerror.element("action") or "log").lower() == "stream"):
            fault_def = StreamDefinition(
                id="!" + d.id, attributes=list(d.attributes)
                + [Attribute("_error", AttrType.OBJECT)])
            kw.update(on_error=OnErrorAction.STREAM,
                      fault_junction=self._define_junction(
                          fault_def, key="!" + d.id))
        j = self.junctions[key] = StreamJunction(d, self.app_context, **kw)
        self.definitions[key] = d
        attach_transports(self, d, j)
        return j

    def fault_output_junction(self, target: str, out_def) -> StreamJunction:
        """The junction of ``insert into !target``: the stream's fault
        junction, defined from the query's output when the stream has
        none (reference: ``get_or_create_junction(is_fault=True)``)."""
        j = self.junctions.get("!" + target)
        if j is None:
            j = self._define_junction(
                StreamDefinition(id=target,
                                 attributes=list(out_def.attributes)),
                key="!" + target)
        return j

    # -- tables and named windows --------------------------------------------

    def _build_table(self, td):
        """A ``@store`` table is a record table over its store extension
        (options merged from the config manager's ``ref``, the store's
        config reader, the record-table handler, ``@cache``); under
        ``@app:devtables`` an eligible table is a device table; any other
        table is a columnar in-memory table."""
        store_ann = find_annotation(td.annotations, "store")
        if store_ann is None:
            ctx = self.app_context
            if ctx.devtables:
                try:
                    table = DeviceTable(td, capacity=ctx.devtable_capacity,
                                        device=ctx.device,
                                        faults=ctx.fault_injector,
                                        tracer=ctx.tracer)
                    if ctx.statistics_manager is not None:
                        ctx.statistics_manager.register_devtable(td.id,
                                                                 table)
                    return table
                except SiddhiAppCreationError as e:
                    log.warning(
                        "table '%s': @app:devtables requested but the "
                        "table stays host-resident (%s)", td.id, e)
                    note_fallback(ctx, "devtable", f"table:{td.id}", str(e))
            return InMemoryTable(td)
        cm = self.siddhi_context.config_manager
        stype, opts = transport_config(store_ann, "store", cm)
        factory = self.extensions.lookup("store", stype)
        if factory is None:
            raise SiddhiAppCreationError(
                f"table '{td.id}': unknown store type '{stype}'")
        store = factory()
        store.init(td, opts, cm.generate_config_reader("store", stype))
        handler = None
        rthm = self.siddhi_context.record_table_handler_manager
        if rthm is not None:
            handler = rthm.generate(self.name, td.id)
            self._handler_registrations.append((rthm, handler.element_id))
        cache = None
        cache_ann = store_ann.nested("cache")
        if cache_ann is not None:
            size = int(cache_ann.element("size")
                       or cache_ann.element("max.size") or "50")
            policy = (cache_ann.element("cache.policy")
                      or cache_ann.element("policy") or "FIFO")
            retention = cache_ann.element("retention.period")
            cache = TableCache(
                size, policy,
                retention_ms=parse_time_string(retention) if retention
                else None)
        return RecordTableRuntime(td, store, cache=cache, handler=handler)

    def _build_named_window(self, wd) -> NamedWindowRuntime:
        """The window function over the window's attributes, its own
        junction (which ``from W`` queries read) and a scheduler task."""
        fn = wd.window_function
        if fn is None:
            raise SiddhiAppCreationError(
                f"window '{wd.id}': missing window function")
        factory = self.extensions.lookup("window", fn.name, fn.namespace)
        if factory is None:
            raise SiddhiAppCreationError(
                f"window '{wd.id}': unknown window '{fn.name}()'")
        wscope = Scope()
        for a in wd.attributes:
            wscope.add(wd.id, a.name, a.name, a.type)
        wcompiler = ExpressionCompiler(wscope, self.functions)
        args = [wcompiler.compile(a) for a in fn.args]
        validate_extension_args(factory, fn.name, [a.type for a in args],
                                where=f"named window '{wd.id}'")
        w = factory(args, wd.attribute_names)
        d = StreamDefinition(id=wd.id, attributes=list(wd.attributes))
        self.definitions[wd.id] = d
        junction = self.junctions[wd.id] = StreamJunction(d, self.app_context)
        nwr = NamedWindowRuntime(wd, w, junction, self.app_context)
        self.scheduler.register_task(nwr)
        return nwr

    def table_resolver(self, table_name: str, obj: bool = False):
        """The membership test of ``expr in Table`` (``obj=True``: the
        table itself, for the condition form)."""
        table = self.tables.get(table_name)
        if table is None:
            raise SiddhiAppCreationError(
                f"'IN {table_name}': table is not defined")
        return table if obj else table.contains_fn()

    # -- planning hooks ------------------------------------------------------

    @staticmethod
    def _input_key(s: SingleInputStream) -> str:
        """An ``#inner`` stream outside a partition is the app's own
        junction ``#<id>``, once a query inserts into it; a fault stream
        is ``!<id>`` (reference)."""
        return ("#" if s.is_inner else "!" if s.is_fault else "") \
            + s.stream_id

    def resolve_stream_definition(self, s):
        if not isinstance(s, SingleInputStream):
            raise SiddhiAppCreationError(
                f"cannot resolve definition for {s!r}")
        key = self._input_key(s)
        d = self.definitions.get(key)
        if d is None:
            raise DefinitionNotExistError(
                f"stream '{key}' is not defined in app '{self.name}'")
        return d

    def junction_for_input(self, s: SingleInputStream) -> StreamJunction:
        self.resolve_stream_definition(s)
        return self.junctions[self._input_key(s)]

    def output_junction(self, out_def, is_inner: bool = False
                        ) -> StreamJunction:
        """The junction of an ``insert into`` target, defined from the
        query's output when the app does not define the stream
        (``is_inner``: keyed ``#<id>``).  An existing junction is shared
        as it is, as in the reference: each batch carries its own
        attribute names to the callbacks."""
        key = ("#" if is_inner else "") + out_def.id
        j = self.junctions.get(key)
        if j is None:
            self.definitions[key] = out_def
            j = self.junctions[key] = StreamJunction(out_def,
                                                     self.app_context)
        return j

    # -- lifecycle -----------------------------------------------------------

    def _all_query_runtimes(self) -> Dict[str, object]:
        """Query name -> its runtime, the partitions' device-lowered
        queries included (a per-key instance body has one runtime a
        key, in ``partition.instances``)."""
        out = dict(self.query_runtimes)
        for pr in self.partitions.values():
            out.update(pr.dense_query_runtimes)
        return out

    def pattern_runtimes(self) -> Dict[str, object]:
        """Query name -> its dense pattern processor (a
        DensePatternRuntime or the HotKeyRouterRuntime around one)."""
        return {n: qr.pattern_processor
                for n, qr in self._all_query_runtimes().items()
                if qr.pattern_processor is not None
                and qr.device_processor is not None}

    def get_stream_definitions(self):
        return self.siddhi_app.stream_definitions

    def query_names(self) -> List[str]:
        return list(self.query_runtimes)

    def pattern_state(self) -> Dict[str, Dict]:
        """Engine state of every pattern or sequence query, under the app
        lock: a dense runtime's or the router's ``stats()`` (partition
        and lane occupancy, overflow; a barrier first), the host engine's
        live instances; a partition's device-lowered queries too
        (reference: SiddhiAppRuntime.pattern_state)."""
        with self.app_context.process_lock:
            out: Dict[str, Dict] = {}
            for name, qr in self._all_query_runtimes().items():
                pp = getattr(qr, "pattern_processor", None)
                if pp is not None and hasattr(pp, "stats"):
                    out[name] = pp.stats()
            return out

    @property
    def scheduler(self):
        return self.app_context.scheduler

    def start(self):
        if self._running:
            return
        for j in self.junctions.values():
            j.start()
        self.scheduler.start()
        for t in self.tables.values():
            if hasattr(t, "start"):
                t.start()  # record tables connect their stores
        # sinks connect before sources, so output paths exist when events
        # flow; the running gate opens first, since a source may deliver
        # on its transport thread the instant it subscribes.  A failing
        # transport start closes the gate again.
        self._running = True
        try:
            for s in self.sinks:
                s.start()
            for s in self.sources:
                s.start()
        except Exception as e:
            log.error("app '%s': transport start failed, rolling back the "
                      "running gate: %s", self.name, e)
            self._running = False
            for s in list(self.sources) + list(self.sinks):
                try:
                    s.shutdown()
                except Exception:
                    log.exception("transport shutdown after a failed "
                                  "start")
            raise
        ctx = self.app_context
        ctx.app_running = True
        sm = ctx.statistics_manager
        if sm is not None and Level.at_least(ctx.root_metrics_level,
                                             Level.BASIC):
            sm.start_reporting()
        if ctx.playback and ctx.playback_idle_ms > 0:
            self._start_playback_heartbeat()
        if ctx.persist_interval_ms > 0:
            self._start_persist_daemon()
        if (ctx.plan_auto and ctx.plan_interval_ms > 0
                and self._plan_monitor is None):
            from siddhi_tpu_torch.planner.monitor import PlanMonitor

            # @app:plan(auto, interval): re-scores the plan with what the
            # statistics feed observed and re-plans past the hysteresis
            # margin
            self._plan_monitor = PlanMonitor(self)
            self._plan_monitor.start()
        if ctx.watchdog_deadline_ms > 0 and self._watchdog is None:
            from siddhi_tpu_torch.robustness import (
                DegradationLadder,
                Watchdog,
            )

            # @app:limits(watchdog=, ladder=): the stall detector and its
            # self-heal, optionally driving the ladder; a re-plan
            # restarts both here with the carried counters
            rb = ctx.robustness
            self._ladder = (DegradationLadder(self, rb) if ctx.ladder
                            else None)
            self._watchdog = Watchdog(self, rb, ctx.watchdog_deadline_ms,
                                      ladder=self._ladder)
            self._watchdog.start()

    def _start_playback_heartbeat(self):
        """``@app:playback(idle.time, increment)``: when no event arrives
        for ``idle.time``, advance event time by ``increment`` and the
        scheduler with it, under the app lock."""
        ctx = self.app_context
        idle_s = ctx.playback_idle_ms / 1000.0
        tg = ctx.timestamp_generator
        stop = threading.Event()

        def loop():
            while not stop.wait(idle_s):
                if time.monotonic() - tg.last_update_wall >= idle_s:
                    with ctx.process_lock:
                        if stop.is_set():
                            return
                        self.scheduler.advance(tg.advance_idle())

        self._playback_stop = stop
        self._playback_thread = threading.Thread(
            target=loop, name=f"playback-{self.name}", daemon=True)
        self._playback_thread.start()

    def _start_persist_daemon(self):
        """``@app:persist(interval, mode)``: a ``persist()`` every
        interval, in the annotation's mode (async by default, so the
        batch loop only stalls for the in-barrier capture)."""
        interval_s = self.app_context.persist_interval_ms / 1000.0
        stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                try:
                    self.persist()
                except Exception as e:
                    log.error("app '%s': periodic persist failed: %s",
                              self.name, e)
                    notify_listeners(self.app_context, e)
                except BaseException as e:
                    # a simulated crash on the daemon thread: stop ticking
                    log.error("app '%s': persist daemon stopped: %s",
                              self.name, e)
                    break

        self._persist_stop = stop
        self._persist_thread = threading.Thread(
            target=loop, name=f"persist-{self.name}", daemon=True)
        self._persist_thread.start()

    def device_runtimes(self) -> Dict[str, object]:
        """Query name -> its device runtime: the pattern processor or the
        device query runtime."""
        return {n: qr.device_processor
                for n, qr in self._all_query_runtimes().items()
                if qr.device_processor is not None}

    def drain(self):
        """Emit every output still pending on the device, in the order
        the synchronous path would, before host code reads state (a pull
        query, shutdown): the device runtimes first, then any table with
        a barrier of its own, since a drained emit may write a table."""
        for rt in self.device_runtimes().values():
            rt.drain()
        for t in self.tables.values():
            if hasattr(t, "drain"):
                t.drain()

    # the reference's name
    drain_device_emits = drain

    def shutdown(self):
        self._teardown(replan=False)
        if self._manager is not None \
                and self._manager.runtimes.get(self.name) is self:
            # identity-guarded: a replaced runtime leaves its successor
            self._manager.runtimes.pop(self.name, None)

    def _teardown(self, replan: bool):
        """Stop everything; ``replan=True`` (a live re-plan, under the
        app lock) joins no thread and drops what async junctions hold,
        since the journal replays it into the replacement."""
        # the watchdog first: a daemon that can force a re-plan must not
        # race a teardown
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = self._ladder = None
        if self._plan_monitor is not None:
            self._plan_monitor.stop()
            self._plan_monitor = None
        wait = not replan
        for stop_attr, thread_attr, timeout in (
                ("_playback_stop", "_playback_thread", 2),
                ("_persist_stop", "_persist_thread", 10)):
            stop = getattr(self, stop_attr)
            if stop is not None:
                stop.set()
                if wait:
                    getattr(self, thread_attr).join(timeout=timeout)
                setattr(self, stop_attr, None)
                setattr(self, thread_attr, None)
        if self._ckpt_writer is not None:
            self._ckpt_writer.shutdown()
        sm = self.app_context.statistics_manager
        if sm is not None:
            sm.stop_reporting()
        for s in self.sources:
            s.shutdown()
        # the async workers stop (dispatching what they hold) before the
        # device runtimes drain, so every accepted batch reaches them
        for j in list(self.junctions.values()):
            if replan:
                j.abandon()
            else:
                j.stop()
        self.scheduler.stop(wait=wait)
        # the device runtimes' last emits reach the sinks before these
        # disconnect; a multiplexed query frees its seat here
        for rt in self.device_runtimes().values():
            rt.close()
        for s in self.sinks:
            s.shutdown()
        for ar in self.aggregations.values():
            ar.close()
        for t in self.tables.values():
            if hasattr(t, "shutdown"):
                t.shutdown()  # record tables disconnect their stores
        for mgr, element_id in self._handler_registrations:
            mgr.unregister(element_id)
        self._handler_registrations = []
        self._running = False
        self.app_context.app_running = False

    # -- operations: statistics, health, debugger ----------------------------

    def _register_trackers(self):
        """The statistics manager's trackers at the app's level, and the
        fault and robustness counters whatever the level: their evidence
        stays visible with statistics off."""
        ctx = self.app_context
        sm = ctx.statistics_manager
        if sm is None:
            return
        self._apply_statistics_level(ctx.root_metrics_level)
        if ctx.fault_injector is not None:
            sm.fault_tracker("injector", ctx.fault_injector.stats)
        if ctx.robustness is not None:
            sm.robustness_tracker("overload", ctx.robustness)

    def _apply_statistics_level(self, level: str):
        """(Un)install the throughput, latency, transfer, ingest and
        buffer trackers to match ``level``."""
        sm = self.app_context.statistics_manager
        if sm is None:
            return
        self.app_context.root_metrics_level = level
        basic = Level.at_least(level, Level.BASIC)
        detail = Level.at_least(level, Level.DETAIL)
        if not basic:
            # a downgrade drops the trackers, so statistics() stops
            # reporting stale metrics
            for reg in (sm.throughput, sm.latency, sm.lowering,
                        sm.transfers, sm.ingests):
                reg.clear()
        else:
            sm.lowering.update(self.lowering())
            for name, qr in self._all_query_runtimes().items():
                rt = qr.device_processor
                if rt is None:
                    continue
                if getattr(rt, "emit_stats", None) is not None:
                    sm.transfer_tracker(name, rt.emit_stats)
                if getattr(rt, "ingest_stats", None) is not None:
                    sm.ingest_tracker(name, rt.ingest_stats)
        if not detail:
            sm.buffers.clear()
        for j in self.junctions.values():
            j.throughput_tracker = (sm.throughput_tracker(j.stream_id)
                                    if basic else None)
        for qname, qr in self.query_runtimes.items():
            if hasattr(qr, "latency_tracker"):
                qr.latency_tracker = (sm.latency_tracker(qname) if basic
                                      else None)
        if detail:
            for j in self.junctions.values():
                if j.is_async:
                    sm.buffer_tracker(j.stream_id, j)

    def set_statistics_level(self, level: str):
        """Switch the metrics level (``'off'``, ``'basic'``,
        ``'detail'``) at run time."""
        self._apply_statistics_level(level)
        sm = self.app_context.statistics_manager
        if sm is not None and self._running:
            if Level.at_least(level, Level.BASIC):
                sm.start_reporting()
            else:
                sm.stop_reporting()

    def statistics(self) -> Dict[str, object]:
        """Metric name -> value, under the reference's names
        (``io.siddhi.SiddhiApps.<app>.Siddhi.<kind>.<name>.<metric>``)."""
        sm = self.app_context.statistics_manager
        return sm.stats() if sm is not None else {}

    def _pending_work(self) -> int:
        """Accepted but undelivered work: batches queued in async
        junctions, staged ingest windows and deferred emits (the
        watchdog tells a stall from idleness by it)."""
        n = sum(j.pending() for j in self.junctions.values())
        for rt in self.device_runtimes().values():
            for attr in ("emit_queue", "ingest_stage"):
                q = getattr(rt, attr, None)
                if q is not None:
                    n += len(q)
        return n

    def _queue_fill(self) -> float:
        """The fullest async junction's fill fraction (the ladder's
        pressure signal)."""
        return max((j.fill() for j in self.junctions.values()),
                   default=0.0)

    def health(self) -> Dict:
        """Overload-protection health (``GET /siddhi-health``): healthy
        when running, not shedding, no breaker open and not wedged.  The
        counters are the live ``RobustnessStats`` the statistics feed
        reads; no lock is taken, so a wedged app still answers."""
        ctx = self.app_context
        ac, rb = ctx.admission, ctx.robustness
        wd, ld = self._watchdog, self._ladder
        breakers = []
        for s in list(self.sinks) + list(self.sources):
            for t in [s] + list(getattr(s, "children", None) or []):
                b = getattr(t, "_breaker", None)
                if b is not None:
                    breakers.append(b.describe())
        shedding = ac.shedding_now() if ac is not None else False
        wedged = wd.wedged if wd is not None else False
        healthy = (self._running and not shedding and not wedged
                   and not any(b["state"] == "open" for b in breakers))
        return {
            "app": self.name,
            "healthy": healthy,
            "running": self._running,
            "shedding": shedding,
            "wedged": wedged,
            "degrade_level": ctx.degrade_level,
            "admission": ac.snapshot() if ac is not None else None,
            "breakers": breakers,
            "watchdog": wd.describe() if wd is not None else None,
            "ladder": ld.describe() if ld is not None else None,
            "counters": rb.as_dict() if rb is not None else {},
        }

    def debug(self):
        """Start in debug mode: a ``SiddhiDebugger`` at every query's IN
        and OUT terminals.  Every emit is observed at its own batch: the
        device runtimes drain after each step and stage synchronously."""
        from siddhi_tpu_torch.debugger import SiddhiDebugger

        debugger = SiddhiDebugger(self)
        for qr in self.query_runtimes.values():
            qr.debugger = debugger
        for rt in self.device_runtimes().values():
            eq = getattr(rt, "emit_queue", None)
            if eq is not None:
                eq.depth = 1
                eq.controller = None
            stage = getattr(rt, "ingest_stage", None)
            if stage is not None:
                stage.flush()
                stage.depth = 1
                stage.controller = None
        self.start()
        return debugger

    # -- live re-plan --------------------------------------------------------

    def replan(self, pins: Optional[Dict[str, str]] = None,
               forced: bool = True, reason: str = "") -> Dict[str, str]:
        """Re-lower the running app under per-query path pins
        (``{'q1': 'fuse'}``, ``{'q': 'dense+hotkey'}``, ``'host'``),
        bit-exact across the switch; returns the new lowering.

        Under the app lock: pause the sources, drain, check that the
        input journal still holds the whole history, build a complete
        replacement from a fresh parse with ``pins`` (sharing this app's
        lock and its robustness state), cross the ``replan.reseat``
        crash point (a kill there abandons the replacement and leaves
        the old engines running), tear the old engines down, adopt the
        new ones onto this runtime object (input handlers the user
        holds are re-pointed, callbacks re-attached), start, and replay
        the journal's whole history with the output ledger suppressing
        what each callback and sink already received.  Refused, and
        counted as a planner fallback, without ``@app:faults(journal=)``
        or once the journal no longer covers the history.  A pin naming
        ``shard`` shards the query over the app's declared mesh
        (``@app:execution(devices=)``)."""
        ctx = self.app_context
        sm = ctx.statistics_manager
        pins = dict(pins or {})

        def refuse(why: str):
            if sm is not None:
                sm.record_planner_fallback(self.name,
                                           f"replan refused: {why}")
            log.warning("app '%s': replan refused (%s)", self.name, why)
            raise SiddhiAppRuntimeError(
                f"app '{self.name}': replan refused — {why}")

        for q, p in pins.items():
            comps = str(p).split("+")
            bad = sorted(set(comps) - _PIN_PATHS)
            if bad:
                refuse(f"pin {q}={p!r} names unknown path(s) {bad}")
        if not self._running:
            refuse("app is not running")
        jr = ctx.input_journal
        if jr is None:
            refuse("no input journal — @app:faults(journal='N') is the "
                   "replay substrate a live re-plan rebuilds state from")
        with ctx.process_lock:
            old_sources = list(self.sources)
            for s in old_sources:
                s.pause()
            committed = False
            try:
                self.drain()
                self._flush_persists()
                if not jr.covers_from_start():
                    refuse("journal no longer holds the full input "
                           "history (overflowed or spilled); raise the "
                           "journal depth to re-plan live")
                old_lowering = self.lowering()
                entries = jr.all_entries()
                new_rt = self._build_replacement(pins)
                self._adopt(new_rt, sm)
                committed = True
                # rebuild every engine's state from the whole journaled
                # history through the suppressing output ledger
                self.start()
                jr.begin_replay_from_start()
                try:
                    for stream_id, batch in entries:
                        self.get_input_handler(stream_id).send_batch(batch)
                        jr.stats.replayed_batches += 1
                    # the barrier inside the replay window: deferred
                    # emits go through the ledger, not out as duplicates
                    self.drain()
                finally:
                    jr.end_replay()
                new_lowering = self.lowering()
                rsm = self.app_context.statistics_manager
                changed = False
                for q, p in sorted(new_lowering.items()):
                    o = old_lowering.get(q, "")
                    if o != p:
                        changed = True
                        rsm.record_replan(q, o, p, forced, reason)
                if not changed:
                    rsm.record_replan("*", "", "", forced,
                                      reason or "no lowering change")
                log.info("app '%s': re-planned (%s); lowering now %s",
                         self.name, reason or "forced", new_lowering)
                return new_lowering
            finally:
                if not committed:
                    for s in old_sources:
                        s.resume()

    def _build_replacement(self, pins: Dict[str, str]) -> "SiddhiAppRuntime":
        """The replacement engine set, built before the old one is torn
        down (two engine sets live for a moment), then the
        ``replan.reseat`` crash point."""
        from siddhi_tpu_torch.compiler import SiddhiCompiler
        from siddhi_tpu_torch.robustness import apply_degradation

        ctx = self.app_context
        jr = ctx.input_journal
        ast = (SiddhiCompiler.parse(
                   SiddhiCompiler.update_variables(self._app_string))
               if self._app_string else copy.deepcopy(self.siddhi_app))

        def prepare(nctx):
            nctx.plan_pins = dict(pins)
            # one lock serializes both incarnations (async junctions
            # build their conditions over it)
            nctx.process_lock = ctx.process_lock
            # the counters, bucket levels and the ladder's rung survive
            # a self-heal, as the journal does
            if ctx.robustness is not None and nctx.robustness is not None:
                nctx.robustness = ctx.robustness
                if ctx.admission is not None:
                    ctx.admission.app_context = nctx
                    ctx.admission.stats = ctx.robustness
                    nctx.admission = ctx.admission
            if ctx.degrade_level:
                nctx.degrade_level = ctx.degrade_level
                # what the rung turned off: the rebuilt ladder keeps it
                # on its list, so it can re-promote
                nctx.degraded_features = tuple(
                    apply_degradation(nctx, ctx.degrade_level))

        # the planner re-binds the journal's counters and spill sink to
        # the new context: restored if the replacement is abandoned
        saved = (jr.stats, jr.spill_sink)
        ac_ctx = ctx.admission.app_context if ctx.admission else None
        try:
            new_rt = SiddhiAppRuntime(ast, ctx.device, self.siddhi_context,
                                      prepare=prepare, name=self.name)
        except BaseException:
            jr.stats, jr.spill_sink = saved
            if ctx.admission is not None:
                ctx.admission.app_context = ac_ctx
            raise
        try:
            if ctx.fault_injector is not None:
                # crash point: replacement built, old engines live
                ctx.fault_injector.check("replan.reseat")
        except BaseException:
            jr.stats, jr.spill_sink = saved
            if ctx.admission is not None:
                ctx.admission.app_context = ac_ctx
            try:
                new_rt._teardown(replan=False)
            except Exception:
                log.warning("replan: the abandoned replacement did not "
                            "tear down cleanly", exc_info=True)
            raise
        return new_rt

    def _adopt(self, new_rt: "SiddhiAppRuntime", old_sm):
        """The point of no return: tear the old engines down and take
        the replacement's internals onto this runtime object."""
        new_ctx = new_rt.app_context
        if old_sm is not None and new_ctx.statistics_manager is not None:
            # the app-wide re-plan history survives the switch
            new_ctx.statistics_manager.replans.extend(old_sm.replans)
        self._teardown(replan=True)
        for attr in ("siddhi_app", "app_context", "extensions", "functions",
                     "sources", "sinks", "definitions", "junctions",
                     "partitions", "query_runtimes", "tables",
                     "named_windows", "trigger_runtimes", "aggregations",
                     "_handler_registrations"):
            setattr(self, attr, getattr(new_rt, attr))
        self._on_demand_cache = {}
        self._snapshot_svc = None
        self._durab_stats = None
        self._ckpt_writer = None
        for src in self.sources:
            src.is_running = lambda: self._running
        # handlers the user holds keep working, on the new junctions
        for sid, h in list(self._input_handlers.items()):
            nj = self.junctions.get(sid)
            if nj is None:
                self._input_handlers.pop(sid)
                continue
            h.junction = nj
            h.app_context = new_ctx
            h.definition = nj.definition
        cbs, self._user_callbacks = self._user_callbacks, []
        for target, cb in cbs:
            self.add_callback(target, cb)

    # -- on-demand (pull) queries --------------------------------------------

    def query(self, on_demand_query: str):
        """Run a pull query (a FIND over a table, a named window or an
        aggregation, or a table write) and return its events (reference:
        SiddhiAppRuntimeImpl.query:304, cache of 50)."""
        from siddhi_tpu_torch.compiler import SiddhiCompiler
        from siddhi_tpu_torch.core.on_demand import OnDemandQueryRuntime

        # barrier: emits still pending on the device may feed the
        # table, window or aggregation this reads
        self.drain()
        rt = self._on_demand_cache.get(on_demand_query)
        if rt is None:
            odq = SiddhiCompiler.parse_on_demand_query(on_demand_query)
            rt = OnDemandQueryRuntime(odq, self)
            if len(self._on_demand_cache) >= 50:
                self._on_demand_cache.pop(next(iter(self._on_demand_cache)))
            self._on_demand_cache[on_demand_query] = rt
        return rt.execute()

    # -- persistence ---------------------------------------------------------

    def _snapshot_service(self) -> SnapshotService:
        # cached: incremental mode tracks per-element digests across
        # persists
        if self._snapshot_svc is None:
            self._snapshot_svc = SnapshotService(self)
        return self._snapshot_svc

    def _persistence_store(self):
        store = self.siddhi_context.persistence_store
        if store is None:
            raise NoPersistenceStoreError(
                f"app '{self.name}': no persistence store configured "
                "(SiddhiManager.set_persistence_store)")
        return store

    def _durability_stats(self) -> DurabilityStats:
        if self._durab_stats is None:
            self._durab_stats = DurabilityStats()
            sm = self.app_context.statistics_manager
            if sm is not None:
                # registered whatever the level, as the fault counters
                sm.durability_tracker(self.name, self._durab_stats)
        return self._durab_stats

    def _durability_writer(self, create: bool = True
                           ) -> Optional[AsyncCheckpointWriter]:
        if self._ckpt_writer is None and create:
            self._ckpt_writer = AsyncCheckpointWriter(
                self.name, stats=self._durability_stats(),
                fault_injector=self.app_context.fault_injector,
                listeners=self.app_context.exception_listeners,
                tracer=self.app_context.tracer)
        return self._ckpt_writer

    def _flush_persists(self, timeout: float = 30.0):
        """Barrier: an in-flight async checkpoint reaches a terminal
        state before host code reads or replaces persisted state."""
        w = self._durability_writer(create=False)
        if w is not None:
            w.wait(timeout=timeout)

    def wait_for_persist(self, revision: Optional[str] = None,
                         timeout: Optional[float] = None) -> Optional[str]:
        """Block until an async persist finishes.  Returns the terminal
        status ('committed' / 'failed' / 'superseded' / 'crashed' /
        'idle') or None on timeout; 'idle' when nothing was submitted."""
        w = self._durability_writer(create=False)
        if w is None:
            return "idle"
        return w.wait(revision=revision, timeout=timeout)

    def _persist_write(self, store, revision: str, capture):
        """Serialize, store and commit one captured checkpoint: on the
        checkpoint writer thread (async) or inline (sync)."""
        fi = self.app_context.fault_injector
        st = self._durability_stats()
        if hasattr(store, "save_tree"):
            blobs = capture.materialize_blobs()
            store.save_tree(self.name, revision, blobs,
                            checker=fi.check if fi is not None else None,
                            version=capture.version)
            st.blobs_written += len(blobs)
            st.bytes_written += sum(len(b) for _, _, b in blobs)
        else:
            data = capture.tree_bytes()
            store.save(self.name, revision, data)
            st.bytes_written += len(data)
        if fi is not None:
            # crash point: revision durable, journal mark not committed
            fi.check("persist.post_manifest")
        jr = self.app_context.input_journal
        if jr is not None:
            jr.commit_revision(revision)

    @contextlib.contextmanager
    def _sources_paused(self):
        """External input held around a capture: each source buffers
        what arrives and replays it, in order, on resume."""
        for s in self.sources:
            s.pause()
        try:
            yield
        finally:
            for s in self.sources:
                s.resume()

    def persist(self, mode: Optional[str] = None) -> str:
        """Snapshot all state and save it under a new revision
        (reference: SiddhiAppRuntimeImpl.persist:677); returns the
        revision id.

        ``mode='sync'`` (the default) writes inside the call;
        ``mode='async'`` (or ``@app:persist(mode='async')``) stalls the
        batch loop only for the in-barrier capture (device clones of the
        state tensors, host copies) and hands the device-to-host fetch,
        serialization and store write to the checkpoint writer thread,
        single in flight with coalescing.  An incremental store forces
        the sync path (its digest chain cannot interleave with
        background writes)."""
        store = self._persistence_store()
        svc = self._snapshot_service()
        if mode is None:
            mode = self.app_context.persist_mode
        if mode not in ("sync", "async"):
            raise SiddhiAppRuntimeError(
                f"app '{self.name}': persist mode {mode!r} must be "
                "'sync' or 'async'")
        st = self._durability_stats()
        incremental = isinstance(store, IncrementalPersistenceStore)
        if incremental:
            if mode == "async" and self.app_context.statistics_manager:
                self.app_context.statistics_manager.record_persist_fallback(
                    self.name, "incremental-store-sync-only")
            mode = "sync"
        revision = SnapshotService.new_revision(self.name)
        jr = self.app_context.input_journal
        if incremental:
            with self._sources_paused(), self.app_context.process_lock:
                self.drain()
                kind, data = svc.incremental_snapshot()
            store.save(self.name, revision, kind, data)
            st.persists_sync += 1
            if jr is not None:
                jr.mark_revision(revision)
            return revision

        sm = self.app_context.statistics_manager

        def on_fallback(element, reason):
            st.capture_fallback_elements += 1
            if sm is not None:
                sm.record_persist_fallback(f"{self.name}.{element}", reason)

        # the barrier: the sources paused (reference:
        # SiddhiAppRuntimeImpl.persist:677-691), the app lock, and every
        # emit still pending on the device lands in downstream state
        # (selectors, windows, tables) before that state is captured
        tracer = self.app_context.tracer
        with self._sources_paused(), self.app_context.process_lock:
            self.drain()
            t_cap = tracer.clock() if tracer is not None else 0.0
            capture = svc.capture(on_fallback=on_fallback)
            if tracer is not None:
                # the in-barrier capture is the stall the batch loop
                # feels: a span like a pipeline stage's
                tracer.record_span("persist.capture", "persist", t_cap,
                                   tracer.clock())
            if jr is not None:
                # the watermark and ledger counts at the capture point;
                # the prune happens at commit, after the store write
                jr.note_capture(revision)
        if mode == "async":
            self._durability_writer().submit(
                revision,
                lambda: self._persist_write(store, revision, capture),
                on_abandon=jr.drop_mark if jr is not None else None)
            return revision
        fi = self.app_context.fault_injector
        try:
            if fi is not None:
                fi.check("persist.write")
            self._persist_write(store, revision, capture)
        except Exception:
            # a failed sync persist abandons its journal mark, so a later
            # commit cannot prune uncovered entries.  A simulated crash
            # (BaseException) keeps it: the journal models a log that
            # survives the process, marks included.
            if jr is not None:
                jr.drop_mark(revision)
            raise
        st.persists_sync += 1
        return revision

    def snapshot(self) -> bytes:
        """Raw snapshot bytes without a store (reference:
        SiddhiAppRuntimeImpl.snapshot)."""
        with self.app_context.process_lock:
            self.drain()
            return self._snapshot_service().full_snapshot()

    def restore(self, snapshot: bytes):
        """Restore raw snapshot bytes; the input journal forgets its
        marks and ledger, which no longer match the restored state."""
        self._flush_persists()
        with self.app_context.process_lock:
            # pending emits flush into the PRE-restore state (the
            # synchronous path delivered them before restore was called)
            self.drain()
            self._snapshot_service().restore(snapshot)
        jr = self.app_context.input_journal
        if jr is not None:
            jr.reset()

    def _replay_journal(self, revision: str):
        """Restore-and-replay, second half: re-send every input batch the
        journal recorded after ``revision`` was captured, with the output
        ledger suppressing the events each callback already received —
        the observable sequence equals an uninterrupted run's
        (util/faults.py InputJournal).  Single-threaded, under the app
        lock, and not journaled again."""
        jr = self.app_context.input_journal
        if jr is None:
            return
        entries = jr.entries_after(revision)
        if entries is None:
            log.warning(
                "app '%s': input journal cannot replay after revision "
                "'%s' (unmarked revision or journal overflow); restored "
                "state only — post-checkpoint input is lost", self.name,
                revision)
            jr.reset()
            return
        if not self._running:
            if entries:
                log.warning(
                    "app '%s': %d journaled batch(es) pending but the "
                    "app is not running; start() it before restoring to "
                    "replay", self.name, len(entries))
            return
        with self.app_context.process_lock:
            jr.begin_replay(revision)
            try:
                for stream_id, batch in entries:
                    self.get_input_handler(stream_id).send_batch(batch)
                    jr.stats.replayed_batches += 1
                # barrier INSIDE the replay window: emits the replayed
                # batches left pending on the device go through the
                # suppressing ledger, not after it as duplicates
                self.drain()
            finally:
                jr.end_replay()
        if entries:
            log.info("app '%s': replayed %d journaled batch(es) after "
                     "revision '%s'", self.name, len(entries), revision)

    def restore_revision(self, revision: str):
        """Restore ``revision`` of the store, then replay the input
        journal after it."""
        self._flush_persists()
        store = self._persistence_store()
        if isinstance(store, IncrementalPersistenceStore):
            chain = store.load_chain(self.name, until_revision=revision)
            if chain is None:
                raise SiddhiAppRuntimeError(
                    f"app '{self.name}': no base snapshot at or before "
                    f"revision '{revision}'")
            _, base_bytes, incs = chain
            with self.app_context.process_lock:
                self.drain()
                self._snapshot_service().restore_incremental(
                    base_bytes, [b for _, b in incs])
            self._replay_journal(revision)
            return
        data = store.load(self.name, revision)
        if data is None:
            raise SiddhiAppRuntimeError(
                f"app '{self.name}': revision '{revision}' not found")
        # inline (not self.restore): the journal must survive the state
        # restore so the post-checkpoint batches can replay after it
        with self.app_context.process_lock:
            self.drain()
            self._snapshot_service().restore(data)
        self._replay_journal(revision)

    def restore_last_revision(self) -> Optional[str]:
        """Restore the newest saved revision and return its id (None when
        there is none; reference: SiddhiAppRuntimeImpl.restoreLastRevision).
        An incremental store restores its newest base and the increments
        after it.  A revision that does not restore (missing, truncated,
        failing its checksum) is skipped with a WARNING and the walk
        falls back to the one before; when none restores,
        ``CannotRestoreSiddhiAppStateError``."""
        # the post-mortem: the span ring before the state is replaced
        if self.app_context.tracer is not None:
            self.app_context.tracer.dump("crash-restore")
        self._flush_persists()
        store = self._persistence_store()
        if isinstance(store, IncrementalPersistenceStore):
            chain = store.load_chain(self.name)
            if chain is None:
                return None
            base_rev, base_bytes, incs = chain
            with self.app_context.process_lock:
                self.drain()
                self._snapshot_service().restore_incremental(
                    base_bytes, [b for _, b in incs])
            rev = incs[-1][0] if incs else base_rev
            self._replay_journal(rev)
            return rev
        revs = store.revisions(self.name)
        if not revs:
            return None
        last_error = None
        for rev in reversed(revs):
            try:
                self.restore_revision(rev)
                return rev
            except Exception as e:
                last_error = e
                log.warning(
                    "app '%s': revision '%s' failed to restore (%s); "
                    "falling back to the previous revision", self.name,
                    rev, e)
        raise CannotRestoreSiddhiAppStateError(
            f"app '{self.name}': all {len(revs)} persisted revisions "
            f"failed to restore (last error: {last_error})")

    def clear_all_revisions(self):
        self._flush_persists()
        self._persistence_store().clear_all_revisions(self.name)

    # Java-style aliases
    restoreRevision = restore_revision
    restoreLastRevision = restore_last_revision
    clearAllRevisions = clear_all_revisions

    # -- I/O -----------------------------------------------------------------

    def get_input_handler(self, stream_id: str) -> InputHandler:
        # a named window is fed by queries only, as in the reference
        j = (self.junctions.get(stream_id)
             if stream_id not in self.named_windows else None)
        if j is None:
            raise DefinitionNotExistError(
                f"stream '{stream_id}' is not defined in app '{self.name}'")
        h = self._input_handlers.get(stream_id)
        if h is None:
            h = self._input_handlers[stream_id] = InputHandler(
                j, self.app_context, lambda: self._running)
        return h

    def add_callback(self, target: str,
                     callback: Union[StreamCallback, QueryCallback,
                                     Callable]):
        """A callback on a stream (a ``StreamCallback``, or a function
        taking the list of events) or on an unpartitioned query by name
        (a ``QueryCallback``, or a function taking ``(timestamp,
        in_events, out_events)``)."""
        if target in self.junctions:
            if not isinstance(callback, StreamCallback):
                callback = FunctionStreamCallback(callback)
            self.junctions[target].add_callback(callback)
            self._user_callbacks.append((target, callback))
            return
        if target in self.query_runtimes:
            if not isinstance(callback, QueryCallback):
                callback = FunctionQueryCallback(callback)
            self.query_runtimes[target].add_callback(callback)
            self._user_callbacks.append((target, callback))
            return
        raise SiddhiAppRuntimeError(
            f"no stream or query named '{target}' in app '{self.name}'")

    def add_exception_listener(self, listener: Callable):
        """Register a listener called with every error the app logs
        instead of raising: a failing query or callback on a junction,
        a failing scheduler task (reference:
        SiddhiAppRuntimeImpl.handleRuntimeExceptionWith)."""
        self.app_context.exception_listeners.append(listener)

    # the reference's Java-style name
    handleRuntimeExceptionWith = add_exception_listener

    def lowering(self, step_kinds: bool = False) -> Dict[str, str]:
        """Per-query engine placement: ``'host'``, ``'device'``,
        ``'dense'``, ``'hotkey'``, ``'fused'``, ``'devtable'`` or
        ``'multiplex'``, as the reference reports it; every query of a
        per-key instance body is ``'host'``.  ``step_kinds=True`` adds a
        dense pattern's step, fixed at compile time: ``'dense/batch'``,
        ``'dense/general'``, ``'hotkey/batch'``, ``'multiplex/batch'``,
        ``'multiplex/general'``."""
        out: Dict[str, str] = {}
        for n, qr in self.query_runtimes.items():
            out[n] = qr.lowered_to
        for pr in self.partitions.values():
            out.update(pr.query_lowering())
        if step_kinds:
            for n, rt in self.pattern_runtimes().items():
                out[n] += "/" + rt.engine.step_kind
        return out


class _AggregationReceiver:
    """Junction subscriber feeding an AggregationRuntime."""

    def __init__(self, aggregation_runtime, app_context):
        self.aggregation_runtime = aggregation_runtime
        self.app_context = app_context

    def receive(self, batch):
        now = self.app_context.timestamp_generator.current_time()
        self.aggregation_runtime.on_event(batch, now)
