"""One running Siddhi app: junctions, planned queries and partitions,
aggregations, callbacks.

Port of the part of the JAX package's ``core/app_runtime.py`` (and the
app planner's wiring) that the ported slices need: stream junctions for
the defined streams, ``insert into`` output streams, single-stream
queries on the host query runtime (the reference's default mode) or,
under ``@app:execution('tpu')``, on the device query engine, pattern
queries on the dense path (outside a partition at one partition),
partitions lowered to the device paths, incremental
aggregations subscribed to their input junctions (``aggregations``,
``query()`` for on-demand FINDs over them), stream and query callbacks,
input handlers, the app scheduler (window ticks, rate limits,
absent-deadline timers, timeBatch panes and ``@purge``) with the
``@app:playback(idle.time, increment)`` idle heartbeat, exception
listeners, ``start``, ``shutdown`` and ``lowering()``.  An app outside
the slices raises ``SiddhiAppCreationError`` naming the ``ROADMAP.md``
item that ports it: tables, named windows and triggers (item 9),
functions (item 10).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Union

from siddhi_tpu_torch.aggregation.runtime import AggregationRuntime
from siddhi_tpu_torch.core.exceptions import (
    DefinitionNotExistError,
    SiddhiAppCreationError,
    SiddhiAppRuntimeError,
    later_slice,
)
from siddhi_tpu_torch.core.partition import PartitionRuntime
from siddhi_tpu_torch.core.stream import (
    FunctionQueryCallback,
    FunctionStreamCallback,
    InputHandler,
    QueryCallback,
    StreamCallback,
    StreamJunction,
)
from siddhi_tpu_torch.extension.registry import default_registry
from siddhi_tpu_torch.planner.app_planner import plan_app_context
from siddhi_tpu_torch.planner.query_planner import plan_unpartitioned_query
from siddhi_tpu_torch.query_api import Query, SingleInputStream


class SiddhiAppRuntime:
    def __init__(self, siddhi_app, device):
        self.siddhi_app = siddhi_app
        self.app_context = plan_app_context(siddhi_app, device)
        self.name = self.app_context.name
        for what, defs, item in (
                ("tables", siddhi_app.table_definitions, 9),
                ("named windows", siddhi_app.window_definitions, 9),
                ("triggers", siddhi_app.trigger_definitions, 9),
                ("functions", siddhi_app.function_definitions, 10)):
            if defs:
                raise SiddhiAppCreationError(
                    f"app '{self.name}': {what} ({', '.join(defs)})"
                    + later_slice(item, what))
        # the built-in windows and stream functions
        self.extensions = default_registry()
        self.definitions = dict(siddhi_app.stream_definitions)
        self.junctions: Dict[str, StreamJunction] = {
            sid: StreamJunction(d, self.app_context)
            for sid, d in self.definitions.items()}
        self.partitions: Dict[str, PartitionRuntime] = {}
        # unpartitioned queries by name (host queries, dense patterns)
        self.query_runtimes: Dict[str, object] = {}
        self._running = False
        self._playback_stop = None
        self._playback_thread = None
        self._on_demand_cache: Dict[str, object] = {}
        self.aggregations: Dict[str, AggregationRuntime] = {}
        for ad in siddhi_app.aggregation_definitions.values():
            ar = AggregationRuntime(ad, self)
            self.aggregations[ad.id] = ar
            self.junctions[ad.input_stream.stream_id].subscribe(
                _AggregationReceiver(ar, self.app_context))
        qi = pi = 0  # the reference numbers queries and partitions apart
        for el in siddhi_app.execution_elements:
            if isinstance(el, Query):
                qr = plan_unpartitioned_query(self, el, qi)
                qi += 1
                if qr.name in self.query_runtimes:
                    raise SiddhiAppCreationError(
                        f"duplicate query name '{qr.name}'")
                self.query_runtimes[qr.name] = qr
                continue
            pr = PartitionRuntime(el, self, pi)
            pi += 1
            self.partitions[pr.name] = pr

    # -- planning hooks ------------------------------------------------------

    def resolve_stream_definition(self, s):
        if isinstance(s, SingleInputStream) and s.is_fault:
            raise SiddhiAppCreationError(
                f"cannot resolve definition for {s!r}: fault streams "
                "(@OnError(action='STREAM'))"
                + later_slice(15, "the operations layer"))
        if not isinstance(s, SingleInputStream) or s.is_inner:
            raise SiddhiAppCreationError(
                f"cannot resolve definition for {s!r}: inner streams"
                + later_slice(7, "host partitions"))
        d = self.definitions.get(s.stream_id)
        if d is None:
            raise DefinitionNotExistError(
                f"stream '{s.stream_id}' is not defined in app '{self.name}'")
        return d

    def junction_for_input(self, s: SingleInputStream) -> StreamJunction:
        self.resolve_stream_definition(s)
        return self.junctions[s.stream_id]

    def output_junction(self, out_def) -> StreamJunction:
        """The junction of an ``insert into`` target, defined from the
        query's output when the app does not define the stream.  An
        existing junction is shared as it is, as in the reference: each
        batch carries its own attribute names to the callbacks."""
        j = self.junctions.get(out_def.id)
        if j is None:
            self.definitions[out_def.id] = out_def
            j = self.junctions[out_def.id] = StreamJunction(out_def,
                                                             self.app_context)
        return j

    # -- lifecycle -----------------------------------------------------------

    def _all_query_runtimes(self) -> Dict[str, object]:
        out = dict(self.query_runtimes)
        for pr in self.partitions.values():
            out.update(pr.dense_query_runtimes)
        return out

    def pattern_runtimes(self) -> Dict[str, object]:
        """Query name -> its pattern processor (a DensePatternRuntime or
        the HotKeyRouterRuntime around one)."""
        return {n: qr.pattern_processor
                for n, qr in self._all_query_runtimes().items()
                if qr.pattern_processor is not None}

    @property
    def scheduler(self):
        return self.app_context.scheduler

    def start(self):
        if self._running:
            return
        self.scheduler.start()
        self._running = True
        ctx = self.app_context
        if ctx.playback and ctx.playback_idle_ms > 0:
            self._start_playback_heartbeat()

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
                        self.scheduler.advance(tg.advance_idle())

        self._playback_stop = stop
        self._playback_thread = threading.Thread(
            target=loop, name=f"playback-{self.name}", daemon=True)
        self._playback_thread.start()

    def device_runtimes(self) -> Dict[str, object]:
        """Query name -> its device runtime: the pattern processor or the
        device query runtime."""
        return {n: qr.device_processor
                for n, qr in self._all_query_runtimes().items()
                if qr.device_processor is not None}

    def drain(self):
        """Emit every output still pending on the device."""
        for rt in self.device_runtimes().values():
            rt.drain()

    def shutdown(self):
        if self._playback_stop is not None:
            self._playback_stop.set()
            self._playback_thread.join(timeout=2)
            self._playback_stop = self._playback_thread = None
        self.scheduler.stop()
        for rt in self.device_runtimes().values():
            rt.close()
        for ar in self.aggregations.values():
            ar.close()
        self._running = False

    # -- on-demand (pull) queries --------------------------------------------

    def query(self, on_demand_query: str):
        """Run a pull query (a FIND over an aggregation) and return its
        events (reference: SiddhiAppRuntimeImpl.query:304, cache of 50)."""
        from siddhi_tpu_torch.compiler import SiddhiCompiler
        from siddhi_tpu_torch.core.on_demand import OnDemandQueryRuntime

        # barrier: matches still pending on the device may feed the
        # aggregation's input stream
        self.drain()
        rt = self._on_demand_cache.get(on_demand_query)
        if rt is None:
            odq = SiddhiCompiler.parse_on_demand_query(on_demand_query)
            rt = OnDemandQueryRuntime(odq, self)
            if len(self._on_demand_cache) >= 50:
                self._on_demand_cache.pop(next(iter(self._on_demand_cache)))
            self._on_demand_cache[on_demand_query] = rt
        return rt.execute()

    # -- I/O -----------------------------------------------------------------

    def get_input_handler(self, stream_id: str) -> InputHandler:
        j = self.junctions.get(stream_id)
        if j is None:
            raise DefinitionNotExistError(
                f"stream '{stream_id}' is not defined in app '{self.name}'")
        return InputHandler(j, self.app_context, lambda: self._running)

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
            return
        if target in self.query_runtimes:
            if not isinstance(callback, QueryCallback):
                callback = FunctionQueryCallback(callback)
            self.query_runtimes[target].add_callback(callback)
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
        ``'dense'`` or ``'hotkey'``, as the reference reports it.  ``step_kinds=True``
        adds a pattern's dense step, fixed at compile time:
        ``'dense/batch'``, ``'dense/general'``, ``'hotkey/batch'``."""
        out: Dict[str, str] = {}
        for n, qr in self._all_query_runtimes().items():
            out[n] = qr.lowered_to
            if step_kinds and qr.pattern_processor is not None:
                out[n] += "/" + qr.pattern_processor.engine.step_kind
        return out


class _AggregationReceiver:
    """Junction subscriber feeding an AggregationRuntime."""

    def __init__(self, aggregation_runtime, app_context):
        self.aggregation_runtime = aggregation_runtime
        self.app_context = app_context

    def receive(self, batch):
        now = self.app_context.timestamp_generator.current_time()
        self.aggregation_runtime.on_event(batch, now)
