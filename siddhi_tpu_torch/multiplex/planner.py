"""Multiplex placement: seat eligible queries in shared device engines.

Port of the JAX package's ``multiplex/planner.py``.
``MultiplexPlanner`` rides the two ``@app:execution('tpu')`` gates of
``planner/query_planner.py``: before the dedicated dense and device
query paths run, an ``@app:multiplex`` app first tries to seat the query
in a manager-wide shared engine keyed by its structural fingerprint
(``fingerprint.py``).  A seat wires a per-tenant adapter runtime
(``tumbling_group.py``, ``dense_group.py``) behind the query runtime
surface the dedicated paths build, so selectors, output callbacks and
snapshots cannot tell the difference downstream.

Every ineligibility has its reason: a WARNING with the reference's text,
and the reason in ``AppContext.multiplex_fallbacks`` (query -> reason),
counted on the statistics feed as the reference's
``multiplexFallbackReason``; the planner then falls through to the
dedicated engine.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from siddhi_tpu_torch.core.exceptions import (
    DefinitionNotExistError,
    SiddhiAppCreationError,
)
from siddhi_tpu_torch.core.query import QueryRuntime
from siddhi_tpu_torch.multiplex.fingerprint import (
    query_fingerprint,
    reads_clock,
)
from siddhi_tpu_torch.multiplex.registry import registry_for
from siddhi_tpu_torch.planner.app_planner import note_fallback
from siddhi_tpu_torch.query_api import (
    Attribute,
    Query,
    SingleInputStream,
    StreamDefinition,
    WindowHandler,
)

log = logging.getLogger("siddhi_tpu_torch")

_TUMBLING_WINDOWS = ("lengthBatch", "timeBatch")


class MultiplexPlanner:
    """Attempts multiplex placement for one query; ``None``: fall back."""

    def __init__(self, app):
        self.app = app  # the app runtime being planned
        self.ctx = app.app_context

    # -- shared helpers ------------------------------------------------------

    def _fallback(self, name: str, reason: str) -> None:
        note_fallback(self.ctx, "multiplex", name, reason)
        # WARNING, not info: @app:multiplex was asked for and this query
        # does not get it
        log.warning("query '%s': multiplex ineligible (%s); dedicated "
                    "engine used", name, reason)
        return None

    def _common_reject(self, query: Query, name: str) -> Optional[str]:
        """Eligibility conditions shared by both engine families."""
        if getattr(self.ctx, "tpu_devices", 0):
            return "mesh-sharded state does not multiplex"
        if query.output_rate is not None:
            return "output rate limits need a dedicated engine"
        out = query.output_stream
        if out is not None and getattr(out, "event_type",
                                       "current") != "current":
            return "multiplexed engines emit CURRENT events only"
        clock_fn = reads_clock(query)
        if clock_fn is not None:
            # these compile against the engine's relative-time anchor,
            # which a shared group re-bases across tenants
            return f"{clock_fn}() reads the engine clock anchor"
        return None

    def _output(self, query: Query, name: str, out_names, out_types):
        """The query runtime behind a seat: a passthrough selector (order
        by, limit, offset), the rate limiter and the output, as the
        dedicated device paths build them."""
        from siddhi_tpu_torch.planner.query_planner import (
            passthrough_selector,
            plan_output,
            plan_rate_limiter,
        )

        out_target = (getattr(query.output_stream, "target", None)
                      or f"__ret_{name}")
        selector = passthrough_selector(query.selector, out_names,
                                        out_target)
        out_def = StreamDefinition(id=out_target, attributes=[
            Attribute(nm, t) for nm, t in zip(out_names, out_types)])
        output = plan_output(self.app, query, out_def, name)
        return QueryRuntime(name, [[]], selector, plan_rate_limiter(query),
                            output, self.ctx)

    # -- tumbling windowed aggregates ---------------------------------------

    def try_single(self, query: Query, name: str,
                   s: SingleInputStream) -> Optional[QueryRuntime]:
        """Seat a tumbling windowed-aggregate query in a shared
        :class:`~siddhi_tpu_torch.multiplex.tumbling_group.TumblingMultiplexGroup`;
        ``None`` (with its reason) falls back to the dedicated device
        or host path."""
        from siddhi_tpu_torch.multiplex.tumbling_group import (
            TumblingMultiplexGroup,
        )
        from siddhi_tpu_torch.ops.device_query import DeviceQueryEngine

        reason = self._common_reject(query, name)
        if reason is not None:
            return self._fallback(name, reason)
        if not (s.is_inner or s.is_fault):
            if s.stream_id in self.app.named_windows:
                return self._fallback(
                    name, "named-window inputs need CURRENT+EXPIRED "
                    "semantics")
            if s.stream_id in self.app.tables or s.stream_id in getattr(
                    self.app, "aggregations", {}):
                return self._fallback(
                    name, "table/aggregation inputs need the host planner")
        window = next((h for h in s.handlers
                       if isinstance(h, WindowHandler)), None)
        if window is None or window.name not in _TUMBLING_WINDOWS or (
                window.namespace or "") != "":
            return self._fallback(
                name, "only tumbling lengthBatch/timeBatch windows "
                "multiplex")

        definition = self.app.resolve_stream_definition(s)
        slots = int(self.ctx.multiplex_slots)
        fp = query_fingerprint(
            query, [definition],
            {"family": "tumbling",
             "n_groups": self.ctx.tpu_partitions,
             "slots": slots})

        def factory():
            engine = DeviceQueryEngine(
                query, definition,
                n_groups=self.ctx.tpu_partitions,
                partition_mode=False,
                defer_order_by=True,
                device=self.ctx.device,
            )
            if engine.kind != "tumbling":
                raise SiddhiAppCreationError(
                    "engine lowered to a non-tumbling form")
            return TumblingMultiplexGroup(engine, slots)

        registry = registry_for(self.app.siddhi_context)
        try:
            group, slot = registry.acquire(fp, factory)
        except SiddhiAppCreationError as e:
            return self._fallback(name, str(e))
        try:
            return self._wire_single(query, name, s, group, slot, registry)
        except BaseException:
            registry.release(group, slot)
            raise

    def _wire_single(self, query: Query, name: str, s: SingleInputStream,
                     group, slot: int, registry) -> QueryRuntime:
        from siddhi_tpu_torch.core.device_single import DeviceQueryReceiver
        from siddhi_tpu_torch.multiplex.tumbling_group import (
            MultiplexTenantRuntime,
        )

        engine = group.engine
        qr = self._output(query, name, engine.output_names, engine.out_types)
        runtime = MultiplexTenantRuntime(
            group, slot, f"#device_{name}",
            emit=lambda b: qr.process(b, 0),
            clock=self.ctx.timestamp_generator.current_time,
            faults=self.ctx.fault_injector,
            registry=registry)
        qr.device_runtime = runtime
        junction = self.app.junction_for_input(s)
        junction.subscribe(DeviceQueryReceiver(runtime))
        # registered LAST: nothing below may raise, so a fallback never
        # leaks a live scheduler task
        self.app.scheduler.register_task(runtime)
        qr.lowered_to = "multiplex"
        self._record_placement(name, group)
        return qr

    # -- dense patterns ------------------------------------------------------

    def try_state(self, query: Query, name: str, st
                  ) -> Optional[QueryRuntime]:
        """Seat an unpartitioned non-aggregating pattern query in a shared
        :class:`~siddhi_tpu_torch.multiplex.dense_group.DenseMultiplexGroup`
        (one partition row a tenant); ``None`` falls back to the
        dedicated dense or host path."""
        from siddhi_tpu_torch.core.dense_pattern import (
            build_dense_engine,
            output_attr_types,
        )
        from siddhi_tpu_torch.multiplex.dense_group import (
            DenseMultiplexGroup,
        )
        from siddhi_tpu_torch.planner.query_planner import has_aggregators

        reason = self._common_reject(query, name)
        if reason is not None:
            return self._fallback(name, reason)
        sel = query.selector
        if sel.group_by or sel.having is not None or has_aggregators(sel):
            return self._fallback(
                name, "aggregating pattern selectors keep per-query host "
                "state")
        defs: List[StreamDefinition] = []
        for sid in sorted(set(st.stream_ids())):
            d = self.app.definitions.get(sid)
            if d is None:
                return self._fallback(
                    name, f"input stream '{sid}' has no groupable "
                    "definition")
            defs.append(d)

        slots = int(self.ctx.multiplex_slots)
        fp = query_fingerprint(
            query, defs,
            {"family": "dense",
             "instances": self.ctx.tpu_instances,
             "slots": slots})

        def factory():
            # one partition row a seat: the dedicated path runs an
            # unpartitioned pattern at n_partitions=1, so row t is
            # tenant t's single-row automaton
            engine = build_dense_engine(
                query, st, self.app.resolve_stream_definition,
                n_partitions=slots,
                n_instances=self.ctx.tpu_instances,
                device=self.ctx.device)
            if getattr(engine, "has_deadlines", False):
                raise SiddhiAppCreationError(
                    "absent-pattern deadlines need per-query timers")
            return DenseMultiplexGroup(
                engine, [t.np_dtype for t in output_attr_types(engine)],
                slots)

        registry = registry_for(self.app.siddhi_context)
        try:
            group, slot = registry.acquire(fp, factory)
        except SiddhiAppCreationError as e:
            return self._fallback(name, str(e))
        try:
            return self._wire_state(query, name, group, slot, registry)
        except BaseException:
            registry.release(group, slot)
            raise

    def _wire_state(self, query: Query, name: str, group, slot: int,
                    registry) -> QueryRuntime:
        from siddhi_tpu_torch.core.dense_pattern import (
            DenseStreamReceiver,
            output_attr_types,
        )
        from siddhi_tpu_torch.multiplex.dense_group import (
            DenseMultiplexTenantRuntime,
        )

        engine = group.engine
        qr = self._output(query, name, engine.output_names,
                          output_attr_types(engine))
        runtime = DenseMultiplexTenantRuntime(
            group, slot, f"#matches_{name}",
            emit=lambda b: qr.process(b, 0),
            clock=self.ctx.timestamp_generator.current_time,
            faults=self.ctx.fault_injector,
            registry=registry)
        qr.pattern_processor = runtime
        for sk in engine.stream_keys:
            junction = self.app.junctions.get(sk)
            if junction is None:
                raise DefinitionNotExistError(
                    f"stream '{sk}' is not defined")
            junction.subscribe(DenseStreamReceiver(runtime, sk))
        self.app.scheduler.register_task(runtime)
        qr.lowered_to = "multiplex"
        self._record_placement(name, group)
        return qr

    def _record_placement(self, name: str, group) -> None:
        sm = self.ctx.statistics_manager
        if sm is not None:
            sm.record_multiplex_placement(
                name, getattr(group, "fingerprint", "?"),
                group.occupied_count())
        log.info(
            "query '%s': multiplexed into shared engine %s (%d/%d seats)",
            name, getattr(group, "fingerprint", "?")[:12],
            group.occupied_count(), group.slots)
