"""Query planner: Query AST -> QueryRuntime.

Port of the JAX package's ``planner/query_planner.py`` for what the port
runs (the analog of the reference's QueryParser.parse,
util/parser/QueryParser.java:90, with SingleInputStreamParser,
SelectorParser and OutputParser):

- a single-stream query under ``@app:execution('tpu')`` on the device
  query engine (``device_query_engine``, ``plan_device_single``): the
  engine's outputs through a passthrough selector (order by, limit,
  offset), the rate limiter and the output.  A query outside the
  engine's subset runs on the host runtime, with a warning naming the
  reason, as in the reference; only that eligibility error is handled
  so;
- a single-stream query on the host runtime (``plan_single``): filters,
  windows and stream functions (``plan_handlers``), the selector with
  its aggregators, group by, having, order by, limit and offset
  (``plan_selector``), the output rate limiter (``plan_rate_limiter``)
  and the output (``plan_output``: ``insert into`` a stream, or the
  query's callbacks);
- a pattern query under ``@app:execution('tpu')`` on the dense engine
  (``plan_dense_state``): a passthrough selector over the engine's
  select lanes, or the aggregating form, in which the engine emits the
  raw captures and the host selector aggregates the match rows (per
  partition key when the query is partitioned).  A partitioned
  passthrough query under ``@app:hotkeys`` is wrapped in the skew
  router.  A time rate limiter and an absent-deadline engine become app
  scheduler tasks.  A pattern outside the dense subset runs on the host
  engine, with a warning naming the reason, as in the reference;
- a pattern query on the host engine (``plan_state``, the reference's
  default mode): the ``PatternProcessor`` of ``ops/nfa.py``, fed by one
  ``PatternStreamReceiver`` per source stream and registered as a
  scheduler task (absent deadlines), its matches through the selector
  over the pattern scope.

``app`` is the app runtime, or inside a partition the per-key
instance's planner facade (``core/partition.py``), whose junctions are
the key's local ones and whose scheduler records what the instance
registers; there, single-stream queries and patterns plan on the host
even under ``@app:execution('tpu')``, as in the reference.  What the
reference runs elsewhere stays refused, naming its ``ROADMAP.md`` §1
item: joins (item 8), tables and named windows (item 9).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

from siddhi_tpu_torch.core.device_single import (
    DeviceQueryReceiver,
    DeviceQueryRuntime,
)
from siddhi_tpu_torch.core.dense_pattern import (
    DensePatternRuntime,
    DenseStreamReceiver,
    build_dense_engine,
    output_attr_types,
)
from siddhi_tpu_torch.core.exceptions import (
    DefinitionNotExistError,
    KernelUnavailableError,
    SiddhiAppCreationError,
    later_slice,
)
from siddhi_tpu_torch.core.query import (
    AggBinding,
    EventRateLimiter,
    FilterProcessor,
    GroupByEventRateLimiter,
    GroupByTimeRateLimiter,
    InsertIntoStreamCallback,
    PassThroughRateLimiter,
    ProcessStreamReceiver,
    QueryCallbackOutput,
    QueryRuntime,
    QuerySelector,
    SelectItem,
    SnapshotRateLimiter,
    StreamFunctionChainProcessor,
    TimeRateLimiter,
    WindowChainProcessor,
)
from siddhi_tpu_torch.extension.validator import validate_extension_args
from siddhi_tpu_torch.ops.aggregators import make_aggregator
from siddhi_tpu_torch.ops.device_query import DeviceQueryEngine
from siddhi_tpu_torch.ops.nfa import (
    NFABuilder,
    PatternProcessor,
    PatternScope,
    _collect_presence,
)
from siddhi_tpu_torch.planner.hotkeys import try_wrap_hotkey
from siddhi_tpu_torch.planner.host_expr import (
    AGGREGATOR_NAMES,
    CompiledExpression,
    ExpressionCompiler,
    Scope,
)
from siddhi_tpu_torch.query_api import (
    AndOp,
    ArithmeticOp,
    Attribute,
    CompareOp,
    EventOutputRate,
    Expression,
    Filter,
    FunctionCall,
    InOp,
    InsertIntoStream,
    IsNull,
    JoinInputStream,
    NotOp,
    OrOp,
    Query,
    ReturnStream,
    Selector,
    SingleInputStream,
    SnapshotOutputRate,
    StateInputStream,
    StreamDefinition,
    StreamFunction,
    TimeOutputRate,
    Variable,
    WindowHandler,
)
from siddhi_tpu_torch.query_api.annotation import find_annotation

log = logging.getLogger("siddhi_tpu_torch")

class _RateLimiterTask:
    """Scheduler task flushing a time rate limiter.

    ``device_runtime`` (dense queries): the query's dense runtime, whose
    pending emits drain BEFORE the limiter's time decision, so queued
    matches reach the limiter in the order the synchronous path would
    deliver them."""

    def __init__(self, qr, limiter, device_runtime=None):
        self.qr = qr
        self.limiter = limiter
        self.device_runtime = device_runtime

    def next_wakeup(self):
        return self.limiter.next_wakeup()

    def fire(self, now: int):
        if self.device_runtime is not None:
            self.device_runtime.drain()
        out = self.limiter.on_time(now)
        if out is not None and len(out):
            self.qr.output.send(out, now)


class AggregatorRewrite:
    """Walks a select expression, replacing aggregator calls with
    synthetic variables bound to aggregation outputs (the reference
    builds AttributeAggregatorExecutors inline in SelectorParser)."""

    def __init__(self, scope: Scope, compiler: ExpressionCompiler):
        self.scope = scope
        self.compiler = compiler
        self.bindings: List[AggBinding] = []

    def rewrite(self, expr: Expression) -> Expression:
        if (isinstance(expr, FunctionCall) and expr.namespace is None
                and expr.name in AGGREGATOR_NAMES):
            key = f"__agg_{len(self.bindings)}"
            arg: Optional[CompiledExpression] = None
            if expr.args:
                if len(expr.args) > 1:
                    raise SiddhiAppCreationError(
                        f"aggregator '{expr.name}' takes one argument")
                arg = self.compiler.compile(self.rewrite(expr.args[0]))
            elif expr.name != "count" and not expr.star:
                raise SiddhiAppCreationError(
                    f"aggregator '{expr.name}' needs an argument")
            executor = make_aggregator(
                expr.name, arg.type if arg is not None else None)
            self.bindings.append(AggBinding(key, executor, arg))
            self.scope.add_bare(key, executor.return_type)
            return Variable(attribute=key)
        if isinstance(expr, ArithmeticOp):
            return ArithmeticOp(expr.op, self.rewrite(expr.left),
                                self.rewrite(expr.right))
        if isinstance(expr, CompareOp):
            return CompareOp(expr.op, self.rewrite(expr.left),
                             self.rewrite(expr.right))
        if isinstance(expr, AndOp):
            return AndOp(self.rewrite(expr.left), self.rewrite(expr.right))
        if isinstance(expr, OrOp):
            return OrOp(self.rewrite(expr.left), self.rewrite(expr.right))
        if isinstance(expr, NotOp):
            return NotOp(self.rewrite(expr.expr))
        if isinstance(expr, IsNull):
            return IsNull(self.rewrite(expr.expr))
        if isinstance(expr, InOp):
            return InOp(self.rewrite(expr.expr), expr.source_id)
        if isinstance(expr, FunctionCall):
            return FunctionCall(expr.namespace, expr.name,
                                tuple(self.rewrite(a) for a in expr.args),
                                expr.star)
        return expr


def scope_for_definition(definition: StreamDefinition, stream_ref: str
                         ) -> Scope:
    scope = Scope()
    for a in definition.attributes:
        scope.add(stream_ref, a.name, a.name, a.type)
    return scope


def query_name(query: Query, index: int) -> str:
    info = find_annotation(query.annotations, "info")
    return (info.element("name") if info else None) or f"query_{index}"


def has_aggregators(sel: Selector) -> bool:
    """Does any select item call an aggregator (sum, count, ...)?"""

    def walk(e) -> bool:
        if isinstance(e, FunctionCall):
            if e.namespace is None and e.name in AGGREGATOR_NAMES:
                return True
            return any(walk(a) for a in e.args)
        for attr in ("left", "right", "expr"):
            child = getattr(e, attr, None)
            if isinstance(child, Expression) and walk(child):
                return True
        return False

    return any(walk(oa.expression) for oa in (sel.selection or []))


def _const_int(expr, compiler, what) -> Optional[int]:
    if expr is None:
        return None
    c = compiler.compile(expr)
    try:
        return int(c.fn({}))
    except Exception as e:
        raise SiddhiAppCreationError(f"{what} must be a constant") from e


def _order_by(sel: Selector, out_names: List[str]) -> List[Tuple[str, bool]]:
    order_by = []
    for ob in sel.order_by:
        if ob.variable.attribute not in out_names:
            raise SiddhiAppCreationError(
                f"order by attribute '{ob.variable.attribute}' not in "
                "select output")
        order_by.append((ob.variable.attribute, ob.ascending))
    return order_by


def passthrough_selector(sel: Selector, out_names: List[str],
                         out_target: str) -> QuerySelector:
    """Column-passthrough selector applying only the query's order by,
    limit and offset over each chunk: the host tail of a dense query."""
    const_compiler = ExpressionCompiler(Scope())
    return QuerySelector(
        out_target, None, out_names, [], [], None, _order_by(sel, out_names),
        _const_int(sel.limit, const_compiler, "limit"),
        _const_int(sel.offset, const_compiler, "offset"))


def _out_target(query: Query, name: str) -> str:
    return getattr(query.output_stream, "target", None) or f"__ret_{name}"


# -- entry -------------------------------------------------------------------


class PatternStreamReceiver:
    """Junction subscriber feeding one source stream into the host NFA
    (the reference's Pattern/SequenceSingleProcessStreamReceiver)."""

    def __init__(self, processor, stream_key: str):
        self.processor = processor
        self.stream_key = stream_key

    def receive(self, batch):
        self.processor.process_stream_batch(self.stream_key, batch)


def plan_query(app, query: Query, index: int) -> QueryRuntime:
    """Plan one query: a single-stream query on the host runtime (the
    reference's default mode) or, under ``@app:execution('tpu')``, on
    the device query engine; a pattern on the host engine or, under
    ``@app:execution('tpu')``, on the dense engine at one partition, fed
    by one ``DenseStreamReceiver`` per source stream.  Inside a
    partition instance (``app.in_partition_instance``) both take the
    host.  Raises for what the port does not run."""
    name = query_name(query, index)
    in_stream = query.input_stream
    tpu = (app.app_context.execution_mode == "tpu"
           and not getattr(app, "in_partition_instance", False))
    if isinstance(in_stream, SingleInputStream):
        if tpu:
            # the device query path first; the host chain, with a
            # warning, when the query is outside its subset
            try:
                engine = device_query_engine(app, query, in_stream)
            except KernelUnavailableError:
                raise
            except SiddhiAppCreationError as e:
                log.warning("query '%s': device query path unavailable "
                            "(%s); using host engine", name, e)
            else:
                log.info("query '%s': lowered to the device query path",
                         name)
                return plan_device_single(app, query, name, in_stream,
                                          engine)
        return plan_single(app, query, name, in_stream)
    if isinstance(in_stream, StateInputStream):
        if tpu:
            # the dense path first; the host engine, with a warning, when
            # the pattern is outside its subset
            try:
                qr = plan_dense_state(app, query, name, in_stream,
                                      n_partitions=1)
            except KernelUnavailableError:
                raise
            except SiddhiAppCreationError as e:
                log.warning("query '%s': dense TPU path unavailable (%s); "
                            "using host pattern engine", name, e)
            else:
                log.info("query '%s': pattern lowered to the dense TPU "
                         "path", name)
                runtime = qr.pattern_processor
                for sk in runtime.engine.stream_keys:
                    app.junctions[sk].subscribe(
                        DenseStreamReceiver(runtime, sk))
                return qr
        return plan_state(app, query, name, in_stream)
    if isinstance(in_stream, JoinInputStream):
        raise SiddhiAppCreationError(
            f"query '{name}': joins" + later_slice(8, "joins"))
    raise SiddhiAppCreationError(
        f"query '{name}': input type {type(in_stream).__name__} is not "
        "supported")


# -- single stream -----------------------------------------------------------


def device_query_engine(app, query: Query, s: SingleInputStream,
                        partition_mode: bool = False) -> DeviceQueryEngine:
    """The query's device engine, or ``SiddhiAppCreationError`` when the
    query is outside the device subset (the reference's eligibility
    checks, in its order).  ``partition_mode``: the query sits in a
    partition, whose key composes into the engine's group axis."""
    ctx = app.app_context
    out = query.output_stream
    if out is not None and getattr(out, "event_type",
                                   "current") != "current":
        raise SiddhiAppCreationError("device path emits CURRENT events only")
    if partition_mode and query.output_rate is not None:
        # each per-key instance of the reference has its own limiter
        raise SiddhiAppCreationError(
            "partitioned queries with output rate limits need per-key "
            "limiters — host instances used")
    if partition_mode and (query.selector.order_by
                           or query.selector.limit is not None
                           or query.selector.offset is not None):
        # per-key instances slice order by/limit per key
        raise SiddhiAppCreationError(
            "partitioned queries with order by/limit need per-key chunks "
            "— host instances used")
    return DeviceQueryEngine(
        query, app.resolve_stream_definition(s),
        n_groups=ctx.tpu_partitions, partition_mode=partition_mode,
        n_wgroups=ctx.tpu_partitions if partition_mode else None,
        defer_order_by=True, device=ctx.device)


def plan_device_single(app, query: Query, name: str, s: SingleInputStream,
                       engine: DeviceQueryEngine,
                       subscribe: bool = True) -> QueryRuntime:
    """Wire a device engine into a query runtime: the engine's outputs
    go through a passthrough selector (order by, limit and offset over
    each chunk), the rate limiter and the output.  ``subscribe=False``
    (partition mode): the partition receiver feeds the runtime with each
    batch's keys, and owns the purge timing."""
    ctx = app.app_context
    out_target = _out_target(query, name)
    selector = passthrough_selector(query.selector, engine.output_names,
                                    out_target)
    out_def = StreamDefinition(id=out_target, attributes=[
        Attribute(nm, t) for nm, t in zip(engine.output_names,
                                          engine.out_types)])
    output = plan_output(app, query, out_def, name)
    rate_limiter = plan_rate_limiter(query)
    qr = QueryRuntime(name, [[]], selector, rate_limiter, output, ctx)
    runtime = DeviceQueryRuntime(
        engine, f"#device_{name}", emit=lambda b: qr.process(b, 0),
        emit_depth=ctx.tpu_emit_depth, ingest_depth=ctx.tpu_ingest_depth,
        clock=ctx.timestamp_generator.current_time)
    qr.device_runtime = runtime
    qr.lowered_to = "device"
    if subscribe:
        app.junction_for_input(s).subscribe(DeviceQueryReceiver(runtime))
        # timeBatch panes close on the scheduler; the rate task drains
        # the queued emits before its time decision
        app.scheduler.register_task(runtime)
        if rate_limiter.needs_scheduler_task:
            app.scheduler.register_task(
                _RateLimiterTask(qr, rate_limiter, device_runtime=runtime))
    return qr


def plan_single(app, query: Query, name: str, s: SingleInputStream
                ) -> QueryRuntime:
    """The host runtime: receiver -> filters, windows, stream functions
    -> selector -> rate limiter -> output."""
    definition = app.resolve_stream_definition(s)
    scope = scope_for_definition(definition, s.unique_id)
    if s.alias and s.alias != s.stream_id:
        scope.add_alias(s.stream_id, s.alias)
    compiler = ExpressionCompiler(scope)
    chain, batch_mode, windows, extra_attrs = plan_handlers(
        app, s, definition, compiler)
    selector, out_def = plan_selector(
        app, query.selector, scope, compiler, name, query, batch_mode,
        extra_attrs=extra_attrs)
    output = plan_output(app, query, out_def, name)
    rate_limiter = plan_rate_limiter(query)
    qr = QueryRuntime(name, [chain], selector, rate_limiter, output,
                      app.app_context)
    scheduler = app.scheduler
    for w in windows:
        if w.needs_scheduler:
            scheduler.register_window(qr, w)
    if rate_limiter.needs_scheduler_task:
        scheduler.register_task(_RateLimiterTask(qr, rate_limiter))
    app.junction_for_input(s).subscribe(ProcessStreamReceiver(qr))
    return qr


def plan_handlers(app, s: SingleInputStream, definition, compiler):
    """The chain of a single-stream input: its filters, windows and
    stream functions in order.  Returns ``(chain, batch_mode, windows,
    extra_attrs)``: ``batch_mode`` when a batch window is in the chain,
    ``extra_attrs`` the columns stream functions append."""
    chain = []
    windows = []
    batch_mode = False
    extra_attrs = []
    for h in s.handlers:
        if isinstance(h, Filter):
            chain.append(FilterProcessor(compiler.compile(h.expression)))
        elif isinstance(h, WindowHandler):
            factory = app.extensions.lookup("window", h.name, h.namespace)
            if factory is None:
                raise SiddhiAppCreationError(
                    f"unknown window '#window.{h.name}()'"
                    + later_slice(10, "custom extensions"))
            args = [compiler.compile(a) for a in h.args]
            validate_extension_args(
                factory, h.name, [a.type for a in args],
                where=f"window '#window.{h.name}' on stream '{s.stream_id}'")
            w = factory(args, definition.attribute_names)
            windows.append(w)
            batch_mode = batch_mode or getattr(w, "is_batch", False)
            chain.append(WindowChainProcessor(w))
        elif isinstance(h, StreamFunction):
            factory = app.extensions.lookup("stream_function", h.name,
                                            h.namespace)
            if factory is None:
                raise SiddhiAppCreationError(
                    f"unknown stream function '#{h.name}()'"
                    + later_slice(10, "custom extensions"))
            args = [compiler.compile(a) for a in h.args]
            validate_extension_args(
                factory, h.name, [a.type for a in args],
                where=f"stream function '#{h.name}' on stream "
                      f"'{s.stream_id}'")
            fn_obj = factory(args, definition.attribute_names)
            # schema-extending stream functions (#pol2Cart's x, y): the
            # new columns resolve in later filters and the selector
            for a in getattr(fn_obj, "output_attributes", None) or ():
                compiler.scope.add(s.stream_id, a.name, a.name, a.type)
                if s.unique_id != s.stream_id:
                    compiler.scope.add(s.unique_id, a.name, a.name, a.type)
                extra_attrs.append(a)
            chain.append(StreamFunctionChainProcessor(fn_obj))
        else:
            raise SiddhiAppCreationError(f"unsupported stream handler {h}")
    return chain, batch_mode, windows, extra_attrs


# -- selector, rate limiter, output ------------------------------------------


def plan_selector(app, sel: Selector, scope: Scope,
                  compiler: ExpressionCompiler, qname: str, query: Query,
                  batch_mode: bool, extra_attrs=None
                  ) -> Tuple[QuerySelector, StreamDefinition]:
    out_target = _out_target(query, qname)
    rewriter = AggregatorRewrite(scope, compiler)
    items: Optional[List[SelectItem]] = None
    out_attrs: List[Attribute] = []
    if sel.is_select_all:
        # select *: the input definition, then any stream function's
        # appended columns
        if not isinstance(query.input_stream, SingleInputStream):
            raise SiddhiAppCreationError(
                f"query '{qname}': 'select *' needs an explicit select "
                "clause for pattern/join inputs")
        in_def = app.resolve_stream_definition(query.input_stream)
        out_attrs = list(in_def.attributes) + list(extra_attrs or [])
        out_names = [a.name for a in out_attrs]
    else:
        items = []
        for oa in sel.selection:
            compiled = compiler.compile(rewriter.rewrite(oa.expression))
            nm = oa.rename or (oa.expression.attribute
                               if isinstance(oa.expression, Variable)
                               else None)
            if nm is None:
                raise SiddhiAppCreationError(
                    f"query '{qname}': select expression needs 'as <name>'")
            items.append(SelectItem(nm, compiled))
            out_attrs.append(Attribute(nm, compiled.type))
        out_names = [i.name for i in items]
        # output attributes are referencable in having and order by
        for a in out_attrs:
            scope.add_bare(a.name, a.type)
    group_keys = [compiler.compile(g) for g in sel.group_by]
    having = (compiler.compile(rewriter.rewrite(sel.having))
              if sel.having is not None else None)
    selector = QuerySelector(
        out_target, items, out_names, rewriter.bindings, group_keys, having,
        _order_by(sel, out_names), _const_int(sel.limit, compiler, "limit"),
        _const_int(sel.offset, compiler, "offset"), batch_mode=batch_mode)
    return selector, StreamDefinition(id=out_target, attributes=out_attrs)


def plan_rate_limiter(query: Query):
    r = query.output_rate
    if r is None:
        return PassThroughRateLimiter()
    grouped = bool(query.selector.group_by)
    if isinstance(r, EventOutputRate):
        if r.type in ("first", "last") and grouped:
            return GroupByEventRateLimiter(r.events, r.type)
        return EventRateLimiter(r.events, r.type)
    if isinstance(r, TimeOutputRate):
        if r.type in ("first", "last") and grouped:
            return GroupByTimeRateLimiter(r.value_ms, r.type)
        return TimeRateLimiter(r.value_ms, r.type)
    if isinstance(r, SnapshotOutputRate):
        return SnapshotRateLimiter(
            r.value_ms, [g.attribute for g in query.selector.group_by])
    raise SiddhiAppCreationError(f"unsupported output rate {r}")


def plan_output(app, query: Query, out_def: StreamDefinition, qname: str):
    """``insert into`` a stream (``#inner``: the partition instance's
    local junction), or (``return``, no output) the query's callbacks;
    fault and table outputs stay refused."""
    out = query.output_stream
    if isinstance(out, InsertIntoStream):
        if out.is_fault:
            raise SiddhiAppCreationError(
                f"query '{qname}': 'insert into !{out.target}' (fault "
                "streams)" + later_slice(15, "the operations layer"))
        return InsertIntoStreamCallback(
            app.output_junction(out_def, is_inner=out.is_inner),
            out.event_type)
    if isinstance(out, ReturnStream) or out is None:
        return QueryCallbackOutput()
    raise SiddhiAppCreationError(
        f"query '{qname}': {type(out).__name__} outputs write tables"
        + later_slice(9, "tables"))


# -- pattern -----------------------------------------------------------------


def plan_dense_state(app, query: Query, name: str, st,
                     n_partitions: Optional[int] = None) -> QueryRuntime:
    """Plan a pattern query onto the dense engine (``n_partitions``: the
    app's partition count, 1 for an unpartitioned query); raises
    SiddhiAppCreationError when it is outside what the port runs."""
    ctx = app.app_context
    if n_partitions is None:
        n_partitions = ctx.tpu_partitions
    partitioned = n_partitions > 1
    if partitioned and query.output_rate is not None:
        # the reference gives each key instance its OWN rate limiter
        # (per-key host instances); one shared limiter would pool the
        # emission windows of every key
        raise SiddhiAppCreationError(
            "dense path: partitioned queries with output rate limits need "
            "per-key limiters — host instances used")
    sel = query.selector
    aggregating = (bool(sel.group_by) or sel.having is not None
                   or has_aggregators(sel))
    if aggregating:
        # the aggregating-selector form: the engine emits the RAW
        # captures (keyed as in the pattern scope, "a.amount") and the
        # host selector aggregates, groups and filters the match rows,
        # which are sparse (reference: QuerySelector over StateEvent
        # chunks, QuerySelector.java:76-99)
        if partitioned and (sel.order_by or sel.limit is not None
                            or sel.offset is not None):
            # order by and limit slice each output chunk; a dense chunk
            # mixes partition keys, so it would slice ACROSS keys
            raise SiddhiAppCreationError(
                "dense path: partitioned aggregating selectors with order "
                "by/limit need per-key chunks — host instances used")
        builder = NFABuilder(st, app.resolve_stream_definition)
        builder.build()
        scope = PatternScope(builder.ref_defs, builder.stream_to_ref,
                             cand_def=None)
        selector, out_def = plan_selector(
            app, sel, scope, ExpressionCompiler(scope), name, query,
            batch_mode=False)
        select_vars = [
            Variable(stream_id=ref, attribute=attr, stream_index=idx)
            for ref, idx, attr, _t in scope.used_captures.values()]
        engine = build_dense_engine(
            query, st, app.resolve_stream_definition, n_partitions,
            n_instances=ctx.tpu_instances, device=ctx.device,
            select_override=(select_vars, list(scope.used_captures)),
            builder=builder)
        # ONE shared selector keeps per-(key, group) state through the
        # partition-key side channel of the match rows
        selector.partition_axis = partitioned
    else:
        engine = build_dense_engine(
            query, st, app.resolve_stream_definition, n_partitions,
            n_instances=ctx.tpu_instances, device=ctx.device)
        out_target = _out_target(query, name)
        selector = passthrough_selector(sel, engine.output_names, out_target)
        out_def = StreamDefinition(id=out_target, attributes=[
            Attribute(nm, t) for nm, t in
            zip(engine.output_names, output_attr_types(engine))])
    output = plan_output(app, query, out_def, name)
    rate_limiter = plan_rate_limiter(query)
    qr = QueryRuntime(name, [[]], selector, rate_limiter, output, ctx)
    runtime = DensePatternRuntime(
        engine, f"#matches_{name}", emit=lambda b: qr.process(b, 0),
        emit_depth=ctx.tpu_emit_depth, ingest_depth=ctx.tpu_ingest_depth,
        clock=ctx.timestamp_generator.current_time, app_context=ctx)
    qr.lowered_to = "dense"
    if selector.partition_axis:
        # match rows carry their partition keys; @purge drops the purged
        # keys' aggregation state too (host: the whole per-key instance
        # dies)
        runtime.key_channel = True
        runtime.on_purge_keys = selector.drop_partition_keys
    # @app:hotkeys: wrap the partitioned passthrough pattern in the skew
    # router (heavy keys ride the fused scan, cold keys stay dense); the
    # aggregating form stays dense: the router selects final-node lanes
    if ctx.hotkeys and partitioned and not aggregating:
        wrapped = try_wrap_hotkey(ctx, app.definitions, st, runtime, name)
        if wrapped is not None:
            runtime = wrapped
            qr.lowered_to = wrapped.lowered_to
    qr.pattern_processor = runtime
    # registered LAST, in the reference's order: the rate task, then
    # the deadline task (absent deadlines fire from the app scheduler;
    # the router refuses deadline engines, so this is the dense runtime).
    # Kept on the runtime, so that a partition whose later query cannot
    # lower unregisters them before it falls back to per-key instances
    if rate_limiter.needs_scheduler_task:
        qr.scheduler_tasks.append(
            _RateLimiterTask(qr, rate_limiter, device_runtime=runtime))
    if engine.has_deadlines:
        qr.scheduler_tasks.append(runtime)
    for task in qr.scheduler_tasks:
        app.scheduler.register_task(task)
    return qr


def plan_state(app, query: Query, name: str, st) -> QueryRuntime:
    """A pattern on the host engine: the selector over the pattern
    scope, the rate limiter, and the ``PatternProcessor`` as a scheduler
    task (absent deadlines), one ``PatternStreamReceiver`` per source
    junction."""
    builder = NFABuilder(st, app.resolve_stream_definition)
    nodes = builder.build()
    # selector scope over the event refs; bare attributes resolve when
    # unambiguous
    scope = PatternScope(builder.ref_defs, builder.stream_to_ref,
                         cand_def=None)
    selector, out_def = plan_selector(
        app, query.selector, scope, ExpressionCompiler(scope), name, query,
        batch_mode=False)
    output = plan_output(app, query, out_def, name)
    rate_limiter = plan_rate_limiter(query)
    qr = QueryRuntime(name, [[]], selector, rate_limiter, output,
                      app.app_context)
    if rate_limiter.needs_scheduler_task:
        app.scheduler.register_task(_RateLimiterTask(qr, rate_limiter))
    # presence keys (`e2[1] is null`) used in the select items and having
    presence = {}
    sel = query.selector
    exprs = [oa.expression for oa in sel.selection or []]
    if sel.having is not None:
        exprs.append(sel.having)
    for e in exprs:
        presence.update(_collect_presence(e, builder.ref_defs,
                                          builder.stream_to_ref))
    processor = PatternProcessor(
        nodes=nodes, mode=st.type, within_ms=st.within_ms,
        ref_defs=builder.ref_defs, output_keys=dict(scope.used_captures),
        presence_keys=presence, emit=lambda batch: qr.process(batch, 0),
        out_stream_id=f"#matches_{name}")
    qr.pattern_processor = processor
    app.scheduler.register_task(processor)
    seen = set()
    for node in nodes:
        for spec in node.specs:
            if spec.stream_key in seen:
                continue
            seen.add(spec.stream_key)
            junction = app.junctions.get(spec.stream_key)
            if junction is None:
                raise DefinitionNotExistError(
                    f"stream '{spec.stream_key}' is not defined")
            junction.subscribe(PatternStreamReceiver(processor,
                                                     spec.stream_key))
    return qr
