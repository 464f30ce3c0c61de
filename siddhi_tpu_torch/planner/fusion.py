"""@app:fuse pre-pass: lower ``insert into`` chains to fused device graphs.

Port of the JAX package's ``planner/fusion.py``.  The junction path
plans every query into its own engine and routes each hop between
queries through the host: the producer builds an EventBatch, the
junction dispatches it, the consumer pads and puts it on the device
again.  This pre-pass runs before the per-query planning loop
(``core/app_runtime.py``) and finds chains of device-eligible queries
linked by EXCLUSIVE intermediate streams (each intermediate has exactly
one producer and one consumer, both in the chain, and no other observer
in the app), then lowers the whole chain to ONE FusedGraphEngine
(``ops/fused_graph.py``): one fused step a chunk, intermediate event
columns on the device, no EventBatch builds and no junction dispatches
between stages.

Anything that would make an intermediate stream observable, or that the
fused engine cannot reproduce bit for bit, drops back to the junction
path per chain (or per truncated chain suffix), with the reference's
reason logged at WARNING and kept in the app context's
``fused_fallbacks`` (query -> reason), counted on the statistics feed
as the reference's ``fusedFallbackReason``.

Hop gates (the intermediate stream): exactly one top-level device
producer and one consumer; not a table / named window / aggregation /
trigger; not consumed by partitions, aggregations, joins, or extra
queries; declared with NO annotations (@async buffering, @sink,
@OnError, @source all need real junction dispatch); attribute types
INT / FLOAT / BOOL / DOUBLE (LONG and STRING have no device-resident
lane between stages).

Stage gates: non-tail stages are single-input device queries (kind
filter / running / sliding, no group-by, CURRENT output) with no output
rate / order-by / limit — an intermediate limiter or slice would need a
host decision mid-chain.  The tail keeps all of those (they ride the
tail QueryRuntime's host-side selector/limiter exactly like the junction
path) and may instead be an unpartitioned dense pattern over the last
intermediate stream.  A DOUBLE attribute may ride a passthrough into the
final output only if it was COMPUTED on-device somewhere in the chain
(f32 on both paths); forwarding an original f64 input column through the
whole chain would round it, so that falls back.

Direct injection into a fused intermediate stream (its InputHandler
still exists when the stream is declared) cannot enter the middle of the
fused step; a tap subscriber raises into the junction's error route, so
the misuse is loud instead of silently dropped.  A replan pin naming
``fuse`` runs the pass too, and a member pinned to another path leaves
its chain to per-query planning; the cost model's own trigger comes
with item 15d, the sharded fused engine with item 16.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Set, Tuple

from siddhi_tpu_torch.core.dense_pattern import (
    build_dense_engine,
    output_attr_types,
)
from siddhi_tpu_torch.core.exceptions import (
    SiddhiAppCreationError,
    SiddhiAppRuntimeError,
)
from siddhi_tpu_torch.core.fused_graph import (
    FusedChainReceiver,
    FusedChainRuntime,
)
from siddhi_tpu_torch.core.query import PassThroughRateLimiter, QueryRuntime
from siddhi_tpu_torch.ops.device_query import DeviceQueryEngine
from siddhi_tpu_torch.ops.fused_graph import FusedGraphEngine
from siddhi_tpu_torch.planner.app_planner import note_fallback
from siddhi_tpu_torch.planner.costmodel import fused_plan_record
from siddhi_tpu_torch.planner.query_planner import (
    _RateLimiterTask,
    has_aggregators,
    passthrough_selector,
    plan_output,
    plan_rate_limiter,
)
from siddhi_tpu_torch.query_api import (
    Attribute,
    AttrType,
    InsertIntoStream,
    Query,
    SingleInputStream,
    StreamDefinition,
)
from siddhi_tpu_torch.query_api.annotation import find_annotation
from siddhi_tpu_torch.query_api.execution import (
    AnonymousInputStream,
    JoinInputStream,
    Partition,
    StateInputStream,
)

log = logging.getLogger("siddhi_tpu_torch")

# intermediate lanes: int32 / float32 / bool device columns (DOUBLE
# rides the f32 lane both paths compute in — see module docstring)
_LANE_TYPES = (AttrType.INT, AttrType.FLOAT, AttrType.BOOL, AttrType.DOUBLE)
_EXACT_TAIL_TYPES = (AttrType.INT, AttrType.FLOAT, AttrType.BOOL)


class _FusedIntermediateTap:
    """Loud guard on a fused intermediate stream's junction: events sent
    directly (InputHandler / another app element added later) cannot
    enter the middle of a fused device program."""

    def __init__(self, stream_id: str, chain: str):
        self.stream_id = stream_id
        self.chain = chain

    def receive(self, batch):
        raise SiddhiAppRuntimeError(
            f"stream '{self.stream_id}' is fused device-resident inside "
            f"chain '{self.chain}'; direct injection is not supported — "
            "remove @app:fuse to restore junction dispatch")


def _query_inputs(q: Query) -> List[str]:
    """Stream ids a query consumes (with multiplicity); inner/fault
    streams come back with their junction-key prefix so they can never
    collide with a fusable hop target."""
    out: List[str] = []

    def _single(s: SingleInputStream):
        if s.is_fault:
            out.append("!" + s.stream_id)
        elif s.is_inner:
            out.append("#" + s.stream_id)
        else:
            out.append(s.stream_id)

    def walk(ins):
        if isinstance(ins, SingleInputStream):
            _single(ins)
        elif isinstance(ins, JoinInputStream):
            for side in (ins.left, ins.right):
                if isinstance(side, SingleInputStream):
                    _single(side)
                else:
                    walk(side)
        elif isinstance(ins, StateInputStream):
            out.extend(ins.stream_ids())
        elif isinstance(ins, AnonymousInputStream):
            walk(ins.query.input_stream)

    walk(q.input_stream)
    return out


def _insert_target(q: Query) -> Optional[str]:
    """The query's `insert into` target when it is a plain (non-inner,
    non-fault) CURRENT-event stream insert; None otherwise."""
    out = q.output_stream
    if not isinstance(out, InsertIntoStream):
        return None
    if out.is_inner or out.is_fault:
        return None
    if getattr(out, "event_type", "current") != "current":
        return None
    return out.target


def plan_fused_chains(app) -> Dict[int, QueryRuntime]:
    """Detect and lower fused chains; returns pre-planned runtimes keyed
    by ``id(query_ast)`` for the build loop to consume.  Queries absent
    from the map plan normally.  ``app`` is the app runtime being
    built."""
    sa = app.siddhi_app
    ctx = app.app_context

    def fallback(qname: str, reason: str):
        log.warning("query '%s': fused chain unavailable (%s); using "
                    "junction dispatch", qname, reason)
        note_fallback(ctx, "fused", qname, reason)

    # -- top-level queries with their plan() names ---------------------------
    entries: List[Tuple[Query, str]] = []
    qi = 0
    for element in sa.execution_elements:
        if isinstance(element, Query):
            info = find_annotation(element.annotations, "info")
            name = (info.element("name") if info else None) or f"query_{qi}"
            entries.append((element, name))
            qi += 1

    # -- producer / consumer maps --------------------------------------------
    producers: Dict[str, List[int]] = {}
    consumers: Dict[str, List[int]] = {}
    for i, (q, _name) in enumerate(entries):
        t = _insert_target(q)
        if t is not None:
            producers.setdefault(t, []).append(i)
        for sid in _query_inputs(q):
            consumers.setdefault(sid, []).append(i)
    # streams observed outside the top-level query set: partitions,
    # aggregations — any such observer pins the stream to its junction
    other: Set[str] = set()
    for element in sa.execution_elements:
        if isinstance(element, Partition):
            for pq in element.queries:
                other.update(_query_inputs(pq))
            for pt in element.partition_types:
                other.add(getattr(pt, "stream_id", ""))
    for ad in sa.aggregation_definitions.values():
        other.add(ad.input_stream.stream_id)

    def hop_reason(t: str) -> Optional[str]:
        """None when stream ``t`` may fuse away; else why not."""
        if t in sa.table_definitions:
            return f"'{t}' is a table — table hops stay host-side"
        if t in sa.window_definitions:
            return f"'{t}' is a named window — CURRENT+EXPIRED semantics"
        if t in sa.aggregation_definitions:
            return f"'{t}' feeds an aggregation"
        if t in sa.trigger_definitions:
            return f"'{t}' is a trigger stream"
        if len(producers.get(t, [])) != 1:
            return f"stream '{t}' has multiple producers"
        if t in other:
            return (f"stream '{t}' is consumed by a partition or "
                    "aggregation")
        # multiplicity within ONE consumer is fine (a pattern tail may
        # reference its input stream at several automaton nodes); the
        # stage gates validate that shape
        cons = sorted(set(consumers.get(t, [])))
        if len(cons) != 1:
            return (f"stream '{t}' needs exactly one consumer query "
                    f"(has {len(cons)})")
        d = sa.stream_definitions.get(t)
        if d is not None:
            ann = [a.name for a in getattr(d, "annotations", [])]
            if ann:
                # @async buffering, @sink publication, @OnError routing,
                # @source all require real junction dispatch
                return (f"stream '{t}' is annotated "
                        f"({', '.join('@' + a for a in sorted(ann))}) — "
                        "junction semantics required")
        return None

    # -- chain edges ---------------------------------------------------------
    nxt: Dict[int, Tuple[int, str]] = {}
    prev: Dict[int, int] = {}
    for t, prods in producers.items():
        reason = hop_reason(t)
        if reason is not None:
            # only a would-be hop is a fallback; a terminal output
            # stream with no consumers is just the chain's end
            if (consumers.get(t) or t in sa.table_definitions
                    or t in sa.window_definitions
                    or t in sa.aggregation_definitions):
                fallback(entries[prods[0]][1], reason)
            continue
        p, c = prods[0], consumers[t][0]
        if p == c:
            fallback(entries[p][1], f"stream '{t}' forms a self-loop")
            continue
        nxt[p] = (c, t)
        prev[c] = p

    # -- maximal chains (in-degree/out-degree <= 1 => simple paths) ----------
    fused: Dict[int, QueryRuntime] = {}
    seen: Set[int] = set()
    for start in sorted(nxt):
        if start in seen or start in prev:
            continue
        run: List[int] = [start]
        hops: List[str] = []
        node = start
        while node in nxt:
            node, t = nxt[node]
            if node in run:  # cycle guard (unreachable with in-deg <= 1)
                break
            run.append(node)
            hops.append(t)
        seen.update(run)
        while len(run) >= 2:
            planned = _try_lower_chain(app, entries, run, hops, fallback)
            if planned is not None:
                fused.update(planned)
                break
            # _try_lower_chain recorded the failing stage; retry the
            # prefix without it (the truncated tail's junction output is
            # re-planned normally by the build loop)
            run = run[:-1]
            hops = hops[:-1]
    return fused


def _stage_gate(q: Query, name: str, is_tail: bool):
    """Cheap AST-level eligibility for a chain member; raises with the
    fallback reason."""
    out = q.output_stream
    if out is not None and getattr(out, "event_type", "current") != "current":
        raise SiddhiAppCreationError("device path emits CURRENT events only")
    if not is_tail:
        if not isinstance(q.input_stream, SingleInputStream):
            raise SiddhiAppCreationError(
                "interior stages must be single-input queries")
        if q.output_rate is not None:
            raise SiddhiAppCreationError(
                "an intermediate output rate limit needs a host decision "
                "mid-chain")
        sel = q.selector
        if sel.order_by or sel.limit is not None or sel.offset is not None:
            raise SiddhiAppCreationError(
                "an intermediate order by/limit slices rows mid-chain")
    elif not isinstance(q.input_stream,
                        (SingleInputStream, StateInputStream)):
        raise SiddhiAppCreationError(
            "join tails need the host join planner")
    if q.selector.group_by:
        raise SiddhiAppCreationError(
            "group-by stages keep per-group emission state host-side")


def _try_lower_chain(app, entries, run: List[int], hops: List[str],
                     fallback) -> Optional[Dict[int, QueryRuntime]]:
    """Build engines + runtime wiring for one chain; returns the planned
    runtimes or None after recording the failing stage's reason (caller
    retries the prefix)."""
    sa = app.siddhi_app
    ctx = app.app_context
    chain_names = [entries[i][1] for i in run]
    chain_label = "->".join(chain_names)
    # a replan pin is an exact path: a member pinned away from 'fuse'
    # (e.g. {'q1': 'device'}) leaves the chain to per-query planning
    for nm in chain_names:
        p = ctx.plan_pins.get(nm)
        if p is not None and "fuse" not in str(p).split("+"):
            log.info("chain %s: member '%s' pinned to '%s' — chain left "
                     "to per-query planning", chain_label, nm, p)
            return {}

    # synthesize undeclared intermediate defs from producer schemas as
    # we go; declared defs must match the producer's output exactly
    # (the junction path's insert-into contract)
    stages: List = []
    # DOUBLE attrs of the CURRENT hop def that are f32-exact (computed
    # on-device, not forwarded from an original f64 input column)
    exact_f64: Set[str] = set()
    dense_tail = None
    dense_key: Optional[str] = None
    inter_defs: List[StreamDefinition] = []

    for pos, idx in enumerate(run):
        q, name = entries[idx]
        is_tail = pos == len(run) - 1
        try:
            _stage_gate(q, name, is_tail)
            if is_tail and isinstance(q.input_stream, StateInputStream):
                dense_tail, dense_key = _build_dense_tail(
                    app, q, hops[pos - 1], inter_defs)
                break
            s = q.input_stream
            if pos == 0:
                definition = app.resolve_stream_definition(s)
                if not (s.is_inner or s.is_fault):
                    if (s.stream_id in app.named_windows
                            or s.stream_id in app.tables
                            or s.stream_id in getattr(
                                app, "aggregations", {})):
                        raise SiddhiAppCreationError(
                            "named-window/table/aggregation inputs need "
                            "the host planner")
            else:
                definition = inter_defs[pos - 1]
            engine = DeviceQueryEngine(
                q, definition,
                n_groups=ctx.tpu_partitions,
                partition_mode=False,
                defer_order_by=True,
                device=ctx.device,
            )
            if not is_tail:
                exact_f64 = _check_hop_def(
                    sa, hops[pos], engine, exact_f64, inter_defs)
            else:
                for kind, v, _nm in engine.out_spec:
                    if kind != "passthrough":
                        continue
                    at = definition.attribute_type(v)
                    if at in _EXACT_TAIL_TYPES:
                        continue
                    if at == AttrType.DOUBLE and v in exact_f64:
                        continue
                    raise SiddhiAppCreationError(
                        f"tail passthrough of {at.name} attribute '{v}' "
                        "would lose precision on the device lane")
            stages.append(engine)
        except SiddhiAppCreationError as e:
            fallback(name, f"chain {chain_label}: {e}")
            return None

    try:
        graph = FusedGraphEngine(stages, dense_tail, dense_key)
    except SiddhiAppCreationError as e:
        fallback(chain_names[-1], f"chain {chain_label}: {e}")
        return None
    return _wire_chain(app, entries, run, hops, graph, chain_label)


def _check_hop_def(sa, t: str, engine, exact_f64: Set[str],
                   inter_defs: List[StreamDefinition]) -> Set[str]:
    """Validate (or synthesize) the intermediate stream def for hop
    ``t`` against the producer engine's output schema; appends the def
    used and returns the next hop's f32-exact DOUBLE attr set."""
    out_names = list(engine.output_names)
    out_types = list(engine.out_types)
    for nm, at in zip(out_names, out_types):
        if at not in _LANE_TYPES:
            raise SiddhiAppCreationError(
                f"intermediate attribute '{nm}' is {at.name} — no "
                "device-resident lane between stages")
    d = sa.stream_definitions.get(t)
    if d is not None:
        if (d.attribute_names != out_names
                or [a.type for a in d.attributes] != out_types):
            raise SiddhiAppCreationError(
                f"stream '{t}' schema differs from the producer's "
                "output — junction coercion required")
    else:
        d = StreamDefinition(id=t, attributes=[
            Attribute(nm, at) for nm, at in zip(out_names, out_types)])
    inter_defs.append(d)
    # a DOUBLE stays f32-exact through an expr (computed in f32 on both
    # paths) and through a passthrough of an already-exact value
    nxt: Set[str] = set()
    for kind, v, nm in engine.out_spec:
        if kind == "expr":
            nxt.add(nm)
        elif kind == "passthrough" and v in exact_f64:
            nxt.add(nm)
    return nxt


def _build_dense_tail(app, q: Query, in_stream: str,
                      inter_defs: List[StreamDefinition]):
    """Dense-pattern tail over the last intermediate stream.  The fused
    form covers the unpartitioned passthrough-selector subset; the
    engine itself re-raises for everything deeper."""
    st = q.input_stream
    sids = st.stream_ids()
    if len(set(sids)) != 1 or sids[0] != in_stream:
        raise SiddhiAppCreationError(
            "pattern tails must read the chain's intermediate stream "
            "only")
    sel = q.selector
    if sel.group_by or sel.having is not None or has_aggregators(sel):
        raise SiddhiAppCreationError(
            "aggregating pattern selectors need host match rows")

    # the intermediate defs may be synthesized (undeclared `insert into`
    # targets) — resolve those ahead of the app registry
    by_id = {d.id: d for d in inter_defs}

    def resolver(s):
        if (isinstance(s, SingleInputStream)
                and not (s.is_inner or s.is_fault)
                and s.stream_id in by_id):
            return by_id[s.stream_id]
        return app.resolve_stream_definition(s)

    ctx = app.app_context
    engine = build_dense_engine(
        q, st, resolver, 1, n_instances=ctx.tpu_instances,
        device=ctx.device)
    return engine, engine.stream_keys[0]


def _wire_chain(app, entries, run: List[int], hops: List[str],
                graph, chain_label: str) -> Dict[int, QueryRuntime]:
    """Plan the chain's QueryRuntimes around one FusedChainRuntime: the
    tail query owns the runtime (selector/output/rate-limiter exactly as
    its standalone device form), interior queries get inert runtimes so
    names, persistence layout and ``lowering()`` stay uniform."""
    ctx = app.app_context
    tail_q, tail_name = entries[run[-1]]
    if graph.dense is not None:
        out_types = output_attr_types(graph.dense)
    else:
        out_types = graph.stages[-1].out_types
    out_target = (getattr(tail_q.output_stream, "target", None)
                  or f"__ret_{tail_name}")
    out_attrs = [Attribute(nm, t)
                 for nm, t in zip(graph.output_names, out_types)]
    selector = passthrough_selector(
        tail_q.selector, graph.output_names, out_target)
    out_def = StreamDefinition(id=out_target, attributes=out_attrs)
    output = plan_output(app, tail_q, out_def, tail_name)
    rate_limiter = plan_rate_limiter(tail_q)
    qr = QueryRuntime(tail_name, [[]], selector, rate_limiter, output, ctx)

    runtime = FusedChainRuntime(
        graph, f"#fused_{tail_name}", emit=lambda b: qr.process(b, 0),
        emit_depth=ctx.tpu_emit_depth,
        clock=ctx.timestamp_generator.current_time,
        ingest_depth=ctx.tpu_ingest_depth, faults=ctx.fault_injector,
        tracer=ctx.tracer)
    qr.device_runtime = runtime

    head_q, _hn = entries[run[0]]
    junction = app.junction_for_input(head_q.input_stream)
    junction.subscribe(FusedChainReceiver(runtime))
    app.scheduler.register_task(runtime)
    if rate_limiter.needs_scheduler_task:
        app.scheduler.register_task(
            _RateLimiterTask(qr, rate_limiter, device_runtime=runtime))
    qr.lowered_to = "fused"

    planned: Dict[int, QueryRuntime] = {id(tail_q): qr}

    # interior queries: the junction path would register one runtime per
    # name — keep that registry (and its duplicate-name check) intact
    # with inert placeholders whose work lives inside the fused step.
    # Their intermediate junctions stay registered (when declared) with
    # a loud tap against direct injection.
    for pos, idx in enumerate(run[:-1]):
        q, name = entries[idx]
        iqr = QueryRuntime(
            name, [[]],
            passthrough_selector(
                q.selector, graph.stages[pos].output_names, hops[pos]),
            PassThroughRateLimiter(),
            _InertOutput(), ctx)
        iqr.lowered_to = "fused"
        planned[id(q)] = iqr
        if hops[pos] in app.junctions:
            app.junctions[hops[pos]].subscribe(
                _FusedIntermediateTap(hops[pos], chain_label))
    # the members' plan records (the per-query planning never sees them)
    sm = ctx.statistics_manager
    if sm is not None:
        n_total = len(graph.stages) + (1 if graph.dense is not None else 0)
        for idx in run:
            nm = entries[idx][1]
            rec = fused_plan_record(nm, ctx, n_total)
            rec.actual = "fused"
            sm.register_plan(nm, rec)
    log.info("fused chain %s: %d stages lowered to one device step",
             chain_label, len(graph.stages)
             + (1 if graph.dense is not None else 0))
    return planned


class _InertOutput:
    """Output slot of an interior chain query: its emission happens
    inside the fused step, so nothing ever flows through here."""

    def send(self, batch, now):  # pragma: no cover - unreachable by design
        raise SiddhiAppRuntimeError(
            "interior fused-chain queries emit inside the fused device "
            "program")
