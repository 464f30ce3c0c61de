"""Query planning for the dense pattern path.

Port of ``_plan_dense_state`` of the JAX package's
``planner/query_planner.py`` for what the port runs: a pattern query
with a non-aggregating passthrough select (event references only, no
order by, limit or output rate), planned onto a ``DensePatternRuntime``
and, when partitioned under ``@app:hotkeys``, wrapped in the hot-key
router (the reference's ``:731-741``).  A partitioned query gets the
partition count of ``@app:execution('tpu', partitions=...)`` and the
partition receiver's interned keys; an unpartitioned one runs at one
partition, fed by ``DenseStreamReceiver`` (the reference's ``:531-566``
and ``:637``).  Matches go to the query's ``insert into`` stream
junction.  An engine with absent deadlines registers its runtime as an
app scheduler task (the reference's ``:777-782``).
"""

from __future__ import annotations

from typing import Optional

from siddhi_tpu_torch.core.dense_pattern import (
    DensePatternRuntime,
    DenseStreamReceiver,
    build_dense_engine,
    output_attr_types,
)
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.planner.hotkeys import try_wrap_hotkey
from siddhi_tpu_torch.query_api import (
    Attribute,
    InsertIntoStream,
    Query,
    StateInputStream,
    StreamDefinition,
)
from siddhi_tpu_torch.query_api.annotation import find_annotation

_LATER = " — a later slice of the port"


class QueryRuntime:
    """A planned pattern query: its pattern processor (the dense runtime
    or the router around it) and the junction its matches go to."""

    def __init__(self, name: str, out_junction):
        self.name = name
        self.out_junction = out_junction
        self.pattern_processor = None
        self.lowered_to = "dense"

    def process(self, batch: EventBatch):
        """A match batch → the output stream, as the passthrough
        selector does: the same columns, relabelled to the stream."""
        self.out_junction.send(EventBatch(
            self.out_junction.stream_id, batch.attribute_names,
            batch.columns, batch.timestamps, batch.types))


def check_insert_into(query: Query, where: str) -> None:
    """The port's dense queries write only ``insert into <stream>``."""
    out = query.output_stream
    if not isinstance(out, InsertIntoStream) or out.is_inner or out.is_fault:
        raise SiddhiAppCreationError(
            f"{where}: only 'insert into <stream>' outputs are in the port; "
            "inner, fault, table and return outputs" + _LATER)


def plan_unpartitioned_query(app, query: Query, index: int) -> QueryRuntime:
    """Plan a query outside any partition: a pattern under
    ``@app:execution('tpu')`` runs on the dense engine at one partition
    (the reference's ``_plan_state`` → ``_plan_dense_state`` with no key
    function), fed by one ``DenseStreamReceiver`` per source stream.
    Raises for what the port does not run."""
    info = find_annotation(query.annotations, "info")
    name = (info.element("name") if info else None) or f"query_{index}"
    if not isinstance(query.input_stream, StateInputStream):
        raise SiddhiAppCreationError(
            f"query '{name}': unpartitioned non-pattern queries (the host "
            "query runtime and the device query path, ROADMAP.md §1 items "
            "3 and 6)" + _LATER)
    if app.app_context.execution_mode != "tpu":
        raise SiddhiAppCreationError(
            f"query '{name}': the port runs patterns on the dense device "
            "path only (add @app:execution('tpu')); the host pattern "
            "engine" + _LATER)
    check_insert_into(query, f"query '{name}'")
    qr = plan_dense_state(app, query, name, query.input_stream,
                          n_partitions=1)
    runtime = qr.pattern_processor
    for sk in runtime.engine.stream_keys:
        app.junctions[sk].subscribe(DenseStreamReceiver(runtime, sk))
    return qr


def plan_dense_state(app, query: Query, name: str, st,
                     n_partitions: Optional[int] = None) -> QueryRuntime:
    """Plan a pattern query onto the dense engine (``n_partitions``: the
    app's partition count, 1 for an unpartitioned query); raises
    SiddhiAppCreationError when it is outside what the port runs."""
    ctx = app.app_context
    if n_partitions is None:
        n_partitions = ctx.tpu_partitions
    if query.output_rate is not None:
        raise SiddhiAppCreationError(
            "dense path: partitioned queries with output rate limits need "
            "per-key limiters" + _LATER if n_partitions > 1 else
            "dense path: output rate limits need the host query runtime "
            "(ROADMAP.md §1 item 3)" + _LATER)
    engine = build_dense_engine(
        query, st, app.resolve_stream_definition, n_partitions,
        n_instances=ctx.tpu_instances, device=ctx.device)
    out_def = StreamDefinition(id=query.output_stream.target, attributes=[
        Attribute(nm, t)
        for nm, t in zip(engine.output_names, output_attr_types(engine))])
    qr = QueryRuntime(name, app.output_junction(out_def))
    runtime = DensePatternRuntime(
        engine, f"#matches_{name}", emit=qr.process,
        emit_depth=ctx.tpu_emit_depth, ingest_depth=ctx.tpu_ingest_depth)
    # @app:hotkeys: wrap the partitioned passthrough pattern in the skew
    # router (heavy keys ride the fused scan, cold keys stay dense)
    if ctx.hotkeys and n_partitions > 1:
        wrapped = try_wrap_hotkey(ctx, app.definitions, st, runtime, name)
        if wrapped is not None:
            runtime = wrapped
            qr.lowered_to = wrapped.lowered_to
    qr.pattern_processor = runtime
    if engine.has_deadlines:
        # absent deadlines fire from the app scheduler (the router
        # refuses deadline engines, so this is the dense runtime)
        ctx.scheduler.register_task(runtime)
    return qr
