"""Query planning for the dense pattern path.

Port of ``_plan_dense_state`` of the JAX package's
``planner/query_planner.py`` for what this slice runs: a partitioned
pattern query with a non-aggregating passthrough select (event
references only, no order by, limit or output rate), planned onto a
``DensePatternRuntime`` and, under ``@app:hotkeys``, wrapped in the
hot-key router (the reference's ``:731-741``).  Matches go to the
query's ``insert into`` stream junction.
"""

from __future__ import annotations

from typing import Optional

from siddhi_tpu_torch.core.dense_pattern import (
    DensePatternRuntime,
    build_dense_engine,
    output_attr_types,
)
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.planner.hotkeys import try_wrap_hotkey
from siddhi_tpu_torch.query_api import Attribute, Query, StreamDefinition


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


def plan_dense_state(app, query: Query, name: str, st,
                     n_partitions: Optional[int] = None) -> QueryRuntime:
    """Plan a partitioned pattern query onto the dense engine; raises
    SiddhiAppCreationError when it is outside what the port runs."""
    ctx = app.app_context
    if n_partitions is None:
        n_partitions = ctx.tpu_partitions
    if query.output_rate is not None:
        raise SiddhiAppCreationError(
            "dense path: partitioned queries with output rate limits need "
            "per-key limiters — a later slice of the port")
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
    return qr
