"""Eligibility gates and lowering for device-resident tables.

Port of the JAX package's ``devtable/planner.py``.  Two planner entry
points live here, both raising ``SiddhiAppCreationError`` with a
human-readable reason when a query does not fit the device path —
callers catch that, log a WARNING and keep the reason in the app
context's ``devtable_fallbacks`` (the reference's statistics counters
come with ``ROADMAP.md`` §1 item 15c), then fall back to the host table
path.  Results never change; only the placement does.

``try_plan_devtable_join``
    Lowers an inner stream-table join onto ``DevTableJoinRuntime``
    when exactly one side is a live ``DeviceTable``, the stream side
    is bare (no window/filters/aggregation, triggering), and the
    condition carries a primary-key equality conjunct whose event
    expression evaluates host-side from stream attributes alone.
    Residual conjuncts are fine — the probe evaluates the FULL
    condition on device lanes — but every attribute the condition
    touches must ride a device lane (INT/FLOAT/BOOL), and the condition
    must compile with the device query path's compiler and evaluate
    over small lane tensors (the reference traces it under jit).

``plan_devtable_mutation``
    Lowers delete / update / update-or-insert callbacks to the
    batched ``DeviceTable`` scatter entry points when the ``on``
    condition is a single primary-key equality and the set clause is
    event-only.  The returned callbacks keep the generic host-path
    callback around and delegate whole batches to it when a runtime
    shape the kernel cannot express shows up (primary-key rewrites,
    insert/update interleaving on one slot) — counted, never wrong.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

import torch

from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.devtable.join import DevTableJoinRuntime
from siddhi_tpu_torch.devtable.storage import _LANE_DTYPES, DeviceTable
from siddhi_tpu_torch.ops.device_query import DeviceQueryCompiler
from siddhi_tpu_torch.planner.host_expr import (
    N_KEY,
    TS_KEY,
    ExpressionCompiler,
    Scope,
)
from siddhi_tpu_torch.query_api import (
    AndOp,
    DeleteStream,
    JoinInputStream,
    UpdateOrInsertStream,
    UpdateStream,
)
from siddhi_tpu_torch.query_api.attribute import AttrType
from siddhi_tpu_torch.query_api.expression import (
    CompareOp,
    Expression,
    Variable,
)
from siddhi_tpu_torch.table.callbacks import (
    DevTableDeleteCallback,
    DevTableUpdateCallback,
    DevTableUpsertCallback,
)
from siddhi_tpu_torch.table.table import _equality_terms


def _gate(name: str, why: str) -> SiddhiAppCreationError:
    return SiddhiAppCreationError(f"query '{name}': devtable ineligible: {why}")


class _Recorder(dict):
    """Env dict that records which lanes a compiled fn actually reads.
    A read of a key outside the available lane set raises KeyError —
    the caller turns that into an eligibility gate."""

    def __init__(self, avail: Dict):
        super().__init__(avail)
        self.used = set()

    def __getitem__(self, k):
        self.used.add(k)
        return super().__getitem__(k)


def _split_conjuncts(e: Expression) -> List[Expression]:
    if isinstance(e, AndOp):
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _refs_side(e: Expression, ids: Tuple) -> bool:
    """Does the expression reference (by qualifier) any of the ids?"""
    if isinstance(e, Variable):
        return e.stream_id in ids
    for f in ("left", "right", "expr"):
        sub = getattr(e, f, None)
        if isinstance(sub, Expression) and _refs_side(sub, ids):
            return True
    for a in getattr(e, "args", ()) or ():
        if isinstance(a, Expression) and _refs_side(a, ids):
            return True
    return False


def _pk_key_expr(name: str, cond: Expression, table: DeviceTable,
                 table_ids: Tuple) -> Expression:
    """Find a ``T.pk == <event expr>`` conjunct; return the event expr."""
    for term in _split_conjuncts(cond):
        if not (isinstance(term, CompareOp) and term.op == "=="):
            continue
        for tv, ot in ((term.left, term.right), (term.right, term.left)):
            if (isinstance(tv, Variable) and tv.attribute == table.pk
                    and tv.stream_id in table_ids
                    and not _refs_side(ot, table_ids)):
                return ot
    raise _gate(name, f"no primary-key equality conjunct on "
                      f"'{table.table_id}.{table.pk}'")


def try_plan_devtable_join(name: str, j, left, right, condition,
                           compiler: ExpressionCompiler, emit,
                           app_context, probe_scope: Scope
                           ) -> DevTableJoinRuntime:
    """Gate + lower a join to ``DevTableJoinRuntime``; raises
    ``SiddhiAppCreationError`` naming the first failed gate.
    ``probe_scope``: the join scope the device condition compiles in."""
    dev_left = isinstance(left.table, DeviceTable)
    dev_right = isinstance(right.table, DeviceTable)
    if not (dev_left or dev_right):
        raise _gate(name, "no device-resident table side")
    if dev_left and dev_right:
        raise _gate(name, "both sides are device tables")
    table_side, stream_side = (left, right) if dev_left else (right, left)
    stream_is_left = not dev_left
    table = table_side.table
    if table.demoted:
        raise _gate(name, "table already demoted to host")
    if j.join_type not in (JoinInputStream.JOIN, JoinInputStream.INNER_JOIN):
        raise _gate(name, f"join type '{j.join_type}' (inner only)")
    if condition is None:
        raise _gate(name, "no 'on' condition")
    if (stream_side.table is not None or stream_side.aggregation is not None
            or stream_side.window is not None
            or stream_side.named_window is not None or stream_side.filters):
        raise _gate(name, "stream side carries filters/window")
    if not stream_side.triggers:
        raise _gate(name, "stream side does not trigger")

    table_ids = (table_side.ref, table.table_id)
    key_ast = _pk_key_expr(name, j.on_condition, table, table_ids)
    key_c = compiler.compile(key_ast)
    if key_c.type != AttrType.INT:
        raise _gate(name, f"key expression type {key_c.type} (INT required)")

    # the key evaluates host-side from stream lanes alone
    stream_env = {
        stream_side.qualified_key(a.name): np.zeros(4, dtype=a.type.np_dtype)
        for a in stream_side.definition.attributes
    }
    kenv = _Recorder(stream_env)
    kenv[TS_KEY] = np.zeros(4, dtype=np.int64)
    kenv[N_KEY] = 4
    try:
        np.broadcast_to(key_c.fn(kenv), (4,))
    except Exception as e:
        raise _gate(name, f"key expression not stream-only ({e})")

    # the full condition evaluates on device lanes: INT/FLOAT/BOOL stream
    # attrs + every table attr (DeviceTable admits lane dtypes only)
    avail: Dict[str, np.ndarray] = {}
    stream_lanes: Dict[str, Tuple[str, np.dtype]] = {}
    for a in stream_side.definition.attributes:
        dt = _LANE_DTYPES.get(a.type)
        if dt is None:
            continue
        ek = stream_side.qualified_key(a.name)
        avail[ek] = np.zeros(4, dtype=dt)
        stream_lanes[ek] = (a.name, dt)
    for a in table.definition.attributes:
        avail[table_side.qualified_key(a.name)] = np.zeros(
            4, dtype=table._dtypes[a.name])
    # pass 1 (numpy): record which lanes the condition actually reads —
    # touching anything outside the lane env (STRING/LONG attrs, the
    # timestamp key) raises KeyError here and keeps the host join
    rec = _Recorder(avail)
    rec[N_KEY] = 4
    try:
        np.broadcast_to(condition.fn(rec), (4,))
    except Exception as e:
        raise _gate(name, f"condition not device-evaluable ({e})")
    # pass 2: the device form compiles and evaluates over lane tensors
    try:
        device_condition = DeviceQueryCompiler(probe_scope, ()).compile(
            j.on_condition)
        env = {k: torch.from_numpy(v) for k, v in avail.items()}
        env[N_KEY] = 4
        device_condition.fn(env)
    except Exception as e:
        raise _gate(name, f"condition not device-traceable ({e})")
    used = {ek: stream_lanes[ek] for ek in rec.used if ek in stream_lanes}

    return DevTableJoinRuntime(
        name, stream_side, table_side, stream_is_left,
        condition, key_c, used,
        out_stream_id=f"#join_{name}", emit=emit,
        emit_depth=app_context.tpu_emit_depth,
        ingest_depth=app_context.tpu_ingest_depth,
        clock=app_context.timestamp_generator.current_time,
        device=table.device, device_condition=device_condition,
    )


def plan_devtable_mutation(name: str, out, out_def, out_scope: Scope,
                           table: DeviceTable, generic,
                           functions=None, table_resolver=None):
    """Gate + lower a delete/update/upsert output to the batched
    ``DeviceTable`` entry points; raises ``SiddhiAppCreationError``
    when the host path must keep the query."""
    if table.demoted:
        raise _gate(name, "table already demoted to host")
    if out.on_condition is None:
        raise _gate(name, "no 'on' condition")
    terms, only_conj = _equality_terms(out.on_condition, table)
    if not only_conj or len(terms) != 1 or terms[0][0] != table.pk:
        raise _gate(name, "condition is not a single primary-key equality")
    compiler = ExpressionCompiler(out_scope, functions=functions,
                                  table_resolver=table_resolver)
    try:
        key_c = compiler.compile(terms[0][1])
    except SiddhiAppCreationError as e:
        raise _gate(name, f"key expression not event-only ({e})")
    if key_c.type != AttrType.INT:
        raise _gate(name, f"key expression type {key_c.type} (INT required)")

    output_names = [a.name for a in out_def.attributes]
    if isinstance(out, DeleteStream):
        return DevTableDeleteCallback(table, key_c, out.event_type)

    tbl_attrs = set(table.definition.attribute_names)
    set_ops: List[Tuple[str, object]] = []
    if out.set_clause is None:
        shared = [nm for nm in output_names if nm in tbl_attrs]
        if not shared:
            raise _gate(name, "default set clause shares no attributes")
        for nm in shared:
            set_ops.append((nm, compiler.compile(Variable(attribute=nm))))
    else:
        for sa in out.set_clause:
            v = sa.variable
            if v.stream_id not in (None, table.table_id) or \
                    v.attribute not in tbl_attrs:
                raise _gate(name, f"set target '{v.attribute}' is not a "
                                  "table attribute")
            try:
                set_ops.append((v.attribute, compiler.compile(sa.expression)))
            except SiddhiAppCreationError as e:
                raise _gate(name, f"set expression not event-only ({e})")

    if isinstance(out, UpdateStream):
        return DevTableUpdateCallback(table, key_c, set_ops, out.event_type,
                                      generic)
    if isinstance(out, UpdateOrInsertStream):
        missing = tbl_attrs - set(output_names)
        if missing:
            raise _gate(name, "update-or-insert output does not cover table "
                              f"attributes {sorted(missing)}")
        return DevTableUpsertCallback(table, key_c, set_ops, out.event_type,
                                      generic)
    raise _gate(name, f"output type {type(out).__name__}")
