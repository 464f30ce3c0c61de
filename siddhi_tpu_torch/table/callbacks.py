"""Table output callbacks: insert / delete / update / update-or-insert.

Port of the JAX package's ``table/callbacks.py`` (the reference's
``query/output/callback/``: InsertIntoTableCallback, DeleteTableCallback,
UpdateTableCallback, UpdateOrInsertTableCallback): the selector's output batch is the
matching-side event set; each row probes the table through the compiled
condition (pk/index/scan plan) and mutates matched slots.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.core.query import OutputCallback
from siddhi_tpu_torch.planner.host_expr import CompiledExpression, ExpressionCompiler, Scope
from siddhi_tpu_torch.query_api import SetAttribute, Variable
from siddhi_tpu_torch.table.table import CompiledTableCondition, InMemoryTable, _merge_table_scope


def _select_types(batch: EventBatch, event_type: str) -> EventBatch:
    if event_type == "current":
        return batch.only(ev.CURRENT)
    if event_type == "expired":
        return batch.only(ev.EXPIRED)
    return batch.only(ev.CURRENT, ev.EXPIRED)


def _event_env(batch: EventBatch, i: int) -> Dict:
    env = {nm: batch.columns[nm][i] for nm in batch.attribute_names}
    from siddhi_tpu_torch.planner.host_expr import N_KEY, TS_KEY

    env[TS_KEY] = batch.timestamps[i]
    env[N_KEY] = 1
    return env


def _require_covering_schema(table: InMemoryTable, output_names: Optional[List[str]], what: str):
    if output_names is None:
        return
    missing = [nm for nm in table.definition.attribute_names if nm not in output_names]
    if missing:
        raise SiddhiAppCreationError(
            f"{what} '{table.table_id}': output is missing table attribute(s) {missing}"
        )


class InsertIntoTableCallback(OutputCallback):
    """insert into <table> (reference: InsertIntoTableCallback.java)."""

    def __init__(self, table: InMemoryTable, event_type: str, output_names: Optional[List[str]] = None):
        self.table = table
        self.event_type = event_type
        _require_covering_schema(table, output_names, "insert into table")

    def send(self, batch: EventBatch, now: int):
        out = _select_types(batch, self.event_type)
        if len(out) == 0:
            return
        if out.attribute_names != self.table.definition.attribute_names:
            # project by name (validated to cover the table at plan time)
            cols = {nm: out.columns[nm] for nm in self.table.definition.attribute_names}
            out = EventBatch(
                self.table.table_id,
                self.table.definition.attribute_names,
                cols,
                out.timestamps,
                out.types,
            )
        self.table.insert(out)


class DeleteTableCallback(OutputCallback):
    """<query> delete <table> on <cond> (reference: DeleteTableCallback)."""

    def __init__(self, table: InMemoryTable, condition: CompiledTableCondition, event_type: str):
        self.table = table
        self.condition = condition
        self.event_type = event_type

    def send(self, batch: EventBatch, now: int):
        out = _select_types(batch, self.event_type)
        for i in range(len(out)):
            slots = self.condition.slots_matching(_event_env(out, i))
            if len(slots):
                self.table.delete_slots(slots)


class _SetOp:
    __slots__ = ("attr", "compiled")

    def __init__(self, attr: str, compiled: CompiledExpression):
        self.attr = attr
        self.compiled = compiled


def compile_set_clause(
    table: InMemoryTable,
    set_clause: Optional[List[SetAttribute]],
    event_scope: Scope,
    output_names: List[str],
    functions: Optional[Dict] = None,
    table_resolver=None,
) -> List[_SetOp]:
    """Compile `set T.a = expr, ...`; default (no clause) copies every
    output attribute whose name matches a table attribute (reference:
    UpdateTableCallback default set semantics)."""
    scope = _merge_table_scope(event_scope, table)
    compiler = ExpressionCompiler(scope, functions=functions, table_resolver=table_resolver)
    ops: List[_SetOp] = []
    if set_clause is None:
        table_names = set(table.definition.attribute_names)
        shared = [nm for nm in output_names if nm in table_names]
        if not shared:
            raise SiddhiAppCreationError(
                f"update {table.table_id}: no output attribute matches a table attribute"
            )
        for nm in shared:
            ops.append(_SetOp(nm, compiler.compile(Variable(attribute=nm))))
        return ops
    for sa in set_clause:
        v = sa.variable
        if v.stream_id not in (None, table.table_id) or (
            v.attribute not in table.definition.attribute_names
        ):
            raise SiddhiAppCreationError(
                f"set target '{v.stream_id}.{v.attribute}' is not an attribute "
                f"of table '{table.table_id}'"
            )
        ops.append(_SetOp(v.attribute, compiler.compile(sa.expression)))
    return ops


class UpdateTableCallback(OutputCallback):
    """<query> update <table> set ... on <cond>."""

    def __init__(
        self,
        table: InMemoryTable,
        condition: CompiledTableCondition,
        set_ops: List[_SetOp],
        event_type: str,
    ):
        self.table = table
        self.condition = condition
        self.set_ops = set_ops
        self.event_type = event_type

    def send(self, batch: EventBatch, now: int):
        out = _select_types(batch, self.event_type)
        for i in range(len(out)):
            env = _event_env(out, i)
            slots = self.condition.slots_matching(env)
            if len(slots):
                self._apply(slots, env)

    def _apply(self, slots: np.ndarray, env: Dict):
        env = dict(env)
        env.update(self.table.column_env(slots))
        values = {
            op.attr: np.broadcast_to(np.asarray(op.compiled.fn(env)), (len(slots),))
            for op in self.set_ops
        }
        self.table.update_slots(slots, values)


class UpdateOrInsertTableCallback(UpdateTableCallback):
    """<query> update or insert into <table> set ... on <cond>: rows with
    no match insert the output event as a new table row (reference:
    UpdateOrInsertTableCallback)."""

    def __init__(self, table, condition, set_ops, event_type, output_names=None):
        super().__init__(table, condition, set_ops, event_type)
        # a PARTIAL projection is allowed (reference
        # UpdateOrInsertTableTestCase.updateOrInsertTableTest5: `select
        # comp as symbol, vol as volume update or insert ...`): matched
        # rows update only the projected columns; the insert path fills
        # unprojected columns with null
        self._projected = (
            None if output_names is None
            else [nm for nm in table.definition.attribute_names
                  if nm in output_names])

    def send(self, batch: EventBatch, now: int):
        out = _select_types(batch, self.event_type)
        names = (self._projected if self._projected is not None
                 else self.table.definition.attribute_names)
        for i in range(len(out)):
            env = _event_env(out, i)
            slots = self.condition.slots_matching(env)
            if len(slots):
                self._apply(slots, env)
            else:
                row = {
                    nm: (out.columns[nm][i] if nm in names else None)
                    for nm in self.table.definition.attribute_names
                }
                with self.table._lock:
                    self.table._insert_row(row, int(out.timestamps[i]))
