"""On-demand (pull) queries: ``runtime.query("from Table select ...")``.

Port of the JAX package's ``core/on_demand.py`` (the reference's
``query/OnDemandQueryRuntime.java`` and
``util/parser/OnDemandQueryParser.java:101``): a pull query targets a table,
named window, or incremental aggregation; FIND evaluates the compiled
condition vectorized over the store's row batch and applies a one-shot
selector (projection / group-by / aggregators / having / order-limit);
INSERT / DELETE / UPDATE / UPDATE-OR-INSERT build a single synthetic row
from the select clause and reuse the table mutation callbacks.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from siddhi_tpu_torch.core.event import Event, EventBatch, events_from_batch
from siddhi_tpu_torch.core.exceptions import StoreQueryCreationError
from siddhi_tpu_torch.core.query import QuerySelector, SelectItem, build_env
from siddhi_tpu_torch.planner.host_expr import N_KEY, TS_KEY, ExpressionCompiler, Scope
from siddhi_tpu_torch.planner.query_planner import AggregatorRewrite
from siddhi_tpu_torch.query_api import (
    Attribute,
    AttrType,
    OnDemandQuery,
    Variable,
)


def _rewrite_stream_refs(expr, old_ref: str, new_ref: str):
    """Replace Variable stream references 'old_ref.x' -> 'new_ref.x'
    throughout an expression tree (frozen dataclasses -> rebuild)."""
    import dataclasses

    from siddhi_tpu_torch.query_api import expression as X

    def walk(e):
        if isinstance(e, X.Variable):
            if e.stream_id == old_ref:
                return dataclasses.replace(e, stream_id=new_ref)
            return e
        if isinstance(e, X.FunctionCall):
            return dataclasses.replace(e, args=tuple(walk(a) for a in e.args))
        changes = {}
        for f in ("left", "right", "expr"):
            child = getattr(e, f, None)
            if isinstance(child, X.Expression):
                changes[f] = walk(child)
        return dataclasses.replace(e, **changes) if changes else e

    return walk(expr)


class OnDemandQueryRuntime:
    """One compiled on-demand query, re-executable (the reference caches
    these in SiddhiAppRuntimeImpl.onDemandQueryRuntimeMap, cap 50)."""

    def __init__(self, odq: OnDemandQuery, app_runtime):
        self.odq = odq
        self.app = app_runtime
        self.type = odq.type
        self._plan()

    # -- planning -----------------------------------------------------------

    def _source(self, name: str):
        """table | named window | aggregation by id."""
        t = self.app.tables.get(name)
        if t is not None:
            return ("table", t)
        w = self.app.named_windows.get(name)
        if w is not None:
            return ("window", w)
        a = self.app.aggregations.get(name)
        if a is not None:
            return ("aggregation", a)
        raise StoreQueryCreationError(
            f"on-demand query: no table/window/aggregation named '{name}'"
        )

    def _store_attributes(self, kind, store) -> List[Attribute]:
        if kind == "aggregation":
            return list(store.output_definition.attributes)
        return list(store.definition.attributes)

    def _plan(self):
        odq = self.odq
        if odq.type == "find" or (odq.input_store is not None and odq.type in (
            "delete", "update", "update_or_insert"
        )):
            self.kind, self.store = self._source(odq.input_store)
        else:
            # `select ... insert into T` / `... update T ...` forms
            target = odq.output_stream.target
            self.kind, self.store = self._source(target)
            if self.kind != "table":
                raise StoreQueryCreationError(
                    f"on-demand {odq.type}: '{target}' is not a table"
                )

        ref = odq.input_alias or odq.input_store or self.store.definition.id
        attrs = self._store_attributes(self.kind, self.store)

        scope = Scope()
        for a in attrs:
            scope.add(ref, a.name, a.name, a.type)
        if odq.input_store is not None and odq.input_alias:
            scope.add_alias(odq.input_store, ref)
        self.scope = scope
        self.compiler = ExpressionCompiler(
            scope,
            functions=getattr(self.app, "functions", None),
            table_resolver=getattr(self.app, "table_resolver", None),
        )

        # condition over store rows
        self.condition = None
        self._pushdown = None
        if odq.on_condition is not None:
            c = self.compiler.compile(odq.on_condition)
            if c.type != AttrType.BOOL:
                raise StoreQueryCreationError("'on' condition must be boolean")
            self.condition = c
            if self.kind == "table":
                from siddhi_tpu_torch.table.record import RecordTableRuntime

                if isinstance(self.store, RecordTableRuntime):
                    # push the condition to the external store instead of
                    # fetching every record and filtering host-side; an
                    # input alias is normalized to the table id first so
                    # the merged table scope resolves it
                    from siddhi_tpu_torch.table.table import compile_table_condition

                    cond = odq.on_condition
                    if odq.input_alias and odq.input_alias != self.store.table_id:
                        cond = _rewrite_stream_refs(
                            cond, odq.input_alias, self.store.table_id)
                    self._pushdown = compile_table_condition(
                        self.store, cond, Scope(),
                        extra_functions=getattr(self.app, "functions", None),
                        table_resolver=getattr(self.app, "table_resolver", None),
                    )
                    self.condition = None

        # aggregation access clauses
        self.per = None
        self.within = None
        if self.kind == "aggregation":
            if odq.per is None:
                raise StoreQueryCreationError(
                    f"aggregation '{odq.input_store}': 'per' clause is required"
                )
            self.per = self.compiler.compile(odq.per)
            if odq.within is not None:
                start, end = odq.within
                self.within = (
                    self.compiler.compile(start),
                    self.compiler.compile(end) if end is not None else None,
                )
        elif odq.per is not None or odq.within is not None:
            raise StoreQueryCreationError(
                "'within'/'per' clauses only apply to aggregations"
            )

        # selector
        sel = odq.selector
        rewriter = AggregatorRewrite(
            scope, self.compiler,
            extensions=getattr(self.app, "extensions", None))
        items: Optional[List[SelectItem]] = None
        out_attrs: List[Attribute] = []
        if sel.is_select_all:
            out_attrs = list(attrs)
            out_names = [a.name for a in attrs]
        else:
            items = []
            for oa in sel.selection:
                rewritten = rewriter.rewrite(oa.expression)
                compiled = self.compiler.compile(rewritten)
                nm = oa.rename or (
                    oa.expression.attribute
                    if isinstance(oa.expression, Variable)
                    else None
                )
                if nm is None:
                    raise StoreQueryCreationError(
                        "select expression needs 'as <name>'"
                    )
                items.append(SelectItem(nm, compiled))
                out_attrs.append(Attribute(nm, compiled.type))
            out_names = [i.name for i in items]
            for a in out_attrs:
                scope.add_bare(a.name, a.type)
        group_keys = [self.compiler.compile(g) for g in sel.group_by]
        having = (
            self.compiler.compile(rewriter.rewrite(sel.having))
            if sel.having is not None
            else None
        )
        order_by = []
        for ob in sel.order_by:
            if ob.variable.attribute not in out_names:
                raise StoreQueryCreationError(
                    f"order by attribute '{ob.variable.attribute}' not in select output"
                )
            order_by.append((ob.variable.attribute, ob.ascending))

        def const_int(e):
            if e is None:
                return None
            return int(self.compiler.compile(e).fn({N_KEY: 0}))

        self._selector_args = (
            items, out_names, rewriter.bindings, group_keys, having,
            order_by, const_int(sel.limit), const_int(sel.offset),
        )
        self.output_attributes = out_attrs
        self.out_names = out_names

        # mutation plumbing
        if odq.type in ("update", "update_or_insert"):
            from siddhi_tpu_torch.table.callbacks import compile_set_clause

            set_clause = getattr(odq.output_stream, "set_clause", None)
            event_scope = Scope()
            for a in out_attrs:
                event_scope.add_bare(a.name, a.type)
            self.set_ops = compile_set_clause(
                self._target_table(), set_clause, event_scope, out_names
            )
            self.mutate_condition = self._compile_table_condition(event_scope)
        elif odq.type == "delete":
            event_scope = Scope()
            for a in out_attrs:
                event_scope.add_bare(a.name, a.type)
            self.mutate_condition = self._compile_table_condition(event_scope)

    def _target_table(self):
        if self.odq.input_store is not None:
            if self.kind != "table":
                raise StoreQueryCreationError(
                    f"on-demand {self.odq.type} targets a table, got {self.kind}"
                )
            return self.store
        return self.store

    def _compile_table_condition(self, event_scope: Scope):
        from siddhi_tpu_torch.table.table import compile_table_condition

        cond = getattr(self.odq.output_stream, "on_condition", None)
        if cond is None:
            cond = self.odq.on_condition
        return compile_table_condition(
            self._target_table(), cond, event_scope,
            extra_functions=getattr(self.app, "functions", None),
            table_resolver=getattr(self.app, "table_resolver", None),
        )

    # -- execution ----------------------------------------------------------

    def _rows(self) -> Optional[EventBatch]:
        if self.kind == "table":
            if self._pushdown is not None:
                slots = self._pushdown.slots_matching({N_KEY: 1})
                return self.store.rows_batch(slots)
            return self.store.rows_batch()
        if self.kind == "window":
            return self.store.buffered()
        # aggregation
        from siddhi_tpu_torch.aggregation.runtime import within_bounds

        env = {N_KEY: 0}
        per = str(np.asarray(self.per.fn(env)).ravel()[0])
        within = None
        if self.within is not None:
            start_c, end_c = self.within
            v1 = np.asarray(start_c.fn(env)).ravel()[0]
            v2 = np.asarray(end_c.fn(env)).ravel()[0] if end_c is not None else None
            within = within_bounds(v1, v2)
        return self.store.find(per, within)

    def execute(self) -> List[Event]:
        # pull queries race the event path and the wall-clock scheduler;
        # both mutate store state under the app's process lock
        with self.app.app_context.process_lock:
            return self._execute_locked()

    def _execute_locked(self) -> List[Event]:
        odq = self.odq
        if odq.type == "find":
            return self._execute_find()
        if odq.type == "insert":
            row = self._synthetic_row()
            from siddhi_tpu_torch.table.callbacks import InsertIntoTableCallback

            InsertIntoTableCallback(
                self._target_table(), "current", self.out_names
            ).send(row, 0)
            return []
        if odq.type == "delete":
            row = self._synthetic_row()
            from siddhi_tpu_torch.table.callbacks import DeleteTableCallback

            DeleteTableCallback(
                self._target_table(), self.mutate_condition, "current"
            ).send(row, 0)
            return []
        if odq.type == "update":
            row = self._synthetic_row()
            from siddhi_tpu_torch.table.callbacks import UpdateTableCallback

            UpdateTableCallback(
                self._target_table(), self.mutate_condition, self.set_ops, "current"
            ).send(row, 0)
            return []
        if odq.type == "update_or_insert":
            row = self._synthetic_row()
            from siddhi_tpu_torch.table.callbacks import UpdateOrInsertTableCallback

            UpdateOrInsertTableCallback(
                self._target_table(), self.mutate_condition, self.set_ops,
                "current", self.out_names,
            ).send(row, 0)
            return []
        raise StoreQueryCreationError(f"unknown on-demand query type '{odq.type}'")

    def _execute_find(self) -> List[Event]:
        rows = self._rows()
        if rows is None or len(rows) == 0:
            return []
        if self.condition is not None:
            env = build_env(rows)
            mask = np.broadcast_to(np.asarray(self.condition.fn(env)), (len(rows),))
            rows = rows.mask(mask)
            if len(rows) == 0:
                return []
        items, out_names, bindings, group_keys, having, order_by, limit, offset = (
            self._selector_args
        )
        # fresh selector per execution: aggregator state must not leak
        # between pulls; batch_mode emits one row per group
        selector = QuerySelector(
            "__on_demand", items, out_names,
            bindings,
            group_keys, having, order_by, limit, offset,
            batch_mode=True,
        )
        out = selector.process(rows, 0)
        return events_from_batch(out)

    def _synthetic_row(self) -> EventBatch:
        """Evaluate the select clause on a single empty row (constants +
        functions only) — the matching-side event of mutation queries."""
        items, out_names, bindings, *_ = self._selector_args
        if items is None:
            raise StoreQueryCreationError(
                f"on-demand {self.odq.type}: explicit select clause required"
            )
        if bindings:
            raise StoreQueryCreationError(
                f"on-demand {self.odq.type}: aggregators not allowed in select"
            )
        env = {N_KEY: 1, TS_KEY: np.zeros(1, dtype=np.int64)}
        cols: Dict[str, np.ndarray] = {}
        for item in items:
            v = np.asarray(item.compiled.fn(env))
            cols[item.name] = v.reshape(1) if v.ndim == 0 else v[:1]
        return EventBatch("__on_demand", out_names, cols, np.zeros(1, dtype=np.int64))
