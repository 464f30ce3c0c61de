"""On-demand (pull) queries over an incremental aggregation.

Port of the FIND half of the JAX package's ``core/on_demand.py`` for
aggregations: ``rt.query("from A [on cond] within lo, hi per 'seconds'
select ... [order by ...] [limit n] [offset m];")``.  ``within`` takes
epoch-ms values, datetime strings or one wildcard pattern; the select
takes output attributes or scalar expressions over them (or ``*``).
Rows come from ``AggregationRuntime.find``, then the ``on`` filter, the
projection and ``order by``/``offset``/``limit``, as the reference's
one-shot selector applies them to a run without aggregators.

Other forms raise ``StoreQueryCreationError`` naming the slice of the
port they wait for: tables and named windows, insert/update/delete, and
selects with aggregators, ``group by`` or ``having`` (the query
selector of the device-query slice).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from siddhi_tpu_torch.core.event import Event, EventBatch, events_from_batch
from siddhi_tpu_torch.core.exceptions import StoreQueryCreationError
from siddhi_tpu_torch.core.query import build_env
from siddhi_tpu_torch.planner.host_expr import (
    AGGREGATOR_NAMES,
    N_KEY,
    ExpressionCompiler,
    Scope,
)
from siddhi_tpu_torch.query_api import (
    AttrType,
    Expression,
    FunctionCall,
    OnDemandQuery,
    Variable,
)

_SELECTOR = " — the query selector of the device-query slice of the port"


def _has_aggregator(expr) -> bool:
    if not isinstance(expr, Expression):
        return False
    if isinstance(expr, FunctionCall):
        if expr.namespace is None and expr.name in AGGREGATOR_NAMES:
            return True
        return any(_has_aggregator(a) for a in expr.args)
    return any(_has_aggregator(getattr(expr, f, None))
               for f in ("left", "right", "expr"))


class OnDemandQueryRuntime:
    """One compiled FIND over an aggregation, re-executable (the app
    runtime caches up to 50, as the reference does)."""

    def __init__(self, odq: OnDemandQuery, app_runtime):
        self.odq = odq
        self.app = app_runtime
        self._plan()

    def _plan(self):
        odq = self.odq
        if odq.type != "find" or odq.input_store is None:
            raise StoreQueryCreationError(
                f"on-demand {odq.type}: insert/update/delete target tables "
                "— a later slice of the port")
        self.store = self.app.aggregations.get(odq.input_store)
        if self.store is None:
            raise StoreQueryCreationError(
                f"on-demand query: no aggregation named '{odq.input_store}' "
                "(tables and named windows — a later slice of the port)")
        if odq.per is None:
            raise StoreQueryCreationError(
                f"aggregation '{odq.input_store}': 'per' clause is required")
        ref = odq.input_alias or odq.input_store
        attrs = list(self.store.output_definition.attributes)
        scope = Scope()
        for a in attrs:
            scope.add(ref, a.name, a.name, a.type)
        if odq.input_alias:
            scope.add_alias(odq.input_store, ref)
        compiler = ExpressionCompiler(scope)

        self.condition = None
        if odq.on_condition is not None:
            c = compiler.compile(odq.on_condition)
            if c.type != AttrType.BOOL:
                raise StoreQueryCreationError("'on' condition must be boolean")
            self.condition = c
        self.per = compiler.compile(odq.per)
        self.within = None
        if odq.within is not None:
            start, end = odq.within
            self.within = (compiler.compile(start),
                           compiler.compile(end) if end is not None else None)

        sel = odq.selector
        if sel.group_by or sel.having is not None or any(
                _has_aggregator(oa.expression) for oa in sel.selection or ()):
            raise StoreQueryCreationError(
                "on-demand query: aggregators, 'group by' and 'having'"
                + _SELECTOR)
        self.items = None
        if sel.is_select_all:
            self.out_names = [a.name for a in attrs]
        else:
            self.items = []
            for oa in sel.selection:
                nm = oa.rename or (oa.expression.attribute
                                   if isinstance(oa.expression, Variable)
                                   else None)
                if nm is None:
                    raise StoreQueryCreationError(
                        "select expression needs 'as <name>'")
                self.items.append((nm, compiler.compile(oa.expression)))
            self.out_names = [nm for nm, _c in self.items]
        self.order_by = []
        for ob in sel.order_by:
            if ob.variable.attribute not in self.out_names:
                raise StoreQueryCreationError(
                    f"order by attribute '{ob.variable.attribute}' not in "
                    "select output")
            self.order_by.append((ob.variable.attribute, ob.ascending))

        def const_int(e) -> Optional[int]:
            return None if e is None else int(compiler.compile(e).fn({N_KEY: 0}))

        self.limit = const_int(sel.limit)
        self.offset = const_int(sel.offset)

    # -- execution ----------------------------------------------------------

    def _rows(self) -> EventBatch:
        from siddhi_tpu_torch.aggregation.runtime import within_bounds

        env = {N_KEY: 0}
        per = str(np.asarray(self.per.fn(env)).ravel()[0])
        within = None
        if self.within is not None:
            start_c, end_c = self.within
            v1 = np.asarray(start_c.fn(env)).ravel()[0]
            v2 = (np.asarray(end_c.fn(env)).ravel()[0]
                  if end_c is not None else None)
            within = within_bounds(v1, v2)
        return self.store.find(per, within)

    def execute(self) -> List[Event]:
        rows = self._rows()
        if len(rows) and self.condition is not None:
            mask = np.broadcast_to(
                np.asarray(self.condition.fn(build_env(rows))), (len(rows),))
            rows = rows.mask(mask)
        if len(rows) == 0:
            return []
        n = len(rows)
        if self.items is None:
            cols = {nm: rows.columns[nm] for nm in self.out_names}
        else:
            env = build_env(rows)
            cols: Dict[str, np.ndarray] = {}
            for nm, compiled in self.items:
                col = np.asarray(compiled.fn(env))
                cols[nm] = (np.broadcast_to(col, (n,)).copy()
                            if col.ndim == 0 else col)
        out = EventBatch("__on_demand", self.out_names, cols, rows.timestamps,
                         rows.types)
        return events_from_batch(self._order_limit(out))

    def _order_limit(self, out: EventBatch) -> EventBatch:
        """``order by`` (stable, right-to-left; nulls last either way),
        then ``offset`` and ``limit``, as the reference's selector."""
        if self.order_by:
            idx = np.arange(len(out))
            for name, asc in reversed(self.order_by):
                col = np.asarray(out.columns[name][idx])
                nulls = None
                if col.dtype == object:
                    nulls = np.frompyfunc(
                        lambda x: x is None, 1, 1)(col).astype(bool)
                    if not nulls.any():
                        nulls = None
                if nulls is None:
                    _, dense = np.unique(col, return_inverse=True)
                    key = dense if asc else -dense
                else:
                    nn = col[~nulls]
                    key = np.zeros(len(col), dtype=np.int64)
                    if len(nn):
                        _, dense_nn = np.unique(nn, return_inverse=True)
                        key[~nulls] = dense_nn if asc else -dense_nn
                    key[nulls] = (int(key[~nulls].max()) + 1
                                  if len(nn) else 0)
                idx = idx[np.argsort(key, kind="stable")]
            out = out.take(idx)
        if self.offset is not None:
            out = out.take(np.arange(min(self.offset, len(out)), len(out)))
        if self.limit is not None:
            out = out.take(np.arange(0, min(self.limit, len(out))))
        return out
