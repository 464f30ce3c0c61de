"""Record tables: external-store-backed tables behind a Python SPI.

Port of the JAX package's ``table/record.py``, the reference's
record-table layer (``table/record/AbstractRecordTable.java`` — add/find/contains/delete/
update/updateOrAdd against an external store with compiled conditions,
``AbstractQueryableRecordTable.java`` — store-side condition push-down,
``table/CacheTable.java`` — FIFO/LRU/LFU caching in front of the store,
``table/record/RecordTableHandler.java`` — interception hook).

Instead of the reference's visitor-built store-native query strings, a
condition compiles to a small **portable IR** (And/Or/Not/Compare/IsNull
over table attributes, with event-side subexpressions turned into named
parameters evaluated per lookup).  Stores interpret as much of the IR as
they can; the runtime always re-verifies fetched rows with the full
vectorized predicate, so a store may ignore the IR entirely and scan.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.extension.registry import extension
from siddhi_tpu_torch.planner.host_expr import CompiledExpression, ExpressionCompiler, Scope
from siddhi_tpu_torch.query_api import AttrType
from siddhi_tpu_torch.query_api import expression as X
from siddhi_tpu_torch.table.table import TBL, _merge_table_scope, _scalar


# ---------------------------------------------------------------------------
# Portable condition IR handed to stores
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StoreConst:
    value: object


@dataclass(frozen=True)
class StoreParam:
    """Named parameter filled per lookup from the matching-side event."""

    key: str


@dataclass(frozen=True)
class StoreCompare:
    attr: str
    op: str  # '<', '<=', '>', '>=', '==', '!='
    rhs: object  # StoreConst | StoreParam


@dataclass(frozen=True)
class StoreIsNull:
    attr: str


@dataclass(frozen=True)
class StoreAnd:
    parts: tuple


@dataclass(frozen=True)
class StoreOr:
    parts: tuple


@dataclass(frozen=True)
class StoreNot:
    part: object


@dataclass(frozen=True)
class StoreTrue:
    """Matches every record (store should full-scan)."""


_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "==", "!=": "!="}


class _StoreConditionBuilder:
    """Expression AST -> (IR, param expressions).

    Push-down is conservative: a subtree is pushed only when it is a
    comparison between one bare table attribute and an event-side
    expression (or constants), composed with and/or/not.  Unpushable
    subtrees inside a conjunction are dropped from the IR (the runtime's
    post-filter keeps exactness); anywhere else the whole condition
    falls back to StoreTrue.
    """

    def __init__(self, table_id: str, table_attrs: List[str], event_compiler: ExpressionCompiler):
        self.table_id = table_id
        self.table_attrs = set(table_attrs)
        self.event_compiler = event_compiler
        self.params: Dict[str, CompiledExpression] = {}

    def build(self, e: X.Expression):
        ir = self._conj(e)
        return ir if ir is not None else StoreTrue()

    # conjunction level: drop unpushable conjuncts
    def _conj(self, e: X.Expression):
        if isinstance(e, X.AndOp):
            left, right = self._conj(e.left), self._conj(e.right)
            if left is None:
                return right
            if right is None:
                return left
            return StoreAnd((left, right))
        return self._strict(e)

    # below a NOT/OR everything must be pushable or nothing is
    def _strict(self, e: X.Expression):
        if isinstance(e, X.AndOp):
            left, right = self._strict(e.left), self._strict(e.right)
            if left is None or right is None:
                return None
            return StoreAnd((left, right))
        if isinstance(e, X.OrOp):
            left, right = self._strict(e.left), self._strict(e.right)
            if left is None or right is None:
                return None
            return StoreOr((left, right))
        if isinstance(e, X.NotOp):
            part = self._strict(e.expr)
            return StoreNot(part) if part is not None else None
        if isinstance(e, X.IsNull):
            attr = self._table_attr(e.expr)
            return StoreIsNull(attr) if attr is not None else None
        if isinstance(e, X.CompareOp):
            lattr, rattr = self._table_attr(e.left), self._table_attr(e.right)
            if lattr is not None and rattr is None and not self._refs_table(e.right):
                return StoreCompare(lattr, e.op, self._operand(e.right))
            if rattr is not None and lattr is None and not self._refs_table(e.left):
                return StoreCompare(rattr, _FLIP[e.op], self._operand(e.left))
            return None
        if isinstance(e, X.Constant) and e.value is True:
            return StoreTrue()
        return None

    def _table_attr(self, e: X.Expression) -> Optional[str]:
        if isinstance(e, X.Variable) and e.attribute in self.table_attrs:
            if e.stream_id == self.table_id or e.stream_id is None:
                return e.attribute
        return None

    def _refs_table(self, e: X.Expression) -> bool:
        if isinstance(e, X.Variable):
            return self._table_attr(e) is not None or e.stream_id == self.table_id
        for attr in ("left", "right", "expr"):
            child = getattr(e, attr, None)
            if isinstance(child, X.Expression) and self._refs_table(child):
                return True
        if isinstance(e, X.FunctionCall):
            return any(self._refs_table(a) for a in e.args)
        return False

    def _operand(self, e: X.Expression):
        if isinstance(e, X.Constant):
            return StoreConst(e.value)
        if isinstance(e, X.TimeConstant):
            return StoreConst(e.value)
        key = f"p{len(self.params)}"
        self.params[key] = self.event_compiler.compile(e)
        return StoreParam(key)


def evaluate_store_condition(ir, record: Dict, params: Dict) -> bool:
    """Reference interpreter for the IR over one record dict — used by
    InMemoryRecordStore and available to any store without a native
    query language."""
    if isinstance(ir, StoreTrue):
        return True
    if isinstance(ir, StoreAnd):
        return all(evaluate_store_condition(p, record, params) for p in ir.parts)
    if isinstance(ir, StoreOr):
        return any(evaluate_store_condition(p, record, params) for p in ir.parts)
    if isinstance(ir, StoreNot):
        return not evaluate_store_condition(ir.part, record, params)
    if isinstance(ir, StoreIsNull):
        return record.get(ir.attr) is None
    if isinstance(ir, StoreCompare):
        a = record.get(ir.attr)
        b = ir.rhs.value if isinstance(ir.rhs, StoreConst) else params[ir.rhs.key]
        op = ir.op
        if op == "==":
            return a == b
        if op == "!=":
            return a != b
        if a is None or b is None:
            return False
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        return a >= b
    raise SiddhiAppCreationError(f"unknown store-condition node {type(ir).__name__}")


# ---------------------------------------------------------------------------
# Store SPI
# ---------------------------------------------------------------------------


class AbstractRecordTable:
    """External-store SPI (reference: AbstractRecordTable.java:87-409).

    Subclasses implement the record operations; records are lists in
    table-attribute order.  ``find`` receives the portable condition IR
    and a per-lookup parameter dict; a store may interpret it fully,
    partially, or return a superset — the runtime re-verifies rows.
    """

    def init(self, definition, options: Dict[str, str], config_reader=None):
        self.definition = definition
        self.options = options
        self.config_reader = config_reader

    def connect(self):
        pass

    def disconnect(self):
        pass

    # -- record operations -------------------------------------------------

    def add(self, records: List[list]):
        raise NotImplementedError

    def find(self, condition, params: Dict) -> Iterable[list]:
        raise NotImplementedError

    def contains(self, condition, params: Dict) -> bool:
        for _ in self.find(condition, params):
            return True
        return False

    def delete(self, condition, params_list: List[Dict]):
        raise NotImplementedError

    def update(self, condition, params_list: List[Dict], set_maps: List[Dict]):
        raise NotImplementedError

    def update_or_add(self, condition, params_list: List[Dict],
                      set_maps: List[Dict], records: List[list]):
        """Default: update matches; add a record for params with none."""
        for params, set_map, record in zip(params_list, set_maps, records):
            if self.contains(condition, params):
                self.update(condition, [params], [set_map])
            else:
                self.add([record])


class RecordTableHandler:
    """Interception hook around store operations (reference:
    RecordTableHandler.java).  Subclass and override; default passes
    through."""

    def on_add(self, records, call: Callable):
        return call(records)

    def on_find(self, condition, params, call: Callable):
        return call(condition, params)

    def on_delete(self, condition, params_list, call: Callable):
        return call(condition, params_list)

    def on_update(self, condition, params_list, set_maps, call: Callable):
        return call(condition, params_list, set_maps)


@extension("store", "memory")
class InMemoryRecordStore(AbstractRecordTable):
    """List-backed record store: the reference implementation of the SPI
    and the test double for store-backed tables (the analog of the
    reference's test ``testStoreContainingInMemoryTable``)."""

    _shared: Dict[str, List[list]] = {}
    _shared_locks: Dict[str, threading.RLock] = {}
    _shared_lock = threading.Lock()

    def init(self, definition, options, config_reader=None):
        super().init(definition, options, config_reader)
        self._names = list(definition.attribute_names)
        if options.get("shared", "false").lower() == "true":
            # rows outlive the runtime, keyed by table name — mirrors the
            # reference test stores' static backing map, letting restart
            # tests see a store that persisted across app instances.
            # The guarding lock must be shared too: per-instance locks
            # over shared rows would let two runtimes race on mutation.
            with self._shared_lock:
                self._rows = self._shared.setdefault(definition.id, [])
                self._lock = self._shared_locks.setdefault(
                    definition.id, threading.RLock())
        else:
            self._rows = []
            self._lock = threading.RLock()

    def _as_dict(self, row: list) -> Dict:
        return dict(zip(self._names, row))

    def add(self, records):
        with self._lock:
            self._rows.extend(list(r) for r in records)

    def find(self, condition, params):
        with self._lock:
            return [list(r) for r in self._rows
                    if evaluate_store_condition(condition, self._as_dict(r), params)]

    def delete(self, condition, params_list):
        with self._lock:
            for params in params_list:
                self._rows[:] = [
                    r for r in self._rows
                    if not evaluate_store_condition(condition, self._as_dict(r), params)
                ]

    def update(self, condition, params_list, set_maps):
        with self._lock:
            for params, set_map in zip(params_list, set_maps):
                for r in self._rows:
                    if evaluate_store_condition(condition, self._as_dict(r), params):
                        for attr, v in set_map.items():
                            r[self._names.index(attr)] = v


# ---------------------------------------------------------------------------
# Cache layer
# ---------------------------------------------------------------------------


class TableCache:
    """Primary-key row cache with FIFO / LRU / LFU eviction and
    optional time-based retention (reference: CacheTable.java +
    CacheTableFIFO/LRU/LFU with retention.period from @cache; unlike
    the reference's CacheExpirer thread, expired entries are dropped
    lazily on access and swept on insert)."""

    def __init__(self, max_size: int, policy: str = "FIFO",
                 retention_ms: Optional[int] = None, now_fn=None):
        policy = policy.upper()
        if policy not in ("FIFO", "LRU", "LFU"):
            raise SiddhiAppCreationError(f"unknown cache policy '{policy}'")
        if max_size < 1:
            raise SiddhiAppCreationError(
                f"@cache size must be >= 1, got {max_size}")
        self.max_size = max_size
        self.policy = policy
        self.retention_ms = retention_ms
        self._now = now_fn or (lambda: int(time.time() * 1000))
        self._d: "OrderedDict" = OrderedDict()
        self._freq: Dict = {}
        # key -> insert ms, kept oldest-first (stamps are clamped
        # monotone) so the retention sweep walks only the expired prefix
        self._added: "OrderedDict" = OrderedDict()
        self._last_stamp = 0
        self.hits = 0
        self.misses = 0

    def _expired(self, key) -> bool:
        return (self.retention_ms is not None
                and self._now() - self._added.get(key, 0)
                >= self.retention_ms)

    def get(self, key):
        if key in self._d and self._expired(key):
            self.invalidate(key)
        if key not in self._d:
            self.misses += 1
            return None
        self.hits += 1
        if self.policy == "LRU":
            self._d.move_to_end(key)
        elif self.policy == "LFU":
            self._freq[key] = self._freq.get(key, 0) + 1
        return self._d[key]

    def put(self, key, row):
        if self.retention_ms is not None:
            # clamp against backwards clock steps so stamps stay
            # monotone and the oldest-first prefix sweep stays sound
            now = max(self._now(), self._last_stamp)
            self._last_stamp = now
            while self._added:
                k, t = next(iter(self._added.items()))
                if now - t < self.retention_ms:
                    break
                self.invalidate(k)
            self._added[key] = now
            self._added.move_to_end(key)  # refresh keeps oldest-first
        if key in self._d:
            self._d[key] = row
            if self.policy == "LRU":
                self._d.move_to_end(key)
            return
        while len(self._d) >= self.max_size:
            self._evict_one()
        self._d[key] = row
        if self.policy == "LFU":
            self._freq[key] = 1

    def _evict_one(self):
        if self.policy == "LFU":
            victim = min(self._d, key=lambda k: self._freq.get(k, 0))
            self._d.pop(victim)
            self._freq.pop(victim, None)
        else:  # FIFO inserts at the back; LRU moves hits to the back
            victim, _ = self._d.popitem(last=False)
        self._added.pop(victim, None)

    def invalidate(self, key):
        self._d.pop(key, None)
        self._freq.pop(key, None)
        self._added.pop(key, None)

    def clear(self):
        self._d.clear()
        self._freq.clear()
        self._added.clear()

    def __len__(self):
        return len(self._d)


# ---------------------------------------------------------------------------
# Engine-facing runtime
# ---------------------------------------------------------------------------


class RecordTableRuntime:
    """Presents the InMemoryTable surface (insert / compiled-condition
    find / slot delete / slot update / contains) on top of a store SPI.

    "Slots" are positions in the most recent fetch; every mutating slot
    operation is translated back into a store condition (primary-key
    equality when a key is defined, full-row equality otherwise), which
    is how the reference maps chunk operations onto record stores.
    """

    def __init__(self, definition, store: AbstractRecordTable,
                 cache: Optional[TableCache] = None,
                 handler: Optional[RecordTableHandler] = None):
        from siddhi_tpu_torch.query_api.annotation import find_annotation

        self.definition = definition
        self.table_id = definition.id
        self.store = store
        self.cache = cache
        self.handler = handler or RecordTableHandler()
        self._lock = threading.RLock()

        pk_ann = find_annotation(definition.annotations, "PrimaryKey")
        self.primary_keys: Optional[List[str]] = None
        if pk_ann is not None:
            self.primary_keys = [v for _, v in pk_ann.elements] or None
        self.indexes: Dict[str, Dict] = {}  # stores own their indexing

        names = definition.attribute_names
        self._names = list(names)
        # fetch staging area: last materialized find
        self._fetch_rows: List[list] = []

        # pre-built IR: match one row by primary key / by full row
        if self.primary_keys:
            self._row_ir = StoreAnd(tuple(
                StoreCompare(k, "==", StoreParam(k)) for k in self.primary_keys
            )) if len(self.primary_keys) > 1 else StoreCompare(
                self.primary_keys[0], "==", StoreParam(self.primary_keys[0]))
            self._row_params = list(self.primary_keys)
        else:
            self._row_ir = StoreAnd(tuple(
                StoreCompare(nm, "==", StoreParam(nm)) for nm in self._names
            ))
            self._row_params = list(self._names)

    # -- basics -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._find(StoreTrue(), {}))

    @property
    def size(self) -> int:
        return len(self)

    def _pk_key(self, row: list):
        vals = tuple(row[self._names.index(k)] for k in self.primary_keys)
        return vals[0] if len(vals) == 1 else vals

    def _row_param_map(self, row: list) -> Dict:
        return {k: row[self._names.index(k)] for k in self._row_params}

    def _find(self, ir, params: Dict) -> List[list]:
        return list(self.handler.on_find(ir, params, self.store.find))

    # -- engine surface ------------------------------------------------------

    def insert(self, batch: EventBatch):
        rows = [[_scalar(batch.columns[nm][i]) for nm in self._names]
                for i in range(len(batch))]
        if not rows:
            return
        with self._lock:
            self.handler.on_add(rows, self.store.add)
            if self.cache is not None and self.primary_keys:
                for r in rows:
                    self.cache.put(self._pk_key(r), r)

    def _insert_row(self, row: Dict, ts: int):
        """Single-row insert used by update-or-insert's miss branch
        (signature matches InMemoryTable._insert_row; callers hold
        self._lock).  Pk-duplicate rows replace via the store."""
        rec = [_scalar(row[nm]) for nm in self._names]
        if self.primary_keys:
            params = self._row_param_map(rec)
            if self.store.contains(self._row_ir, params):
                set_map = dict(zip(self._names, rec))
                self.handler.on_update(
                    self._row_ir, [params], [set_map], self.store.update)
                if self.cache is not None:
                    self.cache.put(self._pk_key(rec), rec)
                return
        self.handler.on_add([rec], self.store.add)
        if self.cache is not None and self.primary_keys:
            self.cache.put(self._pk_key(rec), rec)

    def live_slots(self) -> np.ndarray:
        with self._lock:
            self._fetch_rows = self._find(StoreTrue(), {})
            return np.arange(len(self._fetch_rows), dtype=np.int64)

    def fetch_matching(self, ir, params: Dict, pk_probe_key=None) -> np.ndarray:
        """Run a store find (through the cache for primary-key probes),
        stage the rows, and return their slot ids."""
        with self._lock:
            if pk_probe_key is not None and self.cache is not None:
                row = self.cache.get(pk_probe_key)
                if row is not None:
                    self._fetch_rows = [row]
                    return np.arange(1, dtype=np.int64)
            rows = self._find(ir, params)
            if pk_probe_key is not None and self.cache is not None and len(rows) == 1:
                self.cache.put(pk_probe_key, rows[0])
            self._fetch_rows = rows
            return np.arange(len(rows), dtype=np.int64)

    def rows_batch(self, slots: Optional[np.ndarray] = None) -> EventBatch:
        with self._lock:
            if slots is None:
                self.live_slots()
                slots = np.arange(len(self._fetch_rows), dtype=np.int64)
            rows = [self._fetch_rows[int(s)] for s in slots]
            types = [a.type for a in self.definition.attributes]
            cols = {
                nm: np.asarray([r[i] for r in rows],
                               dtype=types[i].np_dtype)
                for i, nm in enumerate(self._names)
            }
            return EventBatch(self.table_id, self._names, cols,
                              np.zeros(len(rows), dtype=np.int64))

    def column_env(self, slots: np.ndarray) -> Dict[str, np.ndarray]:
        b = self.rows_batch(slots)
        return {TBL + nm: b.columns[nm] for nm in self._names}

    def delete_slots(self, slots):
        with self._lock:
            rows = [self._fetch_rows[int(s)] for s in slots]
            if not rows:
                return
            params_list = [self._row_param_map(r) for r in rows]
            self.handler.on_delete(self._row_ir, params_list, self.store.delete)
            if self.cache is not None and self.primary_keys:
                for r in rows:
                    self.cache.invalidate(self._pk_key(r))

    def update_slots(self, slots, values: Dict[str, list]):
        with self._lock:
            rows = [self._fetch_rows[int(s)] for s in slots]
            if not rows:
                return
            params_list = [self._row_param_map(r) for r in rows]
            set_maps = [
                {attr: _scalar(np.asarray(vals)[j]) for attr, vals in values.items()}
                for j in range(len(rows))
            ]
            self.handler.on_update(self._row_ir, params_list, set_maps, self.store.update)
            if self.cache is not None and self.primary_keys:
                # A set clause that rewrites a primary-key attribute moves
                # the row to a NEW key: invalidating only the pre-update key
                # would leave any cached entry under the destination key
                # stale (update-or-insert probes would keep serving it).
                pk_rewrite = any(k in values for k in self.primary_keys)
                for j, r in enumerate(rows):
                    self.cache.invalidate(self._pk_key(r))
                    if pk_rewrite:
                        merged = [set_maps[j].get(nm, r[i])
                                  for i, nm in enumerate(self._names)]
                        self.cache.invalidate(self._pk_key(merged))

    def contains_fn(self, attr_hint: Optional[str] = None) -> Callable:
        if self.primary_keys and len(self.primary_keys) == 1:
            probe = self.primary_keys[0]
        elif len(self._names) == 1:
            probe = self._names[0]
        elif attr_hint is not None:
            probe = attr_hint
        else:
            raise SiddhiAppCreationError(
                f"'IN {self.table_id}': table needs a single-attribute primary key"
            )
        ir = StoreCompare(probe, "==", StoreParam("v"))

        def member(values) -> np.ndarray:
            vals = np.atleast_1d(np.asarray(values))
            return np.asarray(
                [self.store.contains(ir, {"v": _scalar(v)}) for v in vals], dtype=bool
            )

        return member

    # -- lifecycle / snapshot ------------------------------------------------

    def start(self):
        self.store.connect()

    def shutdown(self):
        self.store.disconnect()

    def snapshot(self) -> Dict:
        # external stores own their data; nothing to checkpoint in-engine
        return {}

    def restore(self, state: Dict):
        pass


class RecordCompiledCondition:
    """Compiled condition against a record table: store push-down IR +
    exact vectorized post-filter (reference:
    AbstractQueryableRecordTable.compileCondition)."""

    def __init__(self, table: RecordTableRuntime, condition: Optional[X.Expression],
                 event_scope: Scope, extra_functions=None, table_resolver=None):
        self.table = table
        scope = _merge_table_scope(event_scope, table)
        compiler = ExpressionCompiler(scope, functions=extra_functions,
                                      table_resolver=table_resolver)
        event_compiler = ExpressionCompiler(event_scope, functions=extra_functions,
                                            table_resolver=table_resolver)
        self._predicate: Optional[CompiledExpression] = None
        self._ir = StoreTrue()
        self._param_exprs: Dict[str, CompiledExpression] = {}
        self._pk_param_of_attr: Dict[str, str] = {}
        if condition is None:
            return
        self._predicate = compiler.compile(condition)
        if self._predicate.type != AttrType.BOOL:
            raise SiddhiAppCreationError("'on' condition must be boolean")
        builder = _StoreConditionBuilder(
            table.table_id, table.definition.attribute_names, event_compiler
        )
        self._ir = builder.build(condition)
        self._param_exprs = builder.params
        # detect full-primary-key equality probe for the cache path
        if table.primary_keys:
            eq = self._pk_equalities(self._ir)
            if eq is not None and all(k in eq for k in table.primary_keys):
                self._pk_param_of_attr = {k: eq[k] for k in table.primary_keys}

    def _pk_equalities(self, ir) -> Optional[Dict[str, object]]:
        """attr -> StoreParam/StoreConst for top-level '==' conjuncts."""
        out: Dict[str, object] = {}

        def walk(node) -> bool:
            if isinstance(node, StoreAnd):
                return all(walk(p) for p in node.parts)
            if isinstance(node, StoreCompare) and node.op == "==":
                out[node.attr] = node.rhs
                return True
            return isinstance(node, StoreTrue)

        return out if walk(self._ir) else None

    def slots_matching(self, event_env: Dict) -> np.ndarray:
        table = self.table
        if self._predicate is None:
            return table.live_slots()
        params = {
            k: _scalar(np.asarray(e.fn(event_env)).reshape(()))
            for k, e in self._param_exprs.items()
        }
        pk_key = None
        if self._pk_param_of_attr:
            vals = []
            for k in table.primary_keys:
                rhs = self._pk_param_of_attr[k]
                vals.append(rhs.value if isinstance(rhs, StoreConst) else params[rhs.key])
            pk_key = vals[0] if len(vals) == 1 else tuple(vals)
        cand = table.fetch_matching(self._ir, params, pk_probe_key=pk_key)
        if len(cand) == 0:
            return cand
        env = dict(event_env)
        env.update(table.column_env(cand))
        m = np.broadcast_to(np.asarray(self._predicate.fn(env)), (len(cand),))
        return cand[m]
