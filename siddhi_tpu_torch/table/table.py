"""In-memory tables: columnar storage + primary-key/secondary indexes +
compiled conditions.

Port of the JAX package's ``table/table.py`` (the reference's
``core/table/``, InMemoryTable.java:58, holder/IndexEventHolder.java:60,
and its compiled-condition planner, ``util/collection/`` and
CollectionExpressionParser.java:79): rows live in
columnar numpy arrays with a liveness mask; a compiled condition picks
between a primary-key hash probe, a secondary-index probe, and a
vectorized full scan (the ExhaustiveCollectionExecutor analog — but one
numpy pass over the column instead of a per-row executor walk).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.planner.host_expr import CompiledExpression, ExpressionCompiler, Scope
from siddhi_tpu_torch.query_api import (
    AndOp,
    AttrType,
    CompareOp,
    Expression,
    TableDefinition,
    Variable,
)
from siddhi_tpu_torch.query_api.annotation import find_annotation

TBL = "__tbl."  # env-key prefix for table columns inside compiled conditions


def _scalar(v):
    if isinstance(v, (np.generic, np.ndarray)):
        return v.item()  # 0-d / single-element only (scalar contexts)
    return v


class InMemoryTable:
    """Columnar in-memory table.

    Storage: one capacity-sized numpy array per attribute + a liveness
    mask.  Deletes clear the mask (slots are recycled via a free list);
    scans are vectorized over live rows.  ``@PrimaryKey`` maintains a
    hash map key-tuple -> slot; ``@Index`` maintains per-value slot sets.
    """

    def __init__(self, definition: TableDefinition, capacity: int = 64):
        self.definition = definition
        self.table_id = definition.id
        self._lock = threading.RLock()
        self._cap = capacity
        self._cols: Dict[str, np.ndarray] = {
            a.name: np.zeros(capacity, dtype=a.type.np_dtype) for a in definition.attributes
        }
        self._ts = np.zeros(capacity, dtype=np.int64)
        self._live = np.zeros(capacity, dtype=bool)
        self._hwm = 0  # high-water mark
        self._free: List[int] = []

        pk_ann = find_annotation(definition.annotations, "PrimaryKey")
        self.primary_keys: Optional[List[str]] = None
        if pk_ann is not None:
            self.primary_keys = [v for _, v in pk_ann.elements] or None
            for k in self.primary_keys or ():
                if k not in definition.attribute_names:
                    raise SiddhiAppCreationError(
                        f"table '{definition.id}': primary key '{k}' is not an attribute"
                    )
        self._pk_map: Dict = {}
        self.indexes: Dict[str, Dict] = {}
        for idx_ann in (a for a in definition.annotations if a.name.lower() == "index"):
            for _, attr in idx_ann.elements:
                if attr not in definition.attribute_names:
                    raise SiddhiAppCreationError(
                        f"table '{definition.id}': index '{attr}' is not an attribute"
                    )
                self.indexes[attr] = {}

    # -- basics -------------------------------------------------------------

    def __len__(self) -> int:
        return int(self._live.sum())

    @property
    def size(self) -> int:
        return len(self)

    def live_slots(self) -> np.ndarray:
        return np.flatnonzero(self._live)

    def _pk_of_slot(self, slot: int):
        vals = tuple(_scalar(self._cols[k][slot]) for k in self.primary_keys)
        return vals[0] if len(vals) == 1 else vals

    def _grow(self, need: int):
        new_cap = max(self._cap * 2, self._hwm + need)
        for k, col in self._cols.items():
            g = np.zeros(new_cap, dtype=col.dtype)
            g[: self._cap] = col
            self._cols[k] = g
        for name, arr in (("_ts", self._ts), ("_live", self._live)):
            g = np.zeros(new_cap, dtype=arr.dtype)
            g[: self._cap] = arr
            setattr(self, name, g)
        self._cap = new_cap

    def _alloc(self) -> int:
        if self._free:
            return self._free.pop()
        if self._hwm >= self._cap:
            self._grow(1)
        s = self._hwm
        self._hwm += 1
        return s

    # -- mutation -----------------------------------------------------------

    def insert(self, batch: EventBatch):
        """Add rows (reference: InMemoryTable.add).  With a primary key,
        a duplicate-key insert replaces the existing row (last-writer-wins,
        the deterministic analog of IndexEventHolder overwrite)."""
        with self._lock:
            for i in range(len(batch)):
                row = {nm: batch.columns[nm][i] for nm in self.definition.attribute_names}
                self._insert_row(row, int(batch.timestamps[i]))

    def _promote_to_object(self, nm: str):
        """Switch a typed column to object dtype so it can hold nulls
        (outer-join unmatched lanes insert None — the reference's boxed
        rows hold nulls natively; scans on object columns stay correct,
        just slower)."""
        col = self._cols[nm]
        if col.dtype != object:
            self._cols[nm] = col.astype(object)

    def _insert_row(self, row: Dict, ts: int) -> int:
        if self.primary_keys:
            vals = tuple(_scalar(row[k]) for k in self.primary_keys)
            key = vals[0] if len(vals) == 1 else vals
            existing = self._pk_map.get(key)
            if existing is not None:
                self._delete_slot(existing)
            slot = self._alloc()
            self._pk_map[key] = slot
        else:
            slot = self._alloc()
        for nm in self.definition.attribute_names:
            v = row[nm]
            if v is None and self._cols[nm].dtype != object:
                self._promote_to_object(nm)
            try:
                self._cols[nm][slot] = v
            except (TypeError, ValueError):
                self._promote_to_object(nm)
                self._cols[nm][slot] = v
        self._ts[slot] = ts
        self._live[slot] = True
        for attr, index in self.indexes.items():
            index.setdefault(_scalar(row[attr]), set()).add(slot)
        return slot

    def _delete_slot(self, slot: int):
        self._live[slot] = False
        self._free.append(slot)
        if self.primary_keys:
            self._pk_map.pop(self._pk_of_slot(slot), None)
        for attr, index in self.indexes.items():
            v = _scalar(self._cols[attr][slot])
            bucket = index.get(v)
            if bucket is not None:
                bucket.discard(slot)
                if not bucket:
                    del index[v]

    def delete_slots(self, slots: Sequence[int]):
        with self._lock:
            for s in slots:
                if self._live[s]:
                    self._delete_slot(int(s))

    def update_slots(self, slots: Sequence[int], values: Dict[str, Sequence]):
        """Set table attrs on given slots; values[attr][j] applies to
        slots[j].  Maintains pk/index structures."""
        with self._lock:
            touched_pk = self.primary_keys and any(k in values for k in self.primary_keys)
            for j, s in enumerate(slots):
                s = int(s)
                if not self._live[s]:
                    continue
                if touched_pk:
                    self._pk_map.pop(self._pk_of_slot(s), None)
                for attr in values:
                    if attr in self.indexes:
                        v_old = _scalar(self._cols[attr][s])
                        bucket = self.indexes[attr].get(v_old)
                        if bucket is not None:
                            bucket.discard(s)
                            if not bucket:
                                del self.indexes[attr][v_old]
                for attr, vals in values.items():
                    v = vals[j]
                    if v is None and self._cols[attr].dtype != object:
                        self._promote_to_object(attr)
                    try:
                        self._cols[attr][s] = v
                    except (TypeError, ValueError):
                        self._promote_to_object(attr)
                        self._cols[attr][s] = v
                    if attr in self.indexes:
                        self.indexes[attr].setdefault(_scalar(self._cols[attr][s]), set()).add(s)
                if touched_pk:
                    key = self._pk_of_slot(s)
                    # keep the key unique: an update landing on an existing
                    # key replaces that row (last-writer-wins, same as insert)
                    other = self._pk_map.get(key)
                    if other is not None and other != s:
                        self._delete_slot(other)
                    self._pk_map[key] = s

    # -- reads --------------------------------------------------------------

    def rows_batch(self, slots: Optional[np.ndarray] = None) -> EventBatch:
        """Live rows (optionally restricted to slots) as an EventBatch in
        insertion-slot order."""
        with self._lock:
            if slots is None:
                slots = self.live_slots()
            return EventBatch(
                self.table_id,
                self.definition.attribute_names,
                {nm: self._cols[nm][slots] for nm in self.definition.attribute_names},
                self._ts[slots],
            )

    def column_env(self, slots: np.ndarray) -> Dict[str, np.ndarray]:
        return {TBL + nm: self._cols[nm][slots] for nm in self.definition.attribute_names}

    def contains_fn(self, attr_hint: Optional[str] = None) -> Callable:
        """Membership test for `expr IN Table`: matches against the
        primary key when single-attribute, else the sole attribute."""
        if self.primary_keys and len(self.primary_keys) == 1:
            probe = self.primary_keys[0]
        elif len(self.definition.attributes) == 1:
            probe = self.definition.attributes[0].name
        elif attr_hint is not None:
            probe = attr_hint
        else:
            raise SiddhiAppCreationError(
                f"'IN {self.table_id}': table needs a single-attribute primary key"
            )

        def member(values) -> np.ndarray:
            with self._lock:
                if self.primary_keys == [probe]:
                    keys = self._pk_map
                    return np.frompyfunc(lambda v: _scalar(v) in keys, 1, 1)(
                        np.atleast_1d(np.asarray(values))
                    ).astype(bool)
                col = self._cols[probe][self.live_slots()]
                return np.isin(np.atleast_1d(np.asarray(values)), col)

        return member

    # -- snapshot contract --------------------------------------------------

    def snapshot(self) -> Dict:
        with self._lock:
            slots = self.live_slots()
            return {
                "cols": {nm: self._cols[nm][slots].copy() for nm in self._cols},
                "ts": self._ts[slots].copy(),
            }

    def restore(self, state: Dict):
        with self._lock:
            self._pk_map.clear()
            for index in self.indexes.values():
                index.clear()
            self._live[:] = False
            self._free = []
            self._hwm = 0
            n = len(state["ts"])
            if n > self._cap:
                self._grow(n)
            for i in range(n):
                row = {nm: state["cols"][nm][i] for nm in self._cols}
                self._insert_row(row, int(state["ts"][i]))


# ---------------------------------------------------------------------------
# Compiled conditions (CollectionExecutor analog)
# ---------------------------------------------------------------------------


class CompiledTableCondition:
    """A condition over (table row, matching-side event) compiled into a
    slot-set planner: per matching event, returns the live slots whose
    rows satisfy the condition.

    Plans, in order of preference (reference:
    CollectionExpressionParser.java:79 choosing Compare/AndMultiPrimaryKey/
    Exhaustive collection executors):
      1. primary-key probe — equality terms cover the full primary key;
      2. secondary-index probe — an equality term hits an indexed attr
         (remaining terms verified on the candidate set);
      3. vectorized full scan.
    """

    def __init__(
        self,
        table: InMemoryTable,
        condition: Optional[Expression],
        event_scope: Scope,
        extra_functions: Optional[Dict] = None,
        table_resolver=None,
    ):
        self.table = table
        scope = _merge_table_scope(event_scope, table)
        compiler = ExpressionCompiler(
            scope, functions=extra_functions, table_resolver=table_resolver
        )
        self._predicate: Optional[CompiledExpression] = None
        self._pk_exprs: Optional[List[CompiledExpression]] = None
        self._index_probe: Optional[Tuple[str, CompiledExpression]] = None
        if condition is None:
            return
        self._predicate = compiler.compile(condition)
        if self._predicate.type != AttrType.BOOL:
            raise SiddhiAppCreationError("'on' condition must be boolean")

        eq_terms, only_conj = _equality_terms(condition, table)
        if only_conj and table.primary_keys:
            by_attr = {attr: rhs for attr, rhs in eq_terms}
            if all(k in by_attr for k in table.primary_keys) and len(eq_terms) == len(
                table.primary_keys
            ):
                self._pk_exprs = [compiler.compile(by_attr[k]) for k in table.primary_keys]
        if self._pk_exprs is None and only_conj:
            for attr, rhs in eq_terms:
                if attr in table.indexes:
                    self._index_probe = (attr, compiler.compile(rhs))
                    break

    def slots_matching(self, event_env: Dict) -> np.ndarray:
        """Slots of table rows matching one event (env holds scalar
        values of the matching-side attributes)."""
        table = self.table
        if self._predicate is None:
            return table.live_slots()
        if self._pk_exprs is not None:
            vals = tuple(_scalar(np.asarray(e.fn(event_env)).reshape(())) for e in self._pk_exprs)
            key = vals[0] if len(vals) == 1 else vals
            slot = table._pk_map.get(key)
            return np.asarray([slot] if slot is not None else [], dtype=np.int64)
        if self._index_probe is not None:
            attr, e = self._index_probe
            v = _scalar(np.asarray(e.fn(event_env)).reshape(()))
            cand = np.asarray(sorted(table.indexes[attr].get(v, ())), dtype=np.int64)
        else:
            cand = table.live_slots()
        if len(cand) == 0:
            return cand
        env = dict(event_env)
        env.update(table.column_env(cand))
        m = np.broadcast_to(np.asarray(self._predicate.fn(env)), (len(cand),))
        return cand[m]


def _merge_table_scope(event_scope: Scope, table: InMemoryTable) -> Scope:
    """Matching-side attrs resolve bare or stream-qualified; table attrs
    resolve under the table name (and bare when not shadowed by the
    event side)."""
    scope = event_scope.clone()
    for a in table.definition.attributes:
        already_bare = scope._bare.get(a.name) is not None
        scope.add(table.table_id, a.name, TBL + a.name, a.type)
        if already_bare:
            # event side shadows the table for bare names (undo add's
            # ambiguity marking — on-conditions resolve bare attrs to the
            # matching-event side, reference compileCondition behavior)
            scope._bare[a.name] = event_scope._bare[a.name]
    return scope


def _equality_terms(cond: Expression, table: InMemoryTable):
    """Collect (table_attr, event_expr) equality terms from a pure
    conjunction; returns (terms, is_pure_conjunction_of_equalities)."""
    terms: List[Tuple[str, Expression]] = []

    def is_table_var(e: Expression) -> Optional[str]:
        if (
            isinstance(e, Variable)
            and e.stream_id in (table.table_id, None)
            and e.attribute in table.definition.attribute_names
        ):
            # bare names are table-side only when unambiguous is not
            # required here: qualified access is the supported fast path
            if e.stream_id == table.table_id:
                return e.attribute
        return None

    def refs_table(e: Expression) -> bool:
        if isinstance(e, Variable):
            return e.stream_id == table.table_id
        for f in ("left", "right", "expr"):
            sub = getattr(e, f, None)
            if isinstance(sub, Expression) and refs_table(sub):
                return True
        for a in getattr(e, "args", ()) or ():
            if isinstance(a, Expression) and refs_table(a):
                return True
        return False

    def walk(e: Expression) -> bool:
        if isinstance(e, AndOp):
            return walk(e.left) and walk(e.right)
        if isinstance(e, CompareOp) and e.op == "==":
            lv, rv = is_table_var(e.left), is_table_var(e.right)
            if lv is not None and not refs_table(e.right):
                terms.append((lv, e.right))
                return True
            if rv is not None and not refs_table(e.left):
                terms.append((rv, e.left))
                return True
        return False

    ok = walk(cond)
    return terms, ok


def compile_table_condition(table, condition, event_scope, extra_functions=None,
                            table_resolver=None):
    """Dispatch: slot-planner condition for in-memory tables, push-down
    IR + post-filter for record (store-backed) tables."""
    from siddhi_tpu_torch.table.record import RecordCompiledCondition, RecordTableRuntime

    if isinstance(table, RecordTableRuntime):
        return RecordCompiledCondition(
            table, condition, event_scope, extra_functions, table_resolver
        )
    return CompiledTableCondition(
        table, condition, event_scope, extra_functions, table_resolver
    )
