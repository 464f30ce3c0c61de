"""Dense pattern execution inside the product engine.

Port of the JAX package's ``core/dense_pattern.py``: the glue the
planner uses to run a ``SiddhiManager`` partitioned pattern query on the
dense NFA (``ops/dense_nfa.py``).  ``partition with (key of S) begin
<pattern query> end`` lowers to ONE dense engine whose partition axis is
the interned key: per-key NFA state rows on the device, no per-key
Python instances.

The dense engine picks its step at compile time
(``planner/kernels.route_dense_step``): capture-free ``every`` chains
of plain nodes with at most 32 lanes run the batch-step kernel; chains
with captures (``v > e1.v``, ``select e1.v``), counts and Kleene
closures, logical ``and``/``or`` nodes (over one stream or several),
sequences, non-every heads, whole-chain group-every, absent nodes and
``and not`` sides, more lanes or reset on emit run the general step in
torch ops.  A pattern over several streams is fed by one receiver per
stream.  An engine with absent deadlines makes its runtime an app
scheduler task: ``on_time`` runs the engine's timer step and emits the
fired matches at their deadlines.  ``purge_idle`` reclaims the rows of
idle keys for the partition's ``@purge``.  The reference's mesh
sharding, fault harness and span tracer are left out; the engine
refuses what it does not run with the reference's reason, and the
planner then runs the query on the host pattern engine.  Matches reach
the query runtime's selector through the runtime's ``EmitQueue``, each
match batch carrying the reference's ``aux`` side channels: the
original-batch positions of its events (``event_indices``), the clock
sampled when its batch was processed (``emit_now``, which time rate
limiters replay) and, for a partition-axis selector, each row's
partition key (``partition_keys``; timer-fired rows map back through
the reverse row -> key map).
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.emit_queue import (
    EmitQueue,
    EmitStats,
    PendingEmit,
    fetch_coalesced,
)
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import (
    SiddhiAppCreationError,
    SiddhiAppRuntimeError,
)
from siddhi_tpu_torch.core.ingest_stage import (
    IngestStage,
    IngestStats,
    staged_put,
    step_probe,
)
from siddhi_tpu_torch.core.stream import notify_listeners
from siddhi_tpu_torch.kernels.dense_step import candidate_env
from siddhi_tpu_torch.ops.dense_nfa import (
    _TORCH_DTYPES,
    DensePatternEngine,
    filter_env,
    is_open_count,
    state_from_numpy,
    state_to_numpy,
)
from siddhi_tpu_torch.ops.nfa import NFABuilder
from siddhi_tpu_torch.query_api import AttrType, StateInputStream, Variable
from siddhi_tpu_torch.util import faults as _faults

log = logging.getLogger("siddhi_tpu_torch")

def build_dense_engine(query, st: StateInputStream, resolve_def,
                       n_partitions: int, n_instances: int = 4,
                       device=None, select_override=None,
                       builder=None) -> DensePatternEngine:
    """Lower one pattern query to a DensePatternEngine or raise
    SiddhiAppCreationError with the reason it is outside the port.

    ``select_override=(vars, names)`` bypasses the plain-select-items
    requirement: the engine emits those raw capture columns and the
    caller owns the selection (the aggregating-selector form runs the
    host selector over the match rows).  ``builder`` reuses the caller's
    NFABuilder, already built (one lowering serves the selector scope
    and the engine)."""
    sel = query.selector
    if select_override is not None:
        select_vars, select_names = select_override
    else:
        if sel.group_by or sel.having is not None:
            raise SiddhiAppCreationError(
                "dense path: group-by/having selectors take the "
                "host-selector dense form")
        if not sel.selection:
            raise SiddhiAppCreationError(
                "dense path: select * is not supported for patterns")
        select_vars, select_names = [], []
        for oa in sel.selection:
            if (not isinstance(oa.expression, Variable)
                    or oa.expression.stream_id is None):
                raise SiddhiAppCreationError(
                    "dense path: select items must be event references "
                    "(e1.attr)")
            select_vars.append(oa.expression)
            select_names.append(oa.name)

    if builder is None:
        builder = NFABuilder(st, resolve_def)
        builder.build()
    nodes = builder.nodes
    for node in nodes:
        for spec in node.specs:
            if spec.filter_presence_keys:
                raise SiddhiAppCreationError(
                    "dense path: 'is null' event-presence checks need the "
                    "host engine")

    eng = DensePatternEngine(
        nodes=nodes,
        ref_defs=builder.ref_defs,
        stream_to_ref=builder.stream_to_ref,
        within_ms=st.within_ms,
        n_partitions=n_partitions,
        select_vars=select_vars,
        select_names=select_names,
        is_sequence=st.type == StateInputStream.SEQUENCE,
        n_instances=n_instances,
        device=device,
    )
    # captures and selects have device lanes only for numeric attributes
    for (ref, attr, _last) in eng.alloc.slots:
        t = eng.ref_defs[ref].attribute_type(attr)
        if not t.is_numeric:
            raise SiddhiAppCreationError(
                f"dense path: capture '{ref}.{attr}' has type {t.value}; "
                "only numeric attributes have device lanes — host engine "
                "used")
    for (name, src), t in zip(eng.out_spec, output_attr_types(eng)):
        if not t.is_numeric:
            attr = src[1] if isinstance(src, tuple) else src.attr
            raise SiddhiAppCreationError(
                f"dense path: select attribute '{attr}' has type "
                f"{t.value}; only numeric attributes have device lanes — "
                "host engine used")
    _trace_check(eng)
    eng.check_kernels()
    return eng


def output_attr_types(eng) -> List[AttrType]:
    """Declared attribute type of each engine output lane (the engine
    computes in float32; callbacks keep the source types)."""
    out: List[AttrType] = []
    for _name, src in eng.out_spec:
        t = None
        if isinstance(src, tuple):  # ('cand', attr): from the last node
            for node in eng.nodes:
                for spec in node.specs:
                    if src[1] in spec.stream_def.attribute_names:
                        t = spec.stream_def.attribute_type(src[1])
        else:  # a register slot keeps its captured attribute's type
            d = eng.ref_defs.get(src.ref)
            if d is not None and src.attr in d.attribute_names:
                t = d.attribute_type(src.attr)
        out.append(t or AttrType.DOUBLE)
    return out


def _trace_check(eng):
    """Evaluate every filter the step evaluates once, on a tiny zero env
    of exactly the lanes the step provides (the candidate's numeric
    columns and a node's float and integer registers, ``filter_env``):
    each spec of each node (both sides of a logical node, absent specs
    too), and each via-path filter (node ``s``'s against node ``s-1``'s
    registers); then, for an engine with deadlines, the timer step on a
    zero state of a few rows.  A filter the device cannot run (one
    reading a string attribute, say) fails at plan time, not on the
    first event.  The reference traces the whole step abstractly."""
    B, I = 4, eng.I
    slots = list(eng.alloc.slots.values())
    regs = torch.zeros((B, eng.S, I, max(eng.alloc.n, 1)),
                       dtype=torch.float32)
    iregs = torch.zeros((B, eng.S, I, 2 * eng.alloc.n_int),
                        dtype=torch.int32)
    # (node, spec, node whose registers feed the env)
    uses = [(s, si, s) for s, node in enumerate(eng.nodes)
            for si in range(len(node.specs))]
    uses += [(s, 0, s - 1) for s in range(1, eng.S)
             if is_open_count(eng.nodes[s - 1])]
    try:
        for s, si, rn in uses:
            spec = eng.nodes[s].specs[si]
            f = eng.node_filters[s][si]
            if f is None:
                continue
            zeros = {a: np.zeros(B, dtype=spec.stream_def.attribute_type(a)
                                 .np_dtype)
                     for a in eng.numeric_stream_attrs(spec.stream_key)}
            cols = {k: torch.from_numpy(v) for k, v in
                    eng.prepare_cols(spec.stream_key, zeros).items()}
            cand = candidate_env(spec.stream_def, cols,
                                 torch.zeros(B, dtype=torch.int32))
            ok = torch.as_tensor(f.fn(filter_env(cand, slots, regs[:, rn],
                                                 iregs[:, rn])))
            ok.to(torch.bool).broadcast_to((B, I))  # the step's lane shape
        if eng.has_deadlines:
            state = {k: torch.zeros((B,) + shape[1:],
                                    dtype=_TORCH_DTYPES[dt])
                     for k, (shape, dt) in eng.state_layout().items()}
            eng.make_time_step()(state, 1)
    except SiddhiAppCreationError:
        raise
    except Exception as e:
        raise SiddhiAppCreationError(
            f"dense path: step not traceable ({e})") from e


class DensePatternRuntime:
    """Product-side wrapper of one DensePatternEngine: interns partition
    keys to engine rows, advances the state with the engine's step and
    emits match batches through ``emit(batch)``."""

    _OVF_POLL = 256  # steps between device overflow polls (one D2H each)

    def __init__(self, engine: DensePatternEngine, out_stream_id: str,
                 emit: Callable[[EventBatch], None], emit_depth: int = 1,
                 ingest_depth: int = 1,
                 clock: Optional[Callable[[], int]] = None,
                 app_context=None):
        self.engine = engine
        # its exception listeners hear of dropped instances
        self.app_context = app_context
        # the app clock, sampled when a batch is processed
        # (aux["emit_now"] of its deferred match batch)
        self.clock = clock
        # aux["partition_keys"] on match batches: set for a
        # partition-axis selector, which keeps per-key state
        self.key_channel = False
        # notified with purged key values: the partition-axis selector
        # drops their state
        self.on_purge_keys = None
        self.out_stream_id = out_stream_id
        self.emit_cb = emit
        # the app's span tracer and fault injector (the engine reads its
        # step.dense and ingest.put sites from engine.faults)
        self.tracer = getattr(app_context, "tracer", None)
        self.engine_kind = "dense"
        self.faults = getattr(app_context, "fault_injector", None)
        engine.faults = self.faults
        self.emit_stats = EmitStats()
        self.emit_queue = EmitQueue(depth=emit_depth, stats=self.emit_stats,
                                    faults=self.faults,
                                    on_fault=self._on_fault)
        # the engine carries the stats so its staged puts count there
        self.ingest_stats = IngestStats()
        engine.ingest_stats = self.ingest_stats
        self.ingest_stage = IngestStage(
            depth=ingest_depth, stats=self.ingest_stats,
            on_fault=self._on_fault if self.faults is not None else None)
        self.state = engine.init_state()
        self.step_invocations = 0
        # timer steps that fired a match; the earliest armed deadline,
        # re-read after every event batch, restore and purge
        self.time_fires = 0
        self._wake_dirty = True
        self._wake_cache = None
        self._ovf_warned = 0
        self._key_rows: Dict = {}
        self._row_keys: Dict = {}  # reverse map: engine row -> key value
        self._next_row = 0
        self._free_rows: List[int] = []
        # sorted-key index backing the vectorized intern: _key_arr is the
        # sorted array of known keys in their native dtype, _key_row_arr
        # the row of each.  _key_rows is the source of truth; the index
        # is a rebuildable cache.
        self._key_arr = np.empty(0, dtype=np.int64)
        self._key_row_arr = np.empty(0, dtype=np.int32)
        self._vector_intern = True
        # host-side per-row activity clock (the reference's idle purge
        # reads it; the hot-key router keeps promoted rows' clocks going)
        self._row_last_used = np.zeros(engine.n_partitions, dtype=np.int64)
        self._out_dtypes = [t.np_dtype for t in output_attr_types(engine)]

    # -- partition interning -------------------------------------------------

    def intern_keys(self, keys) -> np.ndarray:
        """Partition-key values -> engine row ids (stable for the life of
        the key; shared by all source streams).

        Vectorized: the batch is factorized once (``np.unique``), known
        keys resolve with one ``searchsorted`` against the sorted index,
        and only never-seen keys take the allocation path.  The index
        needs one sortable dtype family; keys that mix families fall back
        for good to the exact per-event dict intern."""
        arr = np.asarray(keys)
        if self._vector_intern:
            if arr.dtype.kind in ("O", "V"):
                self._vector_intern = False
            elif len(self._key_arr) == 0 and not self._key_rows:
                pass  # first batch adopts its dtype below
            elif arr.dtype != self._key_arr.dtype:
                if np.can_cast(arr.dtype, self._key_arr.dtype, "safe"):
                    arr = arr.astype(self._key_arr.dtype)
                elif np.can_cast(self._key_arr.dtype, arr.dtype, "safe"):
                    self._key_arr = self._key_arr.astype(arr.dtype)
                else:
                    log.warning(
                        "dense pattern: partition keys mix dtypes (%s vs "
                        "index %s); falling back to the exact dict intern",
                        arr.dtype, self._key_arr.dtype)
                    self._vector_intern = False
        if not self._vector_intern:
            return self._intern_keys_dict(arr)
        uniq, inv = np.unique(arr, return_inverse=True)
        nu = len(uniq)
        urows = np.empty(nu, dtype=np.int32)
        if len(self._key_arr):
            pos = np.searchsorted(self._key_arr, uniq)
            pos_c = np.minimum(pos, len(self._key_arr) - 1)
            found = self._key_arr[pos_c] == uniq
            urows[found] = self._key_row_arr[pos_c[found]]
            new_idx = np.flatnonzero(~found)
        else:
            new_idx = np.arange(nu)
        if len(new_idx):
            cap = self.engine.n_partitions
            n_new = len(new_idx)
            take_free = min(len(self._free_rows), n_new)
            fresh = n_new - take_free
            if self._next_row + fresh > cap:
                raise SiddhiAppRuntimeError(
                    f"dense pattern: partition-key cardinality exceeded "
                    f"capacity {cap} (raise it via "
                    f"@app:execution('tpu', partitions='N'))")
            row_ids = np.empty(n_new, dtype=np.int32)
            if take_free:
                row_ids[:take_free] = self._free_rows[-take_free:][::-1]
                del self._free_rows[-take_free:]
            if fresh:
                row_ids[take_free:] = np.arange(
                    self._next_row, self._next_row + fresh, dtype=np.int32)
                self._next_row += fresh
            urows[new_idx] = row_ids
            self._key_rows.update(
                zip(uniq[new_idx].tolist(), row_ids.tolist()))
            self._row_keys.update(
                zip(row_ids.tolist(), uniq[new_idx].tolist()))
            # merge the sorted new keys into the sorted index (a two-way
            # merge, not a re-sort of every known key)
            new_keys = uniq[new_idx]
            new_rows = urows[new_idx]
            K, U = len(self._key_arr), len(new_keys)
            if K == 0:
                self._key_arr = new_keys.copy()
                self._key_row_arr = new_rows.copy()
            else:
                ins = np.searchsorted(self._key_arr, new_keys)
                new_pos = ins + np.arange(U)
                old_mask = np.ones(K + U, dtype=bool)
                old_mask[new_pos] = False
                dt = np.promote_types(self._key_arr.dtype, new_keys.dtype)
                merged_keys = np.empty(K + U, dtype=dt)
                merged_keys[new_pos] = new_keys
                merged_keys[old_mask] = self._key_arr
                merged_rows = np.empty(K + U, dtype=np.int32)
                merged_rows[new_pos] = new_rows
                merged_rows[old_mask] = self._key_row_arr
                self._key_arr = merged_keys
                self._key_row_arr = merged_rows
        return urows[inv].astype(np.int32, copy=False)

    def _intern_keys_dict(self, keys) -> np.ndarray:
        """Exact per-event intern (hash semantics): the fallback when
        partition keys mix dtype families."""
        out = np.zeros(len(keys), dtype=np.int32)
        rows = self._key_rows
        cap = self.engine.n_partitions
        for i, k in enumerate(keys):
            row = rows.get(k)
            if row is None:
                if self._free_rows:
                    row = self._free_rows.pop()
                elif self._next_row < cap:
                    row = self._next_row
                    self._next_row += 1
                else:
                    raise SiddhiAppRuntimeError(
                        f"dense pattern: partition-key cardinality exceeded "
                        f"capacity {cap} (raise it via "
                        f"@app:execution('tpu', partitions='N'))")
                rows[k] = row
                self._row_keys[row] = k
            out[i] = row
        return out

    def _rebuild_key_index(self):
        """Rebuild the sorted intern index from _key_rows (after restore);
        degrades to dict mode when the keys do not form one sortable
        dtype family."""
        self._key_arr = np.empty(0, dtype=np.int64)
        self._key_row_arr = np.empty(0, dtype=np.int32)
        if not self._key_rows:
            return
        try:
            karr = np.array(list(self._key_rows.keys()))
        except ValueError:  # inhomogeneous keys
            karr = None
        if karr is None or karr.dtype.kind in ("O", "V"):
            self._vector_intern = False
            return
        rarr = np.fromiter(self._key_rows.values(), np.int32, len(karr))
        order = np.argsort(karr, kind="stable")
        self._key_arr = karr[order]
        self._key_row_arr = rarr[order]

    # -- event path ----------------------------------------------------------

    def reads(self, stream_id: str) -> bool:
        return stream_id in self.engine.stream_keys

    def process_partitioned(self, stream_id: str, batch: EventBatch, keys):
        """A partitioned stream's batch with each row's raw key: the keys
        are interned to this runtime's rows."""
        self.process_stream_batch(stream_id, batch, self.intern_keys(keys),
                                  keys)

    def process_stream_batch(self, stream_key: str, batch: EventBatch,
                             part: np.ndarray, keys=None):
        """Advance the NFA with a junction batch whose rows the partition
        receiver interned to ``part``; ``keys`` are the raw key values."""
        cur = batch.only(ev.CURRENT)
        if len(cur) == 0:
            return
        # a sampled cycle token (None for the unsampled): its ingest
        # span starts here
        tok = (self.tracer.begin_cycle(self.engine_kind, len(cur))
               if self.tracer is not None else None)
        eng = self.engine
        cols = {a: np.asarray(cur.columns[a])
                for a in eng.numeric_stream_attrs(stream_key)
                if a in cur.columns}
        ts = np.asarray(cur.timestamps, dtype=np.int64)
        np.maximum.at(self._row_last_used, part, ts)
        self.state, pending = eng.process_deferred(
            self.state, stream_key, part, cols, ts)
        self.step_invocations += 1
        if eng.has_deadlines:
            self._wake_dirty = True
        if self.step_invocations % self._OVF_POLL == 0:
            self._check_overflow()
        # the clock at processing time: the emit may drain later, but
        # replays this `now` to the query's time rate limiter
        now = self.clock() if self.clock is not None else None
        k = keys if self.key_channel else None

        def _finish(p=pending, t=ts):
            c = 0 if p is None else p.resolve()
            if tok is not None:
                # the count gate resolved: the step has finished
                tok.step_done(c)
            if c == 0:
                self.emit_queue.skip()
                return
            self.emit_queue.push(PendingEmit(
                p.device_arrays(),
                lambda host: self._emit_deferred(p, t, k, now, host),
                trace=tok))

        # the match-count fetch (resolve) is the blocking device sync;
        # with ingest.depth > 1 it runs after the next batch's dispatch
        self.ingest_stage.submit(
            None if pending is None else step_probe(eng.device), _finish,
            trace=tok)

    def _on_fault(self, e: BaseException):
        _faults.isolate(self.tracer, self.faults, e)

    def drain(self):
        """Flush barrier: the ingest stage first (staged batches enqueue
        or skip their emits), then the emit queue."""
        self.ingest_stage.flush()
        self.emit_queue.drain()

    def _emit_deferred(self, pending, ts, keys, now, host_arrays):
        ev_idx, out = pending.materialize(host_arrays)
        if len(ev_idx) == 0:
            return
        names = self.engine.output_names
        out_cols = {name: out[:, oi].astype(self._out_dtypes[oi])
                    for oi, name in enumerate(names)}
        mb = EventBatch(
            self.out_stream_id, names, out_cols, ts[ev_idx],
            np.full(len(ev_idx), ev.CURRENT, dtype=np.int8))
        if keys is not None:
            mb.aux["partition_keys"] = np.asarray(keys)[ev_idx].tolist()
        # the completing events' positions in the original batch
        mb.aux["event_indices"] = ev_idx
        if now is not None:
            mb.aux["emit_now"] = now
        self.emit_cb(mb)

    # -- instance-capacity overflow ------------------------------------------

    def overflow_total(self) -> int:
        """Pending instances dropped because every successor lane was
        occupied (0: the match set is exact).  Reduced on the device; one
        scalar crosses to the host."""
        return int(fetch_coalesced([self.state["overflow"].sum()])[0])

    def stats(self) -> Dict:
        """Partition and lane occupancy (``pattern_state()``), as the
        reference reports it: ``active_instances`` counts the pending
        lanes of rows in use (interned keys; row 0 when unpartitioned).
        A barrier first; the lane counts and the overflow cross to the
        host in one ``fetch_coalesced``."""
        self.drain()
        eng = self.engine
        partitioned = eng.n_partitions > 1
        active = self.state["active"]
        if self._key_rows:
            rows = torch.as_tensor(
                np.fromiter(self._key_rows.values(), dtype=np.int64,
                            count=len(self._key_rows)), device=eng.device)
            act = active[rows].sum()
        elif not partitioned:
            act = active[0].sum()
        else:
            act = None
        got = fetch_coalesced([self.state["overflow"].sum()]
                              + ([] if act is None else [act]))
        return {
            "engine": "dense",
            "partitions_in_use": (
                len(self._key_rows) if partitioned else 1),
            "partition_capacity": eng.n_partitions,
            "instance_lanes": eng.I,
            "active_instances": 0 if act is None else int(got[1]),
            "dropped_instances": int(got[0]),
            "step_invocations": self.step_invocations,
        }

    def _check_overflow(self):
        total = self.overflow_total()
        if total > self._ovf_warned:
            msg = (f"dense pattern '{self.out_stream_id}': {total} pending "
                   "instance(s) dropped — instance lanes full; matches may "
                   "be missing vs the host engine.  Raise @app:execution("
                   f"'tpu', instances='N') (current {self.engine.I} per "
                   "partition/node).")
            log.warning("%s", msg)
            # the app's exception listeners see the lost-match pressure
            # too, as in the reference
            notify_listeners(self.app_context, SiddhiAppRuntimeError(msg))
            self._ovf_warned = total

    def close(self):
        """App shutdown: drain pending emits, then the final overflow
        check."""
        self.drain()
        self._check_overflow()

    # -- snapshot contract ---------------------------------------------------

    def snapshot(self, fetch: bool = True) -> Dict:
        """The reference's snapshot tree; device state is fetched through
        ``fetch_coalesced`` (``np.asarray`` raises on a CUDA tensor), or
        with ``fetch=False`` left as the live state tensors, in the
        layout's order (the persist path's capture clones them)."""
        self.drain()
        self._check_overflow()
        if fetch:
            dense, base_ts = state_to_numpy(self.engine, self.state)
        else:
            dense = {k: self.state[k] for k in self.engine.state_layout()}
            base_ts = self.engine.base_ts
        return {
            "dense_state": dense,
            "base_ts": base_ts,
            "key_rows": dict(self._key_rows),
            "next_row": self._next_row,
            "free_rows": list(self._free_rows),
            "row_last_used": self._row_last_used.copy(),
        }

    def restore(self, state: Dict):
        """Restore a snapshot of this runtime or of the reference's."""
        self.drain()
        rows = len(next(iter(state["dense_state"].values())))
        want = self.engine.n_partitions + 1
        if rows != want:
            raise SiddhiAppRuntimeError(
                f"cannot restore: snapshot has {rows} state rows but this "
                f"app needs {want} (snapshot taken under a different "
                "@app:execution partitions setting)")
        self.state = state_from_numpy(self.engine, state["dense_state"],
                                      state["base_ts"])
        self._key_rows = dict(state["key_rows"])
        self._row_keys = {r: k for k, r in self._key_rows.items()}
        self._next_row = state.get("next_row", len(self._key_rows))
        self._free_rows = list(state.get("free_rows", []))
        rlu = state.get("row_last_used")
        if rlu is not None:
            self._row_last_used = np.asarray(rlu).copy()
        self._rebuild_key_index()
        self._wake_dirty = True

    # -- idle-key purge ------------------------------------------------------

    def purge_idle(self, now: int, idle_ms: int):
        """Reclaim the rows of keys idle for at least ``idle_ms``: reset
        their state rows to the init row and recycle the row ids (the
        dense form of the partition's idle-instance purge)."""
        if not self._key_rows:
            return
        idle = [(k, r) for k, r in self._key_rows.items()
                if now - int(self._row_last_used[r]) >= idle_ms]
        if not idle:
            return
        # barrier: the purged keys' pending matches reach the per-key
        # selector state before on_purge_keys drops it
        self.drain()
        # every init row is the same: one row is the template
        rows, tmpl = staged_put(
            (np.asarray([r for _k, r in idle], dtype=np.int64),
             self.engine.init_state_host(n_rows=1)),
            self.engine.device, self.ingest_stats)
        for key, arr in self.state.items():
            arr[rows] = tmpl[key]
        for k, r in idle:
            del self._key_rows[k]
            self._row_keys.pop(r, None)
            self._free_rows.append(r)
        self._rebuild_key_index()
        self._wake_dirty = True
        if self.on_purge_keys is not None:
            self.on_purge_keys([k for k, _r in idle])

    # -- scheduler task: absent deadlines ------------------------------------

    def on_time(self, now: int):
        """Fire the deadlines due at ``now``: the engine's timer step,
        then one match batch stamped with the fire times."""
        eng = self.engine
        if not eng.has_deadlines:
            return
        # barrier: event matches queued before this tick emit first
        self.drain()
        self.state, fired = eng.on_time_state(self.state, now)
        self._wake_dirty = True
        if fired is None:
            return
        self.time_fires += 1
        out, fire_ts, rows = fired
        names = eng.output_names
        mb = EventBatch(
            self.out_stream_id, names,
            {name: out[:, oi].astype(self._out_dtypes[oi])
             for oi, name in enumerate(names)},
            fire_ts, np.full(len(fire_ts), ev.CURRENT, dtype=np.int8))
        if self.key_channel:
            # the key each fired row was interned under (the reverse
            # row -> key map; a recycled row maps to its new key)
            mb.aux["partition_keys"] = [
                self._row_keys.get(int(r)) for r in rows]
        mb.aux["emit_now"] = now
        self.emit_cb(mb)

    def next_wakeup(self):
        """The earliest armed deadline (absolute ms) or None."""
        if not self.engine.has_deadlines:
            return None
        if self._wake_dirty:
            self._wake_cache = self.engine.next_wakeup_state(self.state)
            self._wake_dirty = False
        return self._wake_cache

    def fire(self, now: int):
        self.on_time(now)

    def on_start(self, now: int):
        pass


class DenseStreamReceiver:
    """Junction subscriber feeding one source stream of an unpartitioned
    dense pattern: every event goes to partition 0 (the reference's
    ``_DenseStreamReceiver`` with no key function)."""

    def __init__(self, runtime: DensePatternRuntime, stream_key: str):
        self.runtime = runtime
        self.stream_key = stream_key

    def receive(self, batch: EventBatch):
        cur = batch.only(ev.CURRENT)
        if len(cur):
            self.runtime.process_stream_batch(
                self.stream_key, cur, np.zeros(len(cur), dtype=np.int32))
