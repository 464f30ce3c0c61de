"""Windowed joins: two-sided stream joins, stream-table joins, outer joins.

Port of the JAX package's ``core/join.py`` (the reference's
``query/input/stream/join/``, JoinProcessor.java:45): an arriving batch
is joined with the opposite side's buffer through one vectorized
cross-product condition evaluation, not a per-event ``find()``.  Each
side keeps its own window buffer; CURRENT arrivals probe before the
window, the rows the window expires probe after it (and emit EXPIRED
joined events), as the reference's pre/post join processors around the
window do.  Matched pairs come out in the row-major order of
``np.nonzero`` over the ``[n_a, n_b]`` condition mask: arriving row
order, then buffer order within a row.

Under ``@app:execution('tpu')`` the condition mask runs on the device
(``DeviceJoinProbe``, torch ops, as the reference's jitted XLA mask);
buffering, expiry, outer fill and materialization stay on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.emit_queue import fetch_coalesced
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.core.ingest_stage import IngestStats, staged_put
from siddhi_tpu_torch.kernels.dense_step import flush_subnormals
from siddhi_tpu_torch.ops.device_query import DeviceQueryCompiler
from siddhi_tpu_torch.planner.expr import CompiledExpression, Scope
from siddhi_tpu_torch.planner.host_expr import N_KEY, TS_KEY
from siddhi_tpu_torch.query_api import AttrType, JoinInputStream, Variable


def _null_column(t: AttrType, n: int) -> np.ndarray:
    """Unmatched-side fill of an outer join: object-dtype None for every
    attribute type, floats included, so callbacks see real nulls (the
    reference's boxed nulls); NaN fills would miss ``is None`` checks
    and break equality filters."""
    col = np.empty(n, dtype=object)
    col[:] = None
    return col


class JoinSide:
    """One side of the join: filters and an optional window buffer, or a
    table, named window or aggregation probed as a passive buffer."""

    def __init__(self, ref: str, definition, filters: List, window,
                 table=None, named_window=None, aggregation=None,
                 triggers: bool = True):
        self.ref = ref
        self.definition = definition
        self.filters = filters
        self.window = window
        self.table = table
        self.named_window = named_window
        self.aggregation = aggregation
        # an aggregation join's compiled `within`/`per`, set by the
        # planner: (start, end | None) and the per expression
        self.agg_within = None
        self.agg_per = None
        self.triggers = triggers

    def buffered(self, probe_env: Optional[Dict] = None
                 ) -> Optional[EventBatch]:
        if self.aggregation is not None:
            from siddhi_tpu_torch.aggregation.runtime import within_bounds

            if self.agg_per is None:
                raise SiddhiAppCreationError(
                    f"aggregation join '{self.ref}': 'per' clause is "
                    "required")
            env = probe_env or {N_KEY: 0}
            per = str(np.asarray(self.agg_per.fn(env)).ravel()[0])
            within = None
            if self.agg_within is not None:
                start_c, end_c = self.agg_within
                v1 = np.asarray(start_c.fn(env)).ravel()[0]
                v2 = (np.asarray(end_c.fn(env)).ravel()[0]
                      if end_c is not None else None)
                within = within_bounds(v1, v2)
            return self.aggregation.find(per, within)
        if self.table is not None:
            return self.table.rows_batch()
        if self.window is not None:
            return self.window.buffered()
        if self.named_window is not None:
            buf = self.named_window.buffered()
            # a named window's buffer is shared, so this side's filters
            # run at probe time (a plain window side filters before it
            # buffers)
            if buf is not None:
                for f in self.filters:
                    buf = f.process(buf, 0)
            return buf
        return None  # a pure stream side buffers nothing

    def qualified_key(self, attr: str) -> str:
        return f"{self.ref}.{attr}"


def _variables(expr, out: List[Variable]) -> List[Variable]:
    """Every Variable of an expression tree, in evaluation order."""
    if isinstance(expr, Variable):
        out.append(expr)
        return out
    for f in getattr(expr, "__dataclass_fields__", {}):
        v = getattr(expr, f)
        for x in (v if isinstance(v, (list, tuple)) else (v,)):
            if hasattr(x, "__dataclass_fields__"):
                _variables(x, out)
    return out


class DeviceJoinProbe:
    """The join condition's ``[n_a, n_b]`` mask on the device (the
    reference's jitted cross-product probe, ``core/join.py:100``).

    Arriving rows broadcast down the columns, buffered rows across the
    rows, in blocks of at most ``MAX_ROWS`` by ``MAX_BUF`` (the
    reference's work bound a call).  Every block writes its slice of one
    device mask, so the mask of row ``i`` and buffered row ``j`` does
    not depend on the blocking, and ``torch.nonzero`` over the whole
    mask gives the pairs in ``np.nonzero``'s row-major order.  One
    ``staged_put`` takes both sides' lanes up; one ``fetch_coalesced``
    brings the pairs down (int32 row and buffer indices, and for an
    outer join each row's matched-any flag): ``8 M`` bytes a batch for
    ``M`` pairs, ``+ 4 n_a`` for an outer join.

    Lanes as the device query engine's: INT int32 (bit-exact), BOOL
    bool, FLOAT/DOUBLE float32, so a DOUBLE condition compares on
    float32 here and on float64 in the default mode, as in the
    reference.  A condition reading a STRING or LONG attribute or the
    timestamp keeps the numpy probe: its plan-time check fails on the
    missing key.  Only the attributes the condition reads ride lanes,
    so a nullable column it never reads neither ships nor forces a
    fallback; a batch whose lane column carries nulls (object dtype)
    takes the numpy probe, that batch alone (``mask`` and ``pairs``
    return None)."""

    MAX_ROWS = 2048
    MAX_BUF = 8192

    def __init__(self, condition_expr, scope: Scope, left: JoinSide,
                 right: JoinSide, device):
        self.device = torch.device(device)
        self.ingest_stats = IngestStats()
        # counters: mask blocks evaluated, fetch calls, bytes fetched
        self.blocks = 0
        self.fetches = 0
        self.bytes_fetched = 0
        self._lanes: Dict[str, Dict[str, np.dtype]] = {}
        for side in (left, right):
            lanes = {}
            for a in side.definition.attributes:
                if a.type == AttrType.INT:
                    lanes[side.qualified_key(a.name)] = np.dtype(np.int32)
                elif a.type == AttrType.BOOL:
                    lanes[side.qualified_key(a.name)] = np.dtype(np.bool_)
                elif a.type.is_numeric and a.type != AttrType.LONG:
                    lanes[side.qualified_key(a.name)] = np.dtype(np.float32)
            self._lanes[side.ref] = lanes
        self._check(condition_expr, scope, left)

    def _check(self, expr, scope: Scope, left: JoinSide):
        """Plan-time eligibility: prune the lanes to the keys the
        condition reads, compile it, and evaluate it once over small
        lane tensors (an env with no timestamp key and no STRING or
        LONG lanes).  Any failure raises ``SiddhiAppCreationError`` and
        the numpy probe stays."""
        used = set()
        for v in _variables(expr, []):
            try:
                used.add(scope.resolve(v)[0])
            except SiddhiAppCreationError:
                pass
        for ref in self._lanes:
            self._lanes[ref] = {k: dt for k, dt in self._lanes[ref].items()
                                if k in used}
        try:
            # the device query path's compiler with no pair lanes: INT
            # on its int32 lane, float32 constants and arithmetic
            # flushed of subnormals, eventTimestamp() reading a key the
            # env lacks (so its check fails, as the reference's trace)
            self.condition = DeviceQueryCompiler(scope, ()).compile(expr)
            env = {}
            for ref, lanes in self._lanes.items():
                shape = (4, 1) if ref == left.ref else (1, 4)
                for k, dt in lanes.items():
                    env[k] = torch.ones(shape, dtype=_TORCH[dt])
            env[N_KEY] = 16
            self.condition.fn(env)
        except Exception as e:
            raise SiddhiAppCreationError(
                f"join condition not device-traceable: {e}") from e

    # -- per batch -----------------------------------------------------------

    def _host_lanes(self, side: JoinSide, batch: EventBatch
                    ) -> Optional[Dict[str, np.ndarray]]:
        """The side's lane columns as numpy, or None when one carries
        nulls (object dtype)."""
        out = {}
        for key, dt in self._lanes[side.ref].items():
            src = np.asarray(batch.columns[key.split(".", 1)[1]])
            if src.dtype.kind == "O":
                return None
            out[key] = src.astype(dt, copy=False)
        return out

    def _stage(self, side, rows, other, buf):
        """Both sides' lanes on the device (one put), float32 lanes
        flushed; None for a null-carrying batch."""
        a = self._host_lanes(side, rows)
        b = self._host_lanes(other, buf) if a is not None else None
        if b is None:
            return None
        dev = staged_put({"a": a, "b": b}, self.device, self.ingest_stats)
        for lanes in dev.values():
            for k, t in lanes.items():
                if t.dtype == torch.float32:
                    lanes[k] = flush_subnormals(t)
        return dev["a"], dev["b"]

    def _device_mask(self, a_lanes, b_lanes, n_a: int, n_b: int
                     ) -> torch.Tensor:
        """The ``[n_a, n_b]`` bool mask, block by block."""
        out = torch.empty((n_a, n_b), dtype=torch.bool, device=self.device)
        for bs in range(0, n_b, self.MAX_BUF):
            nb = min(self.MAX_BUF, n_b - bs)
            for as_ in range(0, n_a, self.MAX_ROWS):
                na = min(self.MAX_ROWS, n_a - as_)
                env = {k: v[as_:as_ + na, None] for k, v in a_lanes.items()}
                env.update({k: v[None, bs:bs + nb]
                            for k, v in b_lanes.items()})
                env[N_KEY] = na * nb
                m = torch.as_tensor(self.condition.fn(env), device=self.device)
                out[as_:as_ + na, bs:bs + nb] = m.to(torch.bool).expand(na, nb)
                self.blocks += 1
        return out

    def mask(self, side: JoinSide, rows: EventBatch, other: JoinSide,
             buf: EventBatch) -> Optional[np.ndarray]:
        """The ``[n_a, n_b]`` condition mask as numpy, or None when this
        batch takes the numpy probe (nulls in a lane column)."""
        staged = self._stage(side, rows, other, buf)
        if staged is None:
            return None
        m = self._device_mask(*staged, len(rows), len(buf))
        return self._fetch([m])[0]

    def pairs(self, side: JoinSide, rows: EventBatch, other: JoinSide,
              buf: EventBatch, outer: bool
              ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                  Optional[np.ndarray]]]:
        """``(ai, bi, matched_any)``: the matched pairs in row-major
        order and, for an outer join, each row's matched-any flag (else
        None); None when this batch takes the numpy probe."""
        staged = self._stage(side, rows, other, buf)
        if staged is None:
            return None
        m = self._device_mask(*staged, len(rows), len(buf))
        idx = torch.nonzero(m).to(torch.int32)
        arrays = [idx[:, 0], idx[:, 1]]
        if outer:
            arrays.append(m.any(dim=1).to(torch.int32))
        host = self._fetch(arrays)
        ai = host[0].astype(np.intp)
        bi = host[1].astype(np.intp)
        return ai, bi, (host[2].astype(bool) if outer else None)

    def _fetch(self, arrays) -> List[np.ndarray]:
        host = fetch_coalesced(arrays)
        self.fetches += 1
        self.bytes_fetched += sum(h.nbytes for h in host)
        return host


_TORCH = {np.dtype(np.int32): torch.int32, np.dtype(np.bool_): torch.bool,
          np.dtype(np.float32): torch.float32}


class JoinRuntime:
    """Drives both sides and emits joined batches to the query's
    selector (``emit``); a scheduler task for the time windows of
    either side."""

    def __init__(self, left: JoinSide, right: JoinSide, join_type: str,
                 condition: Optional[CompiledExpression], emit,
                 out_stream_id: str):
        self.left = left
        self.right = right
        self.join_type = join_type
        self.condition = condition
        self.emit = emit
        self.out_stream_id = out_stream_id
        # set by the planner under @app:execution('tpu') when the
        # condition can run on the device
        self.device_probe: Optional[DeviceJoinProbe] = None
        self.probe_invocations = 0  # batches the device probe took
        self._out_names = (
            [left.qualified_key(a.name) for a in left.definition.attributes]
            + [right.qualified_key(a.name)
               for a in right.definition.attributes])

    # -- event entry ---------------------------------------------------------

    def on_event(self, side_is_left: bool, batch: EventBatch, now: int):
        side = self.left if side_is_left else self.right
        other = self.right if side_is_left else self.left
        b = batch
        for f in side.filters:
            b = f.process(b, now)
            if len(b) == 0:
                return
        outs: List[EventBatch] = []
        cur = b.only(ev.CURRENT)
        # before the window: arriving CURRENT rows probe the other side
        if side.triggers and len(cur):
            j = self._join(side, cur, other, ev.CURRENT)
            if j is not None:
                outs.append(j)
        # the window: buffer; the rows it expires probe as EXPIRED
        if side.window is not None:
            wout = side.window.process(b, now)
            expired = wout.only(ev.EXPIRED)
            if side.triggers and len(expired):
                j = self._join(side, expired, other, ev.EXPIRED)
                if j is not None:
                    outs.append(j)
        elif side.named_window is not None and side.triggers:
            # a named window delivers its own EXPIRED flow
            expired = b.only(ev.EXPIRED)
            if len(expired):
                j = self._join(side, expired, other, ev.EXPIRED)
                if j is not None:
                    outs.append(j)
        if outs:
            self.emit(EventBatch.concat(outs), now)

    # -- scheduler task ------------------------------------------------------

    def next_wakeup(self) -> Optional[int]:
        cands = [w for w in (s.window.next_wakeup()
                             for s in (self.left, self.right)
                             if s.window is not None) if w is not None]
        return min(cands) if cands else None

    def fire(self, now: int):
        for side, other in ((self.left, self.right),
                            (self.right, self.left)):
            if side.window is None:
                continue
            out = side.window.on_time(now)
            if out is None or not side.triggers:
                continue
            expired = out.only(ev.EXPIRED)
            if len(expired):
                j = self._join(side, expired, other, ev.EXPIRED)
                if j is not None:
                    self.emit(j, now)

    # -- the probe -----------------------------------------------------------

    def _join(self, side: JoinSide, rows: EventBatch, other: JoinSide,
              out_type: int) -> Optional[EventBatch]:
        probe_env = None
        if other.aggregation is not None and len(rows):
            # `within`/`per` may read the arriving event: evaluated on the
            # first probing row
            probe_env = {side.qualified_key(a.name): rows.columns[a.name][:1]
                         for a in side.definition.attributes}
            probe_env[TS_KEY] = rows.timestamps[:1]
            probe_env[N_KEY] = 1
        buf = other.buffered(probe_env)
        n_a = len(rows)
        n_b = len(buf) if buf is not None else 0
        is_outer = self._side_outer(side)
        if n_b == 0:
            if not is_outer:
                return None
            return self._with_nulls(side, rows, other, out_type)

        # the pairs: all of them, the device probe's, or the numpy
        # cross product (also a null-carrying batch's under the probe)
        got = None
        if self.condition is None:
            mask2 = np.ones((n_a, n_b), dtype=bool)
        elif self.device_probe is not None:
            got = self.device_probe.pairs(side, rows, other, buf, is_outer)
            if got is not None:
                self.probe_invocations += 1
        if got is None:
            if self.condition is not None:
                env: Dict[str, np.ndarray] = {}
                for a in side.definition.attributes:
                    env[side.qualified_key(a.name)] = np.repeat(
                        rows.columns[a.name], n_b)
                for a in other.definition.attributes:
                    env[other.qualified_key(a.name)] = np.tile(
                        buf.columns[a.name], n_a)
                env[TS_KEY] = np.repeat(rows.timestamps, n_b)
                env[N_KEY] = n_a * n_b
                mask2 = np.broadcast_to(
                    np.asarray(self.condition.fn(env)),
                    (n_a * n_b,)).reshape(n_a, n_b)
            ai, bi = np.nonzero(mask2)
            matched_any = mask2.any(axis=1) if is_outer else None
        else:
            ai, bi, matched_any = got

        # the matched pairs in O(matches), row-major
        cols: Dict[str, np.ndarray] = {}
        for a in side.definition.attributes:
            cols[side.qualified_key(a.name)] = np.asarray(
                rows.columns[a.name])[ai]
        for a in other.definition.attributes:
            cols[other.qualified_key(a.name)] = np.asarray(
                buf.columns[a.name])[bi]
        out = EventBatch(
            self.out_stream_id, self._out_names,
            {k: cols[k] for k in self._out_names},
            np.asarray(rows.timestamps)[ai],
            np.full(len(ai), out_type, dtype=np.int8))
        if is_outer and not matched_any.all():
            unmatched = rows.mask(~matched_any)
            out = EventBatch.concat(
                [out, self._with_nulls(side, unmatched, other, out_type)])
        return out if len(out) else None

    def _side_outer(self, side: JoinSide) -> bool:
        """Does this side emit its unmatched rows, the other side
        nulled?  A left outer join keeps the left rows, and so on."""
        if self.join_type == JoinInputStream.FULL_OUTER:
            return True
        if self.join_type == JoinInputStream.LEFT_OUTER:
            return side is self.left
        if self.join_type == JoinInputStream.RIGHT_OUTER:
            return side is self.right
        return False

    def _with_nulls(self, side: JoinSide, rows: EventBatch,
                    other: JoinSide, out_type: int) -> EventBatch:
        n = len(rows)
        cols: Dict[str, np.ndarray] = {}
        for a in side.definition.attributes:
            cols[side.qualified_key(a.name)] = rows.columns[a.name]
        for a in other.definition.attributes:
            cols[other.qualified_key(a.name)] = _null_column(a.type, n)
        return EventBatch(
            self.out_stream_id, self._out_names,
            {k: cols[k] for k in self._out_names}, rows.timestamps,
            np.full(n, out_type, dtype=np.int8))


class JoinStreamReceiver:
    """Junction subscriber feeding one side of the join."""

    def __init__(self, join_runtime: JoinRuntime, side_is_left: bool,
                 app_context):
        self.join_runtime = join_runtime
        self.side_is_left = side_is_left
        self.app_context = app_context

    def receive(self, batch: EventBatch):
        now = self.app_context.timestamp_generator.current_time()
        self.join_runtime.on_event(self.side_is_left, batch, now)
