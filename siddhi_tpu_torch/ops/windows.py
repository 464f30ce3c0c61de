"""Window processors.

Port of the JAX package's ``ops/windows.py`` (all 17 built-in windows),
itself a re-design of the reference's 30 window implementations
(query/processor/stream/window/*WindowProcessor.java) as columnar
operators: each window keeps buffered rows as arrays and, per input
batch, returns a combined batch of CURRENT (arrivals) and EXPIRED
(evictions) events plus optional RESET markers for batch windows.
Downstream aggregators add CURRENT rows and subtract EXPIRED rows, which
reproduces the reference's windowed-aggregation semantics.

Time-driven windows receive ``on_time(now)`` ticks from the scheduler
(watermark-driven in playback mode).
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from siddhi_tpu_torch.compiler.parser import Parser
from siddhi_tpu_torch.compiler.tokenizer import tokenize
from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.core.query import build_env
from siddhi_tpu_torch.extension.registry import extension
from siddhi_tpu_torch.extension.validator import REPEAT, Param
from siddhi_tpu_torch.planner.host_expr import CompiledExpression
from siddhi_tpu_torch.query_api import expression as X
from siddhi_tpu_torch.query_api.attribute import AttrType
from siddhi_tpu_torch.util.cron import CronSchedule

log = logging.getLogger("siddhi_tpu_torch")

# common @Parameter type sets for the builtin window declarations
_INTS = (AttrType.INT, AttrType.LONG)
_FLOATS = (AttrType.FLOAT, AttrType.DOUBLE)


class WindowProcessor:
    """Base window operator.

    ``process(batch, now)`` -> output batch (CURRENT + EXPIRED [+ RESET]).
    ``on_time(now)`` -> output batch for scheduler ticks (time windows).
    ``next_wakeup()`` -> absolute ms when a tick is needed, or None.
    """

    needs_scheduler = False

    def __init__(self, args: List[CompiledExpression], attribute_names: List[str]):
        self.args = args
        self.attribute_names = attribute_names

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        raise NotImplementedError

    def on_time(self, now: int) -> Optional[EventBatch]:
        return None

    def next_wakeup(self) -> Optional[int]:
        return None

    # findable-processor surface for joins / on-demand queries
    def buffered(self) -> Optional[EventBatch]:
        return None

    def snapshot(self) -> Dict:
        return {}

    def restore(self, state: Dict):
        pass

    @staticmethod
    def _const_int(c: CompiledExpression, what: str) -> int:
        try:
            return int(c.fn({}))
        except Exception as e:
            raise SiddhiAppCreationError(f"{what} must be a constant") from e


def _empty_like(b: EventBatch) -> EventBatch:
    return EventBatch(
        b.stream_id,
        b.attribute_names,
        {k: v[:0] for k, v in b.columns.items()},
        b.timestamps[:0],
        b.types[:0],
    )


def reset_marker(template: EventBatch, now: int) -> EventBatch:
    """One-row RESET event (default-valued data) telling downstream
    aggregators to clear state — the ComplexEvent.Type.RESET analog."""
    cols = {}
    for k, v in template.columns.items():
        if v.dtype == object:
            col = np.empty(1, dtype=object)
            col[0] = None
        else:
            col = np.zeros(1, dtype=v.dtype)
        cols[k] = col
    return EventBatch(
        template.stream_id,
        template.attribute_names,
        cols,
        np.asarray([now], dtype=np.int64),
        np.asarray([ev.RESET], dtype=np.int8),
    )


@extension("window", "length")
class LengthWindow(WindowProcessor):
    """Sliding length window (reference: LengthWindowProcessor).

    Keeps the last N events; each arrival beyond capacity expires the
    oldest buffered event.
    """

    PARAMETERS = (Param('window.length', _INTS),)
    OVERLOADS = (('window.length',),)

    def __init__(self, args, attribute_names):
        super().__init__(args, attribute_names)
        self.length = self._const_int(args[0], "length window size")
        self._buf: Optional[EventBatch] = None

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        cur = batch.only(ev.CURRENT)
        if self._buf is None:
            self._buf = _empty_like(cur)
        prev_len = len(self._buf)
        combined = EventBatch.concat([self._buf, cur])
        n_total = len(combined)
        n_over = max(0, n_total - self.length)
        self._buf = combined.take(np.arange(n_over, n_total))
        if n_over == 0:
            return cur
        # interleave so each arrival's eviction directly precedes it
        # (reference inserts the evicted clone before the current event,
        # LengthWindowProcessor), keeping aggregate subtract-then-add order
        order: List[int] = []
        types: List[int] = []
        for i in range(len(cur)):
            evict_idx = prev_len + i - self.length
            if evict_idx >= 0:
                order.append(evict_idx)
                types.append(ev.EXPIRED)
            order.append(prev_len + i)
            types.append(ev.CURRENT)
        out = combined.take(np.asarray(order))
        out.types = np.asarray(types, dtype=np.int8)
        out.timestamps = np.where(
            out.types == ev.EXPIRED, now, out.timestamps
        ).astype(np.int64)
        return out

    def buffered(self) -> Optional[EventBatch]:
        return self._buf

    def snapshot(self):
        return {"buf": self._buf}

    def restore(self, state):
        self._buf = state["buf"]


@extension("window", "lengthBatch")
class LengthBatchWindow(WindowProcessor):
    """Tumbling length window (reference: LengthBatchWindowProcessor).

    Collects N events, then flushes them as CURRENT while expiring the
    previous batch; emits a RESET marker before each flush so downstream
    aggregators restart per batch.
    """

    PARAMETERS = (Param('window.length', _INTS),)
    OVERLOADS = (('window.length',),)

    is_batch = True  # selector emits last-row-per-group (ProcessingMode.BATCH)

    def __init__(self, args, attribute_names):
        super().__init__(args, attribute_names)
        self.length = self._const_int(args[0], "lengthBatch window size")
        self._pending: Optional[EventBatch] = None
        self._last_flushed: Optional[EventBatch] = None

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        cur = batch.only(ev.CURRENT)
        if self._pending is None:
            self._pending = _empty_like(cur)
        self._pending = EventBatch.concat([self._pending, cur])
        outs: List[EventBatch] = []
        while len(self._pending) >= self.length:
            flush = self._pending.take(np.arange(self.length))
            self._pending = self._pending.take(
                np.arange(self.length, len(self._pending))
            )
            if self._last_flushed is not None and len(self._last_flushed):
                exp = self._last_flushed.with_types(ev.EXPIRED)
                exp.timestamps = np.full(len(exp), now, dtype=np.int64)
                outs.append(exp)
            # RESET clears batch aggregators between tumbles
            outs.append(reset_marker(cur, now))
            outs.append(flush)
            self._last_flushed = flush
        if not outs:
            return _empty_like(cur)
        return EventBatch.concat(outs)

    def buffered(self) -> Optional[EventBatch]:
        return self._pending

    def snapshot(self):
        return {"pending": self._pending, "last": self._last_flushed}

    def restore(self, state):
        self._pending = state["pending"]
        self._last_flushed = state["last"]


@extension("window", "time")
class TimeWindow(WindowProcessor):
    """Sliding time window (reference: TimeWindowProcessor): each event
    expires ``t`` ms after arrival; evictions fire on scheduler ticks."""

    PARAMETERS = (Param('window.time', _INTS),)
    OVERLOADS = (('window.time',),)

    needs_scheduler = True

    def __init__(self, args, attribute_names):
        super().__init__(args, attribute_names)
        self.time_ms = self._const_int(args[0], "time window duration")
        self._buf: Optional[EventBatch] = None

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        cur = batch.only(ev.CURRENT)
        if self._buf is None:
            self._buf = _empty_like(cur)
        expired = self._expire(now)
        if len(cur):
            self._buf = EventBatch.concat([self._buf, cur])
        parts = [b for b in (expired, cur) if b is not None and len(b)]
        return EventBatch.concat(parts) if parts else _empty_like(cur)

    def _expire(self, now: int) -> Optional[EventBatch]:
        if self._buf is None or len(self._buf) == 0:
            return None
        dead = self._buf.timestamps + self.time_ms <= now
        if not dead.any():
            return None
        expired = self._buf.mask(dead).with_types(ev.EXPIRED)
        expired.timestamps = np.full(len(expired), now, dtype=np.int64)
        self._buf = self._buf.mask(~dead)
        return expired

    def on_time(self, now: int) -> Optional[EventBatch]:
        return self._expire(now)

    def next_wakeup(self) -> Optional[int]:
        if self._buf is None or len(self._buf) == 0:
            return None
        return int(self._buf.timestamps.min()) + self.time_ms

    def buffered(self) -> Optional[EventBatch]:
        return self._buf

    def snapshot(self):
        return {"buf": self._buf}

    def restore(self, state):
        self._buf = state["buf"]


@extension("window", "timeBatch")
class TimeBatchWindow(WindowProcessor):
    """Tumbling time window (reference: TimeBatchWindowProcessor): collects
    events per period, flushes CURRENT at each boundary and expires the
    previous flush."""

    PARAMETERS = (Param('window.time', _INTS),)
    OVERLOADS = (('window.time',),)

    needs_scheduler = True
    is_batch = True

    def __init__(self, args, attribute_names):
        super().__init__(args, attribute_names)
        self.time_ms = self._const_int(args[0], "timeBatch window duration")
        self._pending: Optional[EventBatch] = None
        self._last_flushed: Optional[EventBatch] = None
        self._window_end: Optional[int] = None

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        cur = batch.only(ev.CURRENT)
        if self._pending is None:
            self._pending = _empty_like(cur)
        if self._window_end is None and len(cur):
            self._window_end = int(cur.timestamps[0]) + self.time_ms
        out = self._maybe_flush(now)
        if len(cur):
            self._pending = EventBatch.concat([self._pending, cur])
            if self._window_end is None:
                # flush above went idle; this arrival starts a new period
                self._window_end = int(cur.timestamps[0]) + self.time_ms
        return out if out is not None else _empty_like(cur)

    def _maybe_flush(self, now: int) -> Optional[EventBatch]:
        if self._window_end is None or now < self._window_end:
            return None
        outs: List[EventBatch] = []
        while self._window_end is not None and now >= self._window_end:
            flush = self._pending
            self._pending = _empty_like(flush)
            if self._last_flushed is not None and len(self._last_flushed):
                exp = self._last_flushed.with_types(ev.EXPIRED)
                exp.timestamps = np.full(len(exp), self._window_end, dtype=np.int64)
                outs.append(exp)
            if len(flush) or (self._last_flushed is not None and len(self._last_flushed)):
                outs.append(reset_marker(flush, self._window_end))
            if len(flush):
                outs.append(flush)
            self._last_flushed = flush
            if len(self._pending) == 0 and len(flush) == 0:
                self._window_end = None  # go idle until next event
            else:
                self._window_end += self.time_ms
        return EventBatch.concat(outs) if outs else None

    def on_time(self, now: int) -> Optional[EventBatch]:
        return self._maybe_flush(now)

    def next_wakeup(self) -> Optional[int]:
        return self._window_end

    def buffered(self) -> Optional[EventBatch]:
        return self._pending

    def snapshot(self):
        return {"pending": self._pending, "last": self._last_flushed, "end": self._window_end}

    def restore(self, state):
        self._pending, self._last_flushed, self._window_end = (
            state["pending"], state["last"], state["end"]
        )


@extension("window", "externalTime")
class ExternalTimeWindow(WindowProcessor):
    """Sliding window over an event-time attribute (reference:
    ExternalTimeWindowProcessor) — expiry driven purely by arriving
    events' timestamps, no scheduler."""

    PARAMETERS = (Param('timestamp', (AttrType.LONG,)),
                  Param('window.time', _INTS))
    OVERLOADS = (('timestamp', 'window.time'),)

    def __init__(self, args, attribute_names):
        super().__init__(args, attribute_names)
        # args: (timestamp variable, duration)
        self.ts_expr = args[0]
        self.time_ms = self._const_int(args[1], "externalTime duration")
        # buffer of (1-row EventBatch, external ts), insertion-ordered;
        # external timestamps are monotone in practice, so expiry pops the
        # front — O(evictions) per batch, no full-buffer copies
        self._buf = deque()

    def _event_ts(self, batch: EventBatch) -> np.ndarray:

        return np.broadcast_to(
            np.asarray(self.ts_expr.fn(build_env(batch))), (len(batch),)
        ).astype(np.int64)

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        cur = batch.only(ev.CURRENT)
        outs: List[EventBatch] = []
        ets = self._event_ts(cur) if len(cur) else np.empty(0, dtype=np.int64)
        for i in range(len(cur)):
            t_i = int(ets[i])
            cutoff = t_i - self.time_ms
            while self._buf and self._buf[0][1] <= cutoff:
                row, _ = self._buf.popleft()
                exp = row.with_types(ev.EXPIRED)
                exp.timestamps = np.full(len(exp), t_i, dtype=np.int64)
                outs.append(exp)
            row = cur.take(np.asarray([i]))
            outs.append(row)
            self._buf.append((row, t_i))
        return EventBatch.concat(outs) if outs else _empty_like(cur)

    def buffered(self) -> Optional[EventBatch]:
        if not self._buf:
            return None
        return EventBatch.concat([r for r, _ in self._buf])

    def snapshot(self):
        return {"buf": self._buf}

    def restore(self, state):
        self._buf = state["buf"]


@extension("window", "externalTimeBatch")
class ExternalTimeBatchWindow(WindowProcessor):
    """Tumbling window over an event-time attribute (reference:
    ExternalTimeBatchWindowProcessor)."""

    PARAMETERS = (Param('timestamp', (AttrType.LONG,)),
                  Param('window.time', _INTS),
                  Param('start.time', _INTS))
    OVERLOADS = (('timestamp', 'window.time'),
                 ('timestamp', 'window.time', 'start.time'))

    is_batch = True

    def __init__(self, args, attribute_names):
        super().__init__(args, attribute_names)
        self.ts_expr = args[0]
        self.time_ms = self._const_int(args[1], "externalTimeBatch duration")
        self.start_ts = self._const_int(args[2], "start time") if len(args) > 2 else None
        self._pending: Optional[EventBatch] = None
        self._last_flushed: Optional[EventBatch] = None
        self._window_end: Optional[int] = None

    def _event_ts(self, batch: EventBatch) -> np.ndarray:

        return np.broadcast_to(
            np.asarray(self.ts_expr.fn(build_env(batch))), (len(batch),)
        ).astype(np.int64)

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        cur = batch.only(ev.CURRENT)
        if self._pending is None:
            self._pending = _empty_like(cur)
        outs: List[EventBatch] = []
        ets = self._event_ts(cur) if len(cur) else np.empty(0, dtype=np.int64)
        for i in range(len(cur)):
            t_i = int(ets[i])
            if self._window_end is None:
                base = self.start_ts if self.start_ts is not None else t_i
                self._window_end = base + self.time_ms
            while t_i >= self._window_end:
                flush = self._pending
                self._pending = _empty_like(flush)
                if self._last_flushed is not None and len(self._last_flushed):
                    exp = self._last_flushed.with_types(ev.EXPIRED)
                    exp.timestamps = np.full(len(exp), self._window_end, dtype=np.int64)
                    outs.append(exp)
                if len(flush):
                    outs.append(reset_marker(flush, self._window_end))
                    outs.append(flush)
                # empty windows also replace the last flush, so an old batch
                # cannot be re-expired on every empty period
                self._last_flushed = flush
                self._window_end += self.time_ms
            row = cur.take(np.asarray([i]))
            self._pending = EventBatch.concat([self._pending, row])
        return EventBatch.concat(outs) if outs else _empty_like(cur)

    def buffered(self) -> Optional[EventBatch]:
        return self._pending

    def snapshot(self):
        return {"pending": self._pending, "last": self._last_flushed, "end": self._window_end}

    def restore(self, state):
        self._pending, self._last_flushed, self._window_end = (
            state["pending"], state["last"], state["end"]
        )


@extension("window", "timeLength")
class TimeLengthWindow(WindowProcessor):
    """Sliding window bounded by both time and count (reference:
    TimeLengthWindowProcessor)."""

    PARAMETERS = (Param('window.time', _INTS),
                  Param('window.length', _INTS))
    OVERLOADS = (('window.time', 'window.length'),)

    needs_scheduler = True

    def __init__(self, args, attribute_names):
        super().__init__(args, attribute_names)
        self.time_ms = self._const_int(args[0], "timeLength duration")
        self.length = self._const_int(args[1], "timeLength size")
        self._buf: Optional[EventBatch] = None

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        cur = batch.only(ev.CURRENT)
        if self._buf is None:
            self._buf = _empty_like(cur)
        outs: List[EventBatch] = []
        exp = self._expire_time(now)
        if exp is not None and len(exp):
            outs.append(exp)
        for i in range(len(cur)):
            if len(self._buf) >= self.length:
                evict = self._buf.take(np.asarray([0])).with_types(ev.EXPIRED)
                evict.timestamps = np.full(1, now, dtype=np.int64)
                outs.append(evict)
                self._buf = self._buf.take(np.arange(1, len(self._buf)))
            row = cur.take(np.asarray([i]))
            outs.append(row)
            self._buf = EventBatch.concat([self._buf, row])
        return EventBatch.concat(outs) if outs else _empty_like(cur)

    def _expire_time(self, now: int) -> Optional[EventBatch]:
        if self._buf is None or len(self._buf) == 0:
            return None
        dead = self._buf.timestamps + self.time_ms <= now
        if not dead.any():
            return None
        expired = self._buf.mask(dead).with_types(ev.EXPIRED)
        expired.timestamps = np.full(len(expired), now, dtype=np.int64)
        self._buf = self._buf.mask(~dead)
        return expired

    def on_time(self, now: int) -> Optional[EventBatch]:
        return self._expire_time(now)

    def next_wakeup(self) -> Optional[int]:
        if self._buf is None or len(self._buf) == 0:
            return None
        return int(self._buf.timestamps.min()) + self.time_ms

    def buffered(self) -> Optional[EventBatch]:
        return self._buf

    def snapshot(self):
        return {"buf": self._buf}

    def restore(self, state):
        self._buf = state["buf"]


@extension("window", "delay")
class DelayWindow(WindowProcessor):
    """Holds events for ``t`` ms, then releases them as CURRENT
    (reference: DelayWindowProcessor)."""

    PARAMETERS = (Param('window.delay', _INTS),)
    OVERLOADS = (('window.delay',),)

    needs_scheduler = True

    def __init__(self, args, attribute_names):
        super().__init__(args, attribute_names)
        self.time_ms = self._const_int(args[0], "delay duration")
        self._buf: Optional[EventBatch] = None

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        cur = batch.only(ev.CURRENT)
        if self._buf is None:
            self._buf = _empty_like(cur)
        out = self._release(now)
        if len(cur):
            self._buf = EventBatch.concat([self._buf, cur])
        return out if out is not None else _empty_like(cur)

    def _release(self, now: int) -> Optional[EventBatch]:
        if self._buf is None or len(self._buf) == 0:
            return None
        due = self._buf.timestamps + self.time_ms <= now
        if not due.any():
            return None
        released = self._buf.mask(due)  # stays CURRENT
        self._buf = self._buf.mask(~due)
        return released

    def on_time(self, now: int) -> Optional[EventBatch]:
        return self._release(now)

    def next_wakeup(self) -> Optional[int]:
        if self._buf is None or len(self._buf) == 0:
            return None
        return int(self._buf.timestamps.min()) + self.time_ms

    def snapshot(self):
        return {"buf": self._buf}

    def restore(self, state):
        self._buf = state["buf"]


@extension("window", "sort")
class SortWindow(WindowProcessor):
    """Keeps the N smallest/largest events by sort keys (reference:
    SortWindowProcessor): when over capacity, evicts the greatest (asc)
    or smallest (desc) as EXPIRED."""

    PARAMETERS = (Param('window.length', _INTS),
                  Param('attribute'))
    OVERLOADS = (('window.length',),
                 ('window.length', 'attribute', REPEAT))

    def __init__(self, args, attribute_names):
        super().__init__(args, attribute_names)
        self.length = self._const_int(args[0], "sort window size")
        # remaining args: key expressions with optional 'asc'/'desc' consts
        self.keys: List[Tuple[object, bool]] = []
        i = 1
        while i < len(args):
            expr = args[i]
            asc = True
            if i + 1 < len(args):
                try:
                    nxt = args[i + 1].fn({})
                    if isinstance(nxt, str) and nxt.lower() in ("asc", "desc"):
                        asc = nxt.lower() == "asc"
                        i += 1
                except Exception as e:
                    # next arg is a key expression, not an asc/desc
                    # const — expected for non-constant args; traced so
                    # no construction fault vanishes silently
                    log.debug(
                        "sort window: arg %d is not an order const "
                        "(%s); treating it as a key expression", i + 1, e)
            self.keys.append((expr, asc))
            i += 1
        self._buf: Optional[EventBatch] = None

    def process(self, batch: EventBatch, now: int) -> EventBatch:

        cur = batch.only(ev.CURRENT)
        if self._buf is None:
            self._buf = _empty_like(cur)
        outs: List[EventBatch] = []
        for i in range(len(cur)):
            row = cur.take(np.asarray([i]))
            outs.append(row)
            self._buf = EventBatch.concat([self._buf, row])
            if len(self._buf) > self.length:
                order = self._sorted_order()
                evict_pos = order[-1]
                evict = self._buf.take(np.asarray([evict_pos])).with_types(ev.EXPIRED)
                evict.timestamps = np.full(1, now, dtype=np.int64)
                outs.append(evict)
                keep = np.ones(len(self._buf), dtype=bool)
                keep[evict_pos] = False
                self._buf = self._buf.mask(keep)
        return EventBatch.concat(outs) if outs else _empty_like(cur)

    def _sorted_order(self) -> np.ndarray:

        env = build_env(self._buf)
        idx = np.arange(len(self._buf))
        for expr, asc in reversed(self.keys):
            col = np.broadcast_to(np.asarray(expr.fn(env)), (len(self._buf),))
            _, dense = np.unique(col[idx], return_inverse=True)
            order = np.argsort(dense if asc else -dense, kind="stable")
            idx = idx[order]
        return idx

    def buffered(self) -> Optional[EventBatch]:
        return self._buf

    def snapshot(self):
        return {"buf": self._buf}

    def restore(self, state):
        self._buf = state["buf"]


@extension("window", "frequent")
class FrequentWindow(WindowProcessor):
    """Misra-Gries frequent-event window (reference:
    FrequentWindowProcessor): keeps events whose key is among the N
    highest-frequency keys; evicted keys' events expire."""

    PARAMETERS = (Param('event.count', _INTS),
                  Param('attribute'))
    OVERLOADS = (('event.count',),
                 ('event.count', 'attribute', REPEAT))

    def __init__(self, args, attribute_names):
        super().__init__(args, attribute_names)
        self.n = self._const_int(args[0], "frequent count")
        self.key_exprs = list(args[1:])  # empty: whole-row key
        self.attribute_names = attribute_names
        self._counts: Dict = {}
        self._rows: Dict = {}  # key -> latest row (1-row EventBatch)

    def _key_of(self, row: EventBatch):

        def unbox(v):
            return v.item() if isinstance(v, np.generic) else v

        if self.key_exprs:
            env = build_env(row)
            return tuple(
                unbox(np.asarray(e.fn(env)).reshape(-1)[0]) for e in self.key_exprs
            )
        return tuple(unbox(row.columns[a][0]) for a in row.attribute_names)

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        cur = batch.only(ev.CURRENT)
        outs: List[EventBatch] = []
        for i in range(len(cur)):
            row = cur.take(np.asarray([i]))
            key = self._key_of(row)
            if key in self._counts:
                self._counts[key] += 1
                self._rows[key] = row
                outs.append(row)
            elif len(self._counts) < self.n:
                self._counts[key] = 1
                self._rows[key] = row
                outs.append(row)
            else:
                # decrement all; evict zeros (Misra-Gries)
                for k in list(self._counts):
                    self._counts[k] -= 1
                    if self._counts[k] == 0:
                        del self._counts[k]
                        evict = self._rows.pop(k).with_types(ev.EXPIRED)
                        evict.timestamps = np.full(1, now, dtype=np.int64)
                        outs.append(evict)
        return EventBatch.concat(outs) if outs else _empty_like(cur)

    def snapshot(self):
        return {"counts": self._counts, "rows": self._rows}

    def restore(self, state):
        self._counts, self._rows = state["counts"], state["rows"]


@extension("window", "lossyFrequent")
class LossyFrequentWindow(WindowProcessor):
    """Lossy-counting frequent window (reference:
    LossyFrequentWindowProcessor(support, [error], keys...))."""

    PARAMETERS = (Param('support.threshold', _FLOATS),
                  Param('error.bound', _FLOATS),
                  Param('attribute'))
    OVERLOADS = (('support.threshold',),
                 ('support.threshold', 'error.bound'),
                 ('support.threshold', 'error.bound', 'attribute', REPEAT))

    def __init__(self, args, attribute_names):
        super().__init__(args, attribute_names)
        self.support = float(args[0].fn({}))
        i = 1
        self.error = self.support / 10.0
        if len(args) > 1:
            try:
                v = args[1].fn({})
                if isinstance(v, (float, np.floating)):
                    self.error = float(v)
                    i = 2
            except Exception as e:
                # arg 2 is an attribute expression, not an error-bound
                # const — expected overload ambiguity; traced so no
                # construction fault vanishes silently
                log.debug(
                    "lossyFrequent window: arg 2 is not an error-bound "
                    "const (%s); defaulting error to support/10", e)
        self.key_exprs = list(args[i:])
        self.attribute_names = attribute_names
        self._counts: Dict = {}
        self._deltas: Dict = {}
        self._rows: Dict = {}
        self._total = 0

    _key_of = FrequentWindow._key_of

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        cur = batch.only(ev.CURRENT)
        outs: List[EventBatch] = []
        for i in range(len(cur)):
            self._total += 1
            bucket = int(np.ceil(self._total * self.error))
            row = cur.take(np.asarray([i]))
            key = self._key_of(row)
            if key in self._counts:
                self._counts[key] += 1
            else:
                self._counts[key] = 1
                self._deltas[key] = bucket - 1
            self._rows[key] = row
            # emit current if above support threshold
            if self._counts[key] >= (self.support - self.error) * self._total:
                outs.append(row)
            # periodic pruning
            for k in list(self._counts):
                if self._counts[k] + self._deltas[k] <= bucket:
                    del self._counts[k]
                    self._deltas.pop(k, None)
                    evict = self._rows.pop(k).with_types(ev.EXPIRED)
                    evict.timestamps = np.full(1, now, dtype=np.int64)
                    outs.append(evict)
        return EventBatch.concat(outs) if outs else _empty_like(cur)

    def snapshot(self):
        return {
            "counts": self._counts, "deltas": self._deltas,
            "rows": self._rows, "total": self._total,
        }

    def restore(self, state):
        self._counts = state["counts"]
        self._deltas = state["deltas"]
        self._rows = state["rows"]
        self._total = state["total"]


@extension("window", "hopping")
class HoppingWindow(WindowProcessor):
    """Hopping window ``#window.hopping(windowTime, hopTime)``: every
    ``hopTime`` emits the pane of events whose timestamps fall within the
    trailing ``windowTime``; with overlap (hop < window) an event appears
    in multiple panes, and ``hop == window`` degenerates to the tumbling
    ``timeBatch``.  Each boundary expires the previous pane wholesale and
    precedes the new pane with a RESET marker, mirroring
    TimeBatchWindowProcessor's previous-flush expiry.

    Reference: query/processor/stream/window/HopingWindowProcessor.java —
    an abstract HOP-mode SPI base with no concrete subclass in-core; this
    is the concrete realization (pane boundary = the reference's
    ``_hopingTimestamp`` grouping key, carried here as the EXPIRED/RESET
    timestamps)."""

    PARAMETERS = (Param('window.time', _INTS),
                  Param('hop.time', _INTS))
    OVERLOADS = (('window.time', 'hop.time'),)

    needs_scheduler = True
    is_batch = True

    def __init__(self, args, attribute_names):
        super().__init__(args, attribute_names)
        if len(args) != 2:
            raise SiddhiAppCreationError(
                "hopping window needs (windowTime, hopTime), "
                f"got {len(args)} args")
        self.window_ms = self._const_int(args[0], "hopping window duration")
        self.hop_ms = self._const_int(args[1], "hopping window hop")
        if self.window_ms <= 0 or self.hop_ms <= 0:
            raise SiddhiAppCreationError(
                "hopping window duration and hop must be positive")
        self._buffer: Optional[EventBatch] = None
        self._last_pane: Optional[EventBatch] = None
        self._boundary: Optional[int] = None  # next pane-emission time

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        cur = batch.only(ev.CURRENT)
        if self._buffer is None:
            self._buffer = _empty_like(cur)
        if self._boundary is None and len(cur):
            self._boundary = int(cur.timestamps[0]) + self.window_ms
        out = self._maybe_flush(now)
        if len(cur):
            self._buffer = EventBatch.concat([self._buffer, cur])
            if self._boundary is None:
                # flush above went idle; this arrival starts a new window
                self._boundary = int(cur.timestamps[0]) + self.window_ms
        return out if out is not None else _empty_like(cur)

    def _maybe_flush(self, now: int) -> Optional[EventBatch]:
        if self._boundary is None or now < self._boundary:
            return None
        outs: List[EventBatch] = []
        while self._boundary is not None and now >= self._boundary:
            b = self._boundary
            ts = self._buffer.timestamps
            # pane covers [b - window, b): a boundary-timestamped event
            # belongs to the NEXT pane, exactly like timeBatch's flush
            pane = self._buffer.mask((ts >= b - self.window_ms) & (ts < b))
            # evict rows that can never appear in a later pane
            self._buffer = self._buffer.mask(
                ts >= b + self.hop_ms - self.window_ms)
            if self._last_pane is not None and len(self._last_pane):
                exp = self._last_pane.with_types(ev.EXPIRED)
                exp.timestamps = np.full(len(exp), b, dtype=np.int64)
                outs.append(exp)
            if len(pane) or (self._last_pane is not None and len(self._last_pane)):
                outs.append(reset_marker(pane, b))
            if len(pane):
                outs.append(pane)
            self._last_pane = pane
            if len(self._buffer) == 0 and len(pane) == 0:
                self._boundary = None  # go idle until next event
            else:
                self._boundary += self.hop_ms
        return EventBatch.concat(outs) if outs else None

    def on_time(self, now: int) -> Optional[EventBatch]:
        return self._maybe_flush(now)

    def next_wakeup(self) -> Optional[int]:
        return self._boundary

    def buffered(self) -> Optional[EventBatch]:
        return self._buffer

    def snapshot(self):
        return {"buffer": self._buffer, "last": self._last_pane,
                "boundary": self._boundary}

    def restore(self, state):
        self._buffer, self._last_pane, self._boundary = (
            state["buffer"], state["last"], state["boundary"]
        )


@extension("window", "batch")
class BatchWindow(WindowProcessor):
    """Chunk-per-arrival window (reference: BatchWindowProcessor): each
    arriving chunk expires the previous chunk."""

    PARAMETERS = ()
    OVERLOADS = ((),)

    is_batch = True

    def __init__(self, args, attribute_names):
        super().__init__(args, attribute_names)
        self._last: Optional[EventBatch] = None

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        cur = batch.only(ev.CURRENT)
        if len(cur) == 0:
            return cur
        outs: List[EventBatch] = []
        if self._last is not None and len(self._last):
            exp = self._last.with_types(ev.EXPIRED)
            exp.timestamps = np.full(len(exp), now, dtype=np.int64)
            outs.append(exp)
        outs.append(reset_marker(cur, now))
        outs.append(cur)
        self._last = cur
        return EventBatch.concat(outs)

    def buffered(self) -> Optional[EventBatch]:
        return self._last

    def snapshot(self):
        return {"last": self._last}

    def restore(self, state):
        self._last = state["last"]


@extension("window", "session")
class SessionWindow(WindowProcessor):
    """Session window with gap timeout (reference:
    SessionWindowProcessor(gap, [key])): events buffer per session key;
    a session closes when no event arrives for ``gap`` ms, expiring its
    events."""

    PARAMETERS = (Param('window.session', _INTS),
                  Param('window.key'))
    OVERLOADS = (('window.session',),
                 ('window.session', 'window.key'))

    needs_scheduler = True
    is_batch = True

    def __init__(self, args, attribute_names):
        super().__init__(args, attribute_names)
        self.gap_ms = self._const_int(args[0], "session gap")
        self.key_expr = args[1] if len(args) > 1 else None
        self._sessions: Dict = {}  # key -> (EventBatch, last_ts)

    def _keys(self, batch: EventBatch) -> List:

        if self.key_expr is None:
            return [None] * len(batch)
        col = np.broadcast_to(
            np.asarray(self.key_expr.fn(build_env(batch))), (len(batch),)
        )
        return [v.item() if isinstance(v, np.generic) else v for v in col]

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        cur = batch.only(ev.CURRENT)
        outs: List[EventBatch] = []
        exp = self._close_due(now)
        if exp is not None:
            outs.append(exp)
        keys = self._keys(cur)
        for i in range(len(cur)):
            row = cur.take(np.asarray([i]))
            k = keys[i]
            buf, _ = self._sessions.get(k, (None, 0))
            buf = row if buf is None else EventBatch.concat([buf, row])
            self._sessions[k] = (buf, int(row.timestamps[0]))
            outs.append(row)
        return EventBatch.concat(outs) if outs else _empty_like(cur)

    def _close_due(self, now: int) -> Optional[EventBatch]:
        closed: List[EventBatch] = []
        for k, (buf, last_ts) in list(self._sessions.items()):
            if last_ts + self.gap_ms <= now:
                exp = buf.with_types(ev.EXPIRED)
                exp.timestamps = np.full(len(exp), now, dtype=np.int64)
                closed.append(exp)
                del self._sessions[k]
        return EventBatch.concat(closed) if closed else None

    def on_time(self, now: int) -> Optional[EventBatch]:
        return self._close_due(now)

    def next_wakeup(self) -> Optional[int]:
        if not self._sessions:
            return None
        return min(last + self.gap_ms for _, last in self._sessions.values())

    def snapshot(self):
        return {"sessions": self._sessions}

    def restore(self, state):
        self._sessions = state["sessions"]


@extension("window", "cron")
class CronWindow(WindowProcessor):
    """Cron-scheduled tumbling batch window (reference:
    CronWindowProcessor.java:187-225 dispatchEvents): events are held
    until the cron expression fires; at each fire the previous batch is
    expired (timestamped at fire time) and the held batch is emitted as
    CURRENT, becoming the next expired set."""

    PARAMETERS = (Param('cron.expression', (AttrType.STRING,)),)
    OVERLOADS = (('cron.expression',),)

    needs_scheduler = True
    is_batch = True

    def __init__(self, args, attribute_names):
        super().__init__(args, attribute_names)

        expr = args[0].fn({})
        if not isinstance(expr, str):
            raise SiddhiAppCreationError("cron window expects a cron-expression string")
        self._cron = CronSchedule(expr)
        self._pending: Optional[EventBatch] = None
        self._last_flushed: Optional[EventBatch] = None
        self._next_fire: Optional[int] = None

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        cur = batch.only(ev.CURRENT)
        if self._pending is None:
            self._pending = _empty_like(cur)
        if self._next_fire is None:
            self._next_fire = self._cron.next_fire(now)
        if len(cur):
            self._pending = EventBatch.concat([self._pending, cur])
        return _empty_like(cur)

    def on_time(self, now: int) -> Optional[EventBatch]:
        if self._next_fire is None or now < self._next_fire:
            return None
        fire = self._next_fire
        self._next_fire = self._cron.next_fire(now)
        if len(self._pending or ()) == 0 and len(self._last_flushed or ()) == 0:
            return None
        outs: List[EventBatch] = []
        if self._last_flushed is not None and len(self._last_flushed):
            exp = self._last_flushed.with_types(ev.EXPIRED)
            exp.timestamps = np.full(len(exp), fire, dtype=np.int64)
            outs.append(exp)
            outs.append(reset_marker(self._last_flushed, fire))
        flush = self._pending
        if len(flush):
            outs.append(flush)
        self._last_flushed = flush
        self._pending = _empty_like(flush)
        return EventBatch.concat(outs) if outs else None

    def next_wakeup(self) -> Optional[int]:
        return self._next_fire

    def buffered(self) -> Optional[EventBatch]:
        return self._pending

    def snapshot(self):
        return {"pending": self._pending, "last": self._last_flushed, "next": self._next_fire}

    def restore(self, state):
        self._pending, self._last_flushed, self._next_fire = (
            state["pending"], state["last"], state["next"]
        )


class _WindowExprEval:
    """Evaluator for expression/expressionBatch window retention
    expressions (reference: ExpressionWindowProcessor.java:68-103).

    The expression string is parsed with the SiddhiQL expression grammar
    and evaluated against the current buffer: bare attributes and
    ``last.attr`` read the newest event, ``first.attr`` the oldest;
    ``count()``, ``sum/min/max/avg(attr)`` aggregate over the buffer;
    ``eventTimestamp(first|last)`` reads buffer timestamps."""

    _AGGS = {"sum": np.sum, "min": np.min, "max": np.max, "avg": np.mean}

    def __init__(self, expr_string: str, attribute_names: List[str]):
        self.attribute_names = set(attribute_names)
        toks = tokenize(expr_string)
        self.ast = Parser(toks).parse_expression()
        self._validate(self.ast)

    def _validate(self, e):
        """Reject unknown attributes at app-creation time, not on the
        first event."""
        if isinstance(e, X.Variable):
            # first/last refs and bare names must be stream attributes;
            # bare 'first'/'last' only appear as eventTimestamp() args,
            # which are handled before recursion below
            if e.stream_id in (None, "first", "last") and e.attribute not in self.attribute_names:
                raise SiddhiAppCreationError(
                    f"expression window: unknown attribute '{e.attribute}'")
            return
        if isinstance(e, X.FunctionCall):
            if e.name == "eventTimestamp":
                return  # args are first/last selectors, not attributes
            for a in e.args:
                self._validate(a)
            return
        for attr in ("left", "right", "expr"):
            child = getattr(e, attr, None)
            if isinstance(child, X.Expression):
                self._validate(child)

    def __call__(self, buf: EventBatch, start: int = 0) -> bool:
        """Evaluate over ``buf[start:]`` without materializing a copy —
        numpy slices below are views, so eviction scans stay O(n)."""
        if len(buf) - start <= 0:
            return True
        return bool(self._ev(self.ast, buf, start))

    def _col(self, buf: EventBatch, attr: str, pos: int, start: int):
        if attr not in buf.columns:
            raise SiddhiAppCreationError(f"expression window: unknown attribute '{attr}'")
        return buf.columns[attr][start if pos == 0 else -1]

    def _ev(self, e, buf: EventBatch, start: int):
        if isinstance(e, X.Constant):
            return e.value
        if isinstance(e, X.TimeConstant):
            return e.value
        if isinstance(e, X.Variable):
            if e.stream_id in ("first", "last"):
                return self._col(buf, e.attribute, 0 if e.stream_id == "first" else -1, start)
            if e.stream_id is None:
                return self._col(buf, e.attribute, -1, start)
            raise SiddhiAppCreationError(
                f"expression window: unsupported reference '{e.stream_id}.{e.attribute}'")
        if isinstance(e, X.FunctionCall):
            name = e.name
            if name == "count":
                return len(buf) - start
            if name == "eventTimestamp":
                if e.args and isinstance(e.args[0], X.Variable):
                    which = e.args[0].attribute
                    return int(buf.timestamps[start if which == "first" else -1])
                return int(buf.timestamps[-1])
            if name in self._AGGS:
                arg = e.args[0]
                if not isinstance(arg, X.Variable) or arg.stream_id is not None:
                    raise SiddhiAppCreationError(
                        "expression window aggregates take a plain attribute")
                if arg.attribute not in buf.columns:
                    raise SiddhiAppCreationError(
                        f"expression window: unknown attribute '{arg.attribute}'")
                col = buf.columns[arg.attribute][start:]
                return self._AGGS[name](col) if len(col) else 0
            raise SiddhiAppCreationError(
                f"expression window: unsupported function '{name}()'")
        if isinstance(e, X.ArithmeticOp):
            a, b = self._ev(e.left, buf, start), self._ev(e.right, buf, start)
            if e.op == "+":
                return a + b
            if e.op == "-":
                return a - b
            if e.op == "*":
                return a * b
            if e.op == "/":
                return a / b
            return a % b
        if isinstance(e, X.CompareOp):
            a, b = self._ev(e.left, buf, start), self._ev(e.right, buf, start)
            op = e.op
            if op == "==":
                return a == b
            if op == "!=":
                return a != b
            if op == "<":
                return a < b
            if op == "<=":
                return a <= b
            if op == ">":
                return a > b
            return a >= b
        if isinstance(e, X.AndOp):
            return bool(self._ev(e.left, buf, start)) and bool(self._ev(e.right, buf, start))
        if isinstance(e, X.OrOp):
            return bool(self._ev(e.left, buf, start)) or bool(self._ev(e.right, buf, start))
        if isinstance(e, X.NotOp):
            return not bool(self._ev(e.expr, buf, start))
        if isinstance(e, X.IsNull):
            return self._ev(e.expr, buf, start) is None
        raise SiddhiAppCreationError(
            f"expression window: unsupported expression node {type(e).__name__}")


@extension("window", "expression")
class ExpressionWindow(WindowProcessor):
    """Sliding window retained by an expression (reference:
    ExpressionWindowProcessor.java:68-103): each arrival is appended,
    then events are expired from the oldest until the expression holds
    over the remaining buffer.

    Inherently sequential host-side operator (retention depends on each
    prior decision): O(buffer) per arrival; eviction scans use offset
    views, not copies."""

    PARAMETERS = (Param('expression', (AttrType.STRING,)),)
    OVERLOADS = (('expression',),)

    def __init__(self, args, attribute_names):
        super().__init__(args, attribute_names)
        expr = args[0].fn({})
        if not isinstance(expr, str):
            raise SiddhiAppCreationError("expression window expects a string expression")
        self._eval = _WindowExprEval(expr, attribute_names)
        self._buf: Optional[EventBatch] = None

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        cur = batch.only(ev.CURRENT)
        if self._buf is None:
            self._buf = _empty_like(cur)
        outs: List[EventBatch] = []
        for i in range(len(cur)):
            row = cur.take(np.asarray([i]))
            self._buf = EventBatch.concat([self._buf, row])
            n_evict = 0
            while len(self._buf) - n_evict > 0 and not self._eval(self._buf, n_evict):
                n_evict += 1
            if n_evict:
                evict = self._buf.take(np.arange(n_evict)).with_types(ev.EXPIRED)
                evict.timestamps = np.full(len(evict), now, dtype=np.int64)
                outs.append(evict)
                self._buf = self._buf.take(np.arange(n_evict, len(self._buf)))
            outs.append(row)
        return EventBatch.concat(outs) if outs else _empty_like(cur)

    def buffered(self) -> Optional[EventBatch]:
        return self._buf

    def snapshot(self):
        return {"buf": self._buf}

    def restore(self, state):
        self._buf = state["buf"]


@extension("window", "expressionBatch")
class ExpressionBatchWindow(WindowProcessor):
    """Tumbling window flushed when the expression fails (reference:
    ExpressionBatchWindowProcessor.java:68-147): events accumulate while
    the expression (evaluated including the arriving event) holds; on
    failure the batch is flushed — previous flush expired, RESET, new
    CURRENT batch.  ``include.triggering.event`` puts the triggering
    event into the flushed batch; ``stream.current.event`` streams
    arrivals through immediately and only expires in batches."""

    PARAMETERS = (Param('expression', (AttrType.STRING,)),
                  Param('include.triggering.event', (AttrType.BOOL,)),
                  Param('stream.current.event', (AttrType.BOOL,)))
    OVERLOADS = (('expression',),
                 ('expression', 'include.triggering.event'),
                 ('expression', 'include.triggering.event', 'stream.current.event'))

    is_batch = True

    def __init__(self, args, attribute_names):
        super().__init__(args, attribute_names)
        expr = args[0].fn({})
        if not isinstance(expr, str):
            raise SiddhiAppCreationError("expressionBatch window expects a string expression")
        self._eval = _WindowExprEval(expr, attribute_names)
        self.include_triggering = bool(args[1].fn({})) if len(args) > 1 else False
        self.stream_current = bool(args[2].fn({})) if len(args) > 2 else False
        self._buf: Optional[EventBatch] = None
        self._last_flushed: Optional[EventBatch] = None

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        cur = batch.only(ev.CURRENT)
        if self._buf is None:
            self._buf = _empty_like(cur)
        outs: List[EventBatch] = []
        for i in range(len(cur)):
            row = cur.take(np.asarray([i]))
            if self.stream_current:
                outs.append(row)
            with_row = EventBatch.concat([self._buf, row])
            if self._eval(with_row):
                self._buf = with_row
                continue
            # expression failed including the arriving event -> flush
            if self.include_triggering:
                flush, rest = with_row, _empty_like(cur)
            else:
                flush, rest = self._buf, row
            outs.extend(self._flush(flush, now))
            self._buf = rest
        return EventBatch.concat(outs) if outs else _empty_like(cur)

    def _flush(self, flush: EventBatch, now: int) -> List[EventBatch]:
        outs: List[EventBatch] = []
        if self._last_flushed is not None and len(self._last_flushed):
            exp = self._last_flushed.with_types(ev.EXPIRED)
            exp.timestamps = np.full(len(exp), now, dtype=np.int64)
            outs.append(exp)
        if len(flush) or (self._last_flushed is not None and len(self._last_flushed)):
            outs.append(reset_marker(flush, now))
        if len(flush) and not self.stream_current:
            outs.append(flush)
        self._last_flushed = flush
        return outs

    def buffered(self) -> Optional[EventBatch]:
        return self._buf

    def snapshot(self):
        return {"buf": self._buf, "last": self._last_flushed}

    def restore(self, state):
        self._buf, self._last_flushed = state["buf"], state["last"]
