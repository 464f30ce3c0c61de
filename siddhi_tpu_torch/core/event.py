"""Event model: user-facing ``Event`` and the columnar ``EventBatch``.

Port of the JAX package's ``core/event.py``.  A chunk of events is a
columnar micro-batch: one numpy array per attribute plus timestamp and
event-type lanes.  Batches stay on the host; the runtimes stage the
numeric columns they need onto the device themselves.  The row side
channels ``aux["group_keys"]`` (the selector's group of each row) and
``aux["partition_keys"]`` (a dense match's partition key) stay aligned
through ``mask``, ``take`` and ``concat``.

Event types mirror ComplexEvent.Type: CURRENT, EXPIRED, TIMER, RESET.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from siddhi_tpu_torch.query_api.definition import AbstractDefinition

# event type lanes
CURRENT = 0
EXPIRED = 1
TIMER = 2
RESET = 3


class Event:
    """User-facing event: timestamp (ms) + data list."""

    __slots__ = ("timestamp", "data", "is_expired")

    def __init__(self, timestamp: int = -1, data: Optional[Sequence] = None,
                 is_expired: bool = False):
        self.timestamp = timestamp
        self.data = list(data) if data is not None else []
        self.is_expired = is_expired

    def __repr__(self):
        return (f"Event{{timestamp={self.timestamp}, data={self.data}, "
                f"isExpired={self.is_expired}}}")

    def __eq__(self, other):
        return (
            isinstance(other, Event)
            and self.timestamp == other.timestamp
            and self.data == other.data
            and self.is_expired == other.is_expired
        )


class EventBatch:
    """Columnar batch of events on one stream.

    columns: attribute name -> np.ndarray (len n)
    timestamps: int64[n] (ms)
    types: int8[n] of CURRENT/EXPIRED/TIMER/RESET
    """

    __slots__ = ("stream_id", "attribute_names", "columns", "timestamps",
                 "types", "aux")

    # per-row aux side channels that row selections must keep aligned
    _ROW_AUX = ("group_keys", "partition_keys")

    def __init__(
        self,
        stream_id: str,
        attribute_names: List[str],
        columns: Dict[str, np.ndarray],
        timestamps: np.ndarray,
        types: Optional[np.ndarray] = None,
    ):
        self.stream_id = stream_id
        self.attribute_names = attribute_names
        self.columns = columns
        self.timestamps = np.asarray(timestamps, dtype=np.int64)
        if types is None:
            types = np.zeros(len(self.timestamps), dtype=np.int8)
        self.types = np.asarray(types, dtype=np.int8)
        # side-channel metadata, row-aligned lists/arrays; row selections
        # carry only the _ROW_AUX entries
        self.aux: Dict[str, object] = {}

    def __len__(self) -> int:
        return len(self.timestamps)

    def _carry_row_aux(self, out: "EventBatch", sel) -> "EventBatch":
        for name in self._ROW_AUX:
            gk = self.aux.get(name)
            if gk is not None and len(gk) == len(self):
                if isinstance(sel, np.ndarray) and sel.dtype == bool:
                    out.aux[name] = [k for k, m in zip(gk, sel) if m]
                else:
                    out.aux[name] = [gk[int(i)] for i in sel]
        return out

    def mask(self, m: np.ndarray) -> "EventBatch":
        """Rows where the boolean mask is True."""
        out = EventBatch(
            self.stream_id, self.attribute_names,
            {k: v[m] for k, v in self.columns.items()},
            self.timestamps[m], self.types[m])
        return self._carry_row_aux(out, m)

    def take(self, idx: np.ndarray) -> "EventBatch":
        out = EventBatch(
            self.stream_id, self.attribute_names,
            {k: v[idx] for k, v in self.columns.items()},
            self.timestamps[idx], self.types[idx])
        return self._carry_row_aux(out, idx)

    def with_types(self, t: int) -> "EventBatch":
        """The same rows, every one of event type ``t``."""
        return EventBatch(
            self.stream_id, self.attribute_names, dict(self.columns),
            self.timestamps, np.full(len(self), t, dtype=np.int8))

    def copy(self) -> "EventBatch":
        """A deep copy of the columns and the row side channels."""
        out = EventBatch(
            self.stream_id, list(self.attribute_names),
            {k: v.copy() for k, v in self.columns.items()},
            self.timestamps.copy(), self.types.copy())
        for name in self._ROW_AUX:
            a = self.aux.get(name)
            if a is not None:
                out.aux[name] = list(a)
        return out

    def only(self, *event_types: int) -> "EventBatch":
        # one type: a plain compare (np.isin costs tens of microseconds
        # on the few-row batches of a per-key instance)
        m = (self.types == event_types[0] if len(event_types) == 1
             else np.isin(self.types, event_types))
        if m.all():
            return self
        return self.mask(m)

    @staticmethod
    def concat(batches: List["EventBatch"]) -> "EventBatch":
        if not batches:
            raise ValueError("EventBatch.concat needs at least one batch")
        if len(batches) == 1:
            return batches[0]
        b0 = batches[0]
        out = EventBatch(
            b0.stream_id, b0.attribute_names,
            {k: np.concatenate([b.columns[k] for b in batches])
             for k in b0.attribute_names},
            np.concatenate([b.timestamps for b in batches]),
            np.concatenate([b.types for b in batches]))
        for name in EventBatch._ROW_AUX:
            if all(b.aux.get(name) is not None and len(b.aux[name]) == len(b)
                   for b in batches):
                out.aux[name] = [k for b in batches for k in b.aux[name]]
        return out

    def __repr__(self):
        return f"EventBatch({self.stream_id}, n={len(self)})"


def batch_from_rows(
    definition: AbstractDefinition,
    rows: List[Sequence],
    timestamps: Sequence[int],
    types: Optional[Sequence[int]] = None,
    stream_id: Optional[str] = None,
) -> EventBatch:
    """Columnar batch from row-major data."""
    n = len(rows)
    n_attrs = len(definition.attributes)
    for r in rows:
        if len(r) != n_attrs:
            raise ValueError(
                f"event data {list(r)!r} has {len(r)} values but stream "
                f"'{definition.id}' expects {n_attrs} attributes")
    cols: Dict[str, np.ndarray] = {}
    for j, attr in enumerate(definition.attributes):
        dt = attr.type.np_dtype
        if dt == np.dtype(object):
            arr = np.empty(n, dtype=object)
            for i in range(n):
                arr[i] = rows[i][j]
        elif n:
            arr = np.asarray([rows[i][j] for i in range(n)], dtype=dt)
        else:
            arr = np.empty(0, dtype=dt)
        cols[attr.name] = arr
    return EventBatch(
        stream_id or definition.id, definition.attribute_names, cols,
        np.asarray(timestamps, dtype=np.int64),
        np.asarray(types, dtype=np.int8) if types is not None else None)


def batch_from_events(definition: AbstractDefinition, events: List[Event],
                      stream_id: Optional[str] = None) -> EventBatch:
    return batch_from_rows(
        definition, [e.data for e in events], [e.timestamp for e in events],
        [EXPIRED if e.is_expired else CURRENT for e in events], stream_id)


def events_from_batch(batch: EventBatch) -> List[Event]:
    """Row-major Events for user callbacks; columns unbox wholesale via
    ``ndarray.tolist()``."""
    n = len(batch)
    if n == 0:
        return []
    lists = [batch.columns[nm].tolist() for nm in batch.attribute_names]
    ts_list = batch.timestamps.tolist()
    expired = (batch.types == EXPIRED).tolist()
    out: List[Event] = []
    for i in range(n):
        e = Event.__new__(Event)
        e.timestamp = ts_list[i]
        e.data = [c[i] for c in lists]
        e.is_expired = expired[i]
        out.append(e)
    return out
