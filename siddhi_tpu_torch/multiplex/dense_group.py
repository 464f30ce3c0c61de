"""Shared dense-NFA device engine for N compatible pattern tenants.

Port of the JAX package's ``multiplex/dense_group.py``.  The dense
engine is already batched over a partition axis; the group makes that
axis the tenant axis: one
:class:`~siddhi_tpu_torch.ops.dense_nfa.DensePatternEngine` is built
with ``n_partitions = slots`` and tenant ``t`` owns partition row ``t``
(the scratch row at index ``slots`` stays the engine's).  The queries
that group are unpartitioned, so each dedicated engine would have run
its whole stream through one row anyway: the packed layout is the same
automaton once a tenant, and each row's arithmetic is the dedicated
row's, so the match sets are the same bit for bit.

The gain: T dedicated engines take T steps a batch cycle, and an
unpartitioned dedicated engine on the general step takes one collision
round an event (every event is on row 0).  The group concatenates the
staged sub-batches tenant-major (the tenants' rows are disjoint), so a
cycle is ONE ``process_deferred`` for every tenant on a stream: one
``batch_step`` launch (``csrc/dense_batch.cu``) for a capture-free
every-chain, or ``max(n_i)`` collision rounds of the general step
instead of ``sum(n_i)``.

Timestamps are anchored to ONE group ``base_ts`` (the first dispatch's
minimum, less 1).  ``within`` compares differences inside one row, so
the shared anchor is invisible to a tenant; a late tenant whose events
predate the anchor shifts the whole bank down on the host
(``engine.shift_row_ts``, rare), and the int32 horizon rides the
engine's own ``maybe_re_anchor`` over the combined batch.

Matches come back through the count-gated emit queue: a cycle with no
match fetches nothing; otherwise the match rows are fetched once and
split back per tenant at the tenant-major batch offsets (the rows are
sorted by event index).  Each seat's matches reach its app through that
seat's adapter only.

The bank's rows are written in place by tenants of other apps, under
their own app locks: every read or write of a seat's rows holds the
group lock, and ``snapshot_tenant`` returns a clone of them.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.emit_queue import (
    EmitQueue,
    EmitStats,
    fetch_coalesced,
)
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import (
    SiddhiAppRuntimeError,
    TransferFaultError,
)
from siddhi_tpu_torch.core.ingest_stage import IngestStats, staged_put
from siddhi_tpu_torch.util import faults as _faults

log = logging.getLogger(__name__)


class _DenseSeat:
    __slots__ = ("slot", "adapter", "staged", "pending_out", "last_good")

    def __init__(self, slot: int):
        self.slot = slot
        self.adapter = None
        self.staged = None  # (stream_key, cols, ts, now)
        self.pending_out = deque()  # (out_cols, out_ts, now)
        self.last_good = None  # {key: host rows [1, ...]}


class DenseMultiplexGroup:
    """One dense engine, ``slots`` tenants on the partition axis."""

    fingerprint = ""

    def __init__(self, engine, slots: int):
        self.engine = engine
        self.slots = int(slots)
        self.lock = threading.RLock()
        self.seats: List[Optional[_DenseSeat]] = [None] * self.slots
        self._free = list(range(self.slots - 1, -1, -1))
        self.ingest_stats = IngestStats()
        self.emit_stats = EmitStats()
        engine.ingest_stats = self.ingest_stats
        self.emit_queue = EmitQueue(depth=1, stats=self.emit_stats)
        self._init_host = engine.init_state_host()
        self._init_dev = staged_put(self._init_host, engine.device,
                                    self.ingest_stats)
        self.state = engine.init_state()
        self.dispatches = 0
        self.combined_steps = 0
        # the longest tenant sub-batch of the latest dispatch (a batch
        # step's longest segment; the general step's round count)
        self.last_longest = 0
        self._ovf_warned = 0

    def state_bytes(self) -> int:
        """Bytes of the shared state rows on their device."""
        return sum(t.numel() * t.element_size() for t in self.state.values())

    # -- seat lifecycle ----------------------------------------------------

    def try_alloc_seat(self) -> Optional[int]:
        with self.lock:
            if not self._free:
                return None
            slot = self._free.pop()
            self.seats[slot] = _DenseSeat(slot)
            return slot

    def bind(self, slot: int, adapter) -> None:
        with self.lock:
            self.seats[slot].adapter = adapter

    def _write_row(self, t: int, rows: Dict) -> None:
        """State row ``t`` := ``rows`` (``[1, ...]`` tensors on the
        device), in place.  Caller holds the lock."""
        for k, v in self.state.items():
            v[t:t + 1].copy_(rows[k])

    def free_seat(self, slot: int) -> None:
        with self.lock:
            seat = self.seats[slot]
            if seat is None:
                return
            # as DensePatternRuntime.close(): short-lived tenants still
            # surface dropped-instance warnings
            self._check_overflow()
            self.seats[slot] = None
            self._free.append(slot)
            self._write_row(slot, {k: v[slot:slot + 1]
                                   for k, v in self._init_dev.items()})

    def occupied_count(self) -> int:
        with self.lock:
            return sum(1 for s in self.seats if s is not None)

    # -- staging + dispatch -------------------------------------------------

    def stage(self, adapter, stream_key: str, cols, ts: np.ndarray,
              now) -> None:
        with self.lock:
            seat = self.seats[adapter.slot]
            if seat.staged is not None:
                # a second sub-batch (same or other source stream) must
                # observe the first's transitions: dispatch in between
                self._dispatch_locked()
            seat.staged = (stream_key, cols, ts, now)
            st = adapter.ingest_stats
            st.staged_batches += 1
            st.max_staging_depth = max(st.max_staging_depth, 1)
            if all(s is None or s.staged is not None for s in self.seats):
                self._dispatch_locked()

    def dispatch_staged(self) -> None:
        with self.lock:
            self._dispatch_locked()

    def _dispatch_locked(self) -> None:
        staged = [s for s in self.seats
                  if s is not None and s.staged is not None]
        if not staged:
            return
        by_stream: Dict[str, list] = {}
        for seat in staged:
            stream_key, cols, ts, now = seat.staged
            seat.staged = None
            by_stream.setdefault(stream_key, []).append((seat, cols, ts, now))
        self._anchor_base(by_stream)
        self.dispatches += 1
        for stream_key, items in by_stream.items():
            self._dispatch_stream(stream_key, items)
        for seat in staged:
            if seat.adapter is not None:
                seat.adapter.ingest_stats.device_puts += 1
            self._poison_guard(seat)
        # matches must be on the host before tenants deliver: drain the
        # count-gated queue (a cycle with no match fetched nothing)
        self.emit_queue.drain()
        if self.dispatches % 256 == 0:
            self._check_overflow()

    def _anchor_base(self, by_stream) -> None:
        eng = self.engine
        ts_min = min(int(ts.min())
                     for items in by_stream.values()
                     for _s, _c, ts, _n in items)
        if eng.base_ts is None:
            eng.base_ts = ts_min - 1
        elif ts_min - eng.base_ts <= 0:
            # a late tenant with events older than the group anchor:
            # shift the shared base down so relative ts stay positive
            # (a host round trip; rare, skew at admission only)
            delta = (ts_min - eng.base_ts) - 1
            keys = list(self.state)
            host = dict(zip(keys, fetch_coalesced(
                [self.state[k] for k in keys])))
            host = eng.shift_row_ts(host, delta)
            dev = staged_put(host, eng.device, self.ingest_stats)
            for k in keys:
                self.state[k].copy_(dev[k])
            eng.base_ts += delta

    def _dispatch_stream(self, stream_key: str, items) -> None:
        """ONE engine dispatch for every tenant staged on this source
        stream: tenant-major concat with each tenant's events routed to
        its own partition row."""
        eng = self.engine
        cat_cols = {
            k: np.concatenate([np.asarray(cols[k])
                               for _s, cols, _t, _n in items])
            for k in items[0][1]
        }
        cat_ts = np.concatenate([ts for _s, _c, ts, _n in items])
        part = np.concatenate([
            np.full(len(ts), seat.slot, dtype=np.int32)
            for seat, _c, ts, _n in items
        ])
        offsets = np.cumsum([0] + [len(ts) for _s, _c, ts, _n in items])
        self.last_longest = max(len(ts) for _s, _c, ts, _n in items)
        self.state, pending = eng.process_deferred(
            self.state, stream_key, part, cat_cols, cat_ts)
        self.combined_steps += 1
        if pending is None or pending.resolve() == 0:
            self.emit_queue.skip()
            return
        seats = [seat for seat, _c, _t, _n in items]
        nows = [now for _s, _c, _t, now in items]
        self.emit_queue.push(pending.pending_emit(
            lambda ev_idx, out, o=offsets, s=seats, t=cat_ts, n=nows:
                self._demux(ev_idx, out, o, s, t, n)))

    def _demux(self, ev_idx, out, offsets, seats, cat_ts, nows):
        """Split the match rows (sorted by event index) back per tenant:
        the combined batch is tenant-major, so one ``searchsorted`` a
        seat."""
        if len(ev_idx) == 0:
            return
        bounds = np.searchsorted(ev_idx, offsets)
        for si, seat in enumerate(seats):
            lo, hi = bounds[si], bounds[si + 1]
            if lo == hi:
                continue
            seat.pending_out.append(
                (out.columns(slice(lo, hi)), cat_ts[ev_idx[lo:hi]],
                 nows[si]))

    # -- per-tenant fault isolation ----------------------------------------

    def _poison_guard(self, seat: _DenseSeat) -> None:
        adapter = seat.adapter
        fi = adapter.faults if adapter is not None else None
        if fi is None or not fi.watches("state.poison"):
            return
        t = seat.slot
        rows = {k: v[t:t + 1] for k, v in self.state.items()}
        if fi.poisoned("state.poison"):
            rows = _faults.poison_state(rows)
            self._write_row(t, rows)
        if not _faults.state_has_poison(rows):
            seat.last_good = _faults.host_copy(rows)
            return
        fi.stats.poison_quarantines += 1
        log.warning(
            "multiplex: poisoned state in dense tenant slot %d "
            "quarantined; restoring last known good rows", t)
        good = (seat.last_good if seat.last_good is not None
                else {k: v[t:t + 1] for k, v in self._init_host.items()})
        self._write_row(t, staged_put(
            {k: np.array(v, copy=True) for k, v in good.items()},
            self.engine.device, self.ingest_stats))

    def _check_overflow(self) -> None:
        total = int(fetch_coalesced([self.state["overflow"].sum()])[0])
        if total > self._ovf_warned:
            log.warning(
                "dense multiplex group: %d pending instance(s) dropped — "
                "instance lanes full; matches may be missing.  Raise "
                "@app:execution('tpu', instances='N') (current %d).",
                total, self.engine.I)
            self._ovf_warned = total

    # -- snapshot / restore -------------------------------------------------

    def snapshot_tenant(self, adapter, fetch: bool = True) -> Dict:
        """Row ``t`` of every state tensor, cloned under the group lock
        (never a view: neighbouring tenants write the bank in place),
        fetched to numpy unless ``fetch=False``."""
        with self.lock:
            self._dispatch_locked()
            t = adapter.slot
            rows = {k: v[t:t + 1].clone() for k, v in self.state.items()}
            if fetch:
                keys = list(rows)
                rows = dict(zip(keys, fetch_coalesced(
                    [rows[k] for k in keys])))
            return {"dense_state": rows, "base_ts": self.engine.base_ts}

    def restore_tenant(self, adapter, snap: Dict) -> None:
        eng = self.engine
        with self.lock:
            self._dispatch_locked()
            t = adapter.slot
            seat = self.seats[t]
            seat.pending_out.clear()
            seat.last_good = None
            rows = {k: np.asarray(v) for k, v in snap["dense_state"].items()}
            for k, ref in self._init_host.items():
                got = rows.get(k)
                want = (1,) + ref.shape[1:]
                if got is None or got.shape != want:
                    raise SiddhiAppRuntimeError(
                        f"cannot restore: tenant snapshot key '{k}' has "
                        f"shape {None if got is None else got.shape}, this "
                        f"group needs {want} (snapshot taken under a "
                        "different @app:execution/@app:multiplex setting)")
            b_snap = snap.get("base_ts")
            if eng.base_ts is None:
                eng.base_ts = b_snap
            elif b_snap is not None and b_snap != eng.base_ts:
                # the snapshot's relative anchors were taken against its
                # own base; re-express them against the group base
                rows = eng.shift_row_ts(rows, eng.base_ts - b_snap)
            self._write_row(t, staged_put(
                {k: np.array(rows[k], copy=True) for k in self._init_host},
                eng.device, self.ingest_stats))


class DenseMultiplexTenantRuntime:
    """One tenant's runtime over a shared :class:`DenseMultiplexGroup`.

    The ``DensePatternRuntime`` surface the planner, the scheduler's
    barriers, the app runtime and crash recovery read
    (``process_stream_batch``, ``drain``, ``fire``, ``stats``,
    ``snapshot``, ``restore``, ``close``, the emit and ingest stats)."""

    def __init__(self, group: DenseMultiplexGroup, slot: int,
                 out_stream_id: str, emit,
                 clock=None, faults=None, registry=None):
        self.group = group
        self.slot = slot
        self.engine = group.engine
        self.out_stream_id = out_stream_id
        self.emit_cb = emit
        self.clock = clock
        self.faults = faults
        self.registry = registry
        self.emit_stats = EmitStats()
        self.ingest_stats = IngestStats()
        self.step_invocations = 0
        self._closed = False
        group.bind(slot, self)

    # -- ingest -------------------------------------------------------------

    def process_stream_batch(self, stream_key: str, batch: EventBatch,
                             part=None, keys=None) -> None:
        cur = batch.only(ev.CURRENT)
        n = len(cur)
        if n == 0:
            return
        eng = self.engine
        cols = {}
        for a in eng.numeric_stream_attrs(stream_key):
            col = cur.columns.get(a)
            if col is not None:
                cols[a] = np.asarray(col)
        ts = np.asarray(cur.timestamps, dtype=np.int64)
        # per-tenant fault hooks: the dedicated engine checks step.dense
        # once a batch and retries transient ingest.put transfers
        if self.faults is not None:
            self.faults.check("step.dense")
        _faults.retry_site(self.faults, "ingest.put", "multiplex")
        now = self.clock() if self.clock is not None else None
        self.group.stage(self, stream_key, cols, ts, now)
        self.step_invocations += 1
        self._deliver_pending()

    # -- delivery -----------------------------------------------------------

    def _deliver_pending(self) -> None:
        """This seat's matches, to its own app only, outside the group
        lock (the lock order is app -> group)."""
        while True:
            with self.group.lock:
                seat = self.group.seats[self.slot]
                if seat is None or not seat.pending_out:
                    return
                out_cols, out_ts, now = seat.pending_out.popleft()
            try:
                _faults.retry_site(self.faults, "emit.drain", "multiplex")
            except TransferFaultError as e:
                self.faults.stats.drains_failed += 1
                self._on_fault(e)
                log.error("multiplex: emit drain failed for %s after "
                          "retries; dropping batch: %s",
                          self.out_stream_id, e)
                continue
            mb = EventBatch(
                self.out_stream_id, self.engine.output_names, out_cols,
                out_ts, np.full(len(out_ts), ev.CURRENT, dtype=np.int8))
            if now is not None:
                mb.aux["emit_now"] = now
            self.emit_stats.emit_transfers += 1
            self.emit_cb(mb)

    def _on_fault(self, e: BaseException) -> None:
        _faults.isolate(None, self.faults, e)

    # -- barriers / scheduler ----------------------------------------------

    def drain(self) -> None:
        self.group.dispatch_staged()
        self._deliver_pending()

    def next_wakeup(self) -> Optional[int]:
        with self.group.lock:
            seat = self.group.seats[self.slot]
            if seat is not None and (seat.staged is not None
                                     or seat.pending_out):
                return 0
        return None

    def fire(self, now: int) -> None:
        # the group dispatches only for this tenant's own staged cycle; a
        # fire woken by pending output just delivers
        with self.group.lock:
            seat = self.group.seats[self.slot]
            mine_staged = seat is not None and seat.staged is not None
        if mine_staged:
            self.group.dispatch_staged()
        self._deliver_pending()

    def on_time(self, now: int) -> None:
        pass

    def on_start(self, now: int) -> None:
        pass

    def stats(self) -> Dict:
        self.drain()
        with self.group.lock:
            st = self.group.state
            act, ovf = fetch_coalesced([st["active"][self.slot].sum(),
                                        st["overflow"][self.slot]])
        return {
            "engine": "dense-multiplex",
            "partitions_in_use": 1,
            "partition_capacity": 1,
            "instance_lanes": self.engine.I,
            "active_instances": int(act),
            "dropped_instances": int(ovf),
            "step_invocations": self.step_invocations,
        }

    # -- persistence --------------------------------------------------------

    def snapshot(self, fetch: bool = True) -> Dict:
        self.drain()
        return self.group.snapshot_tenant(self, fetch)

    def restore(self, state: Dict) -> None:
        self.drain()
        self.group.restore_tenant(self, state)

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.drain()
        finally:
            if self.registry is not None:
                self.registry.release(self.group, self.slot)
            else:
                self.group.free_seat(self.slot)
