"""Shared tumbling-window device engine for N compatible tenants.

Port of the JAX package's ``multiplex/tumbling_group.py``.  One
:class:`~siddhi_tpu_torch.ops.device_query.DeviceQueryEngine`, compiled
from the FIRST tenant's query (the fingerprint guarantees every member
would have compiled the same engine), serves up to ``slots`` tenants.
The packed state stacks the tenant axis onto the group axis: every
``[G, ...]`` accumulator tensor becomes ``[T*G, ...]``, tenant ``t``
owning rows ``[t*G, (t+1)*G)``.  The engine's accumulate step
(``acc_step``) takes the group axis from the state it is given, so the
same step runs over the packed bank with each tenant's group ids offset
by ``t*G``; its state scatters launch ``accumulate_`` on a card, once a
lane kind for every tenant's rows at once.

Host-side pane bookkeeping (group interning tables, pane anchor and
fill, last emitted keys) is PER TENANT: each seat owns a full copy, and
``_borrow`` swaps it onto the engine's attributes under the group lock,
so the engine's own host machinery (``_intern_groups``, ``_pane_sweep``,
``_flush_cols``, ``_concat_chunks``, ``pane_wakeup``,
``host_snapshot``/``host_restore``) runs unchanged against the calling
tenant's view.  Only ``base_ts``, the int32 relative-time anchor, is
shared group-wide; pane anchors are relative to it and every emitted
timestamp is absolute, so sharing it is invisible in a tenant's output.

The hot path: each tenant stages at most one sub-batch; once every
occupied seat has staged (or a barrier or a re-stage forces it) the
group concatenates the sub-batches tenant-major, offsets the group ids,
adds a tenant-id lane and runs ONE accumulate step over one
``staged_put``.  The tenants' passing counts come back as one ``[T]``
vector (an ``index_add_`` of the filter mask by tenant id; pad rows fall
into the dump bucket ``slots``).  A sub-batch that would close a pane
takes the engine's ``_pane_sweep`` against the packed rows instead, so
flush order inside the batch matches the dedicated engine bit for bit.

The bank's rows are written in place by tenants of other apps, under
their own app locks: every read or write of a seat's rows holds the
group lock, and ``snapshot_tenant`` returns a clone of them.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch

from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.emit_queue import EmitStats, fetch_coalesced
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import (
    SiddhiAppRuntimeError,
    TransferFaultError,
)
from siddhi_tpu_torch.core.ingest_stage import IngestStats, staged_put
from siddhi_tpu_torch.ops.device_query import _pow2
from siddhi_tpu_torch.util import faults as _faults

log = logging.getLogger(__name__)


class _TenantSeat:
    """Per-tenant host state: interning tables, pane bookkeeping, the
    staged sub-batch, pending outputs and the last clean rows (the
    poison guard's restore point)."""

    __slots__ = (
        "slot", "adapter", "gids", "gvals", "gfree", "glast",
        "pane_end", "pane_fill", "prev_pane_fill", "last_group_keys",
        "staged", "pending_out", "last_good",
    )

    def __init__(self, slot: int):
        self.slot = slot
        self.adapter = None
        self.gids: Dict = {}
        self.gvals: List = []
        self.gfree: List[int] = []
        self.glast: Dict[int, int] = {}
        self.pane_end: Optional[int] = None
        self.pane_fill = 0
        self.prev_pane_fill = 0
        self.last_group_keys: Optional[List] = None
        self.staged = None  # (cols, ts, now) or None
        self.pending_out = deque()  # (out_cols, out_ts, keys, now)
        self.last_good = None  # {key: host rows [G, ...]}


class TumblingMultiplexGroup:
    """Packed ``[T*G]`` tumbling accumulator bank shared by up to
    ``slots`` structurally identical queries."""

    fingerprint = ""

    def __init__(self, engine, slots: int):
        self.engine = engine
        self.slots = int(slots)
        self.G = int(engine.n_groups)
        self.lock = threading.RLock()
        self.seats: List[Optional[_TenantSeat]] = [None] * self.slots
        self._free = list(range(self.slots - 1, -1, -1))
        # group-wide ingest stats: staged_put counts every combined put
        self.ingest_stats = IngestStats()
        engine.ingest_stats = self.ingest_stats
        engine.faults = None  # fault injection is per tenant, not group
        self._init_host = engine.init_state_host()  # [G, ...] reference
        self._init_dev = staged_put(self._init_host, engine.device,
                                    self.ingest_stats)
        self.state = staged_put(
            {k: np.tile(v, (self.slots,) + (1,) * (v.ndim - 1))
             for k, v in self._init_host.items()},
            engine.device, self.ingest_stats)
        self.base_ts: Optional[int] = None
        # dispatch counters (the card phase and the differential tests)
        self.dispatches = 0       # dispatch cycles
        self.combined_steps = 0   # one step for every pane-interior seat
        self.slow_steps = 0       # per-tenant pane-sweep dispatches
        self.flush_skips = 0      # empty-pane flushes skipped

    def state_bytes(self) -> int:
        """Bytes of the packed bank on its device."""
        return sum(t.numel() * t.element_size() for t in self.state.values())

    # -- seat lifecycle ----------------------------------------------------

    def try_alloc_seat(self) -> Optional[int]:
        with self.lock:
            if not self._free:
                return None
            slot = self._free.pop()
            self.seats[slot] = _TenantSeat(slot)
            return slot

    def bind(self, slot: int, adapter) -> None:
        with self.lock:
            self.seats[slot].adapter = adapter

    def _write_rows(self, slot: int, rows: Dict) -> None:
        """Rows ``[slot*G, (slot+1)*G)`` of every state tensor := ``rows``
        (tensors on the device), in place.  Caller holds the lock."""
        off = slot * self.G
        for k, t in self.state.items():
            dst = t[off:off + self.G]
            if rows[k].data_ptr() != dst.data_ptr():  # not the slice itself
                dst.copy_(rows[k])

    def free_seat(self, slot: int) -> None:
        with self.lock:
            seat = self.seats[slot]
            if seat is None:
                return
            self.seats[slot] = None
            self._free.append(slot)
            # reset the freed rows so a future occupant starts clean
            self._write_rows(slot, self._init_dev)

    def occupied_count(self) -> int:
        with self.lock:
            return sum(1 for s in self.seats if s is not None)

    # -- host-bookkeeping borrow -------------------------------------------

    @contextmanager
    def _borrow(self, seat: _TenantSeat):
        """Swap ``seat``'s host bookkeeping onto the engine so the
        engine's own pane/intern/flush machinery runs against this
        tenant's view.  Caller holds the group lock."""
        eng = self.engine
        eng._group_ids = seat.gids
        eng._group_vals = seat.gvals
        eng._group_free = seat.gfree
        eng._group_last = seat.glast
        eng._pane_end = seat.pane_end
        eng._pane_fill = seat.pane_fill
        eng._prev_pane_fill = seat.prev_pane_fill
        eng.last_group_keys = seat.last_group_keys
        eng.base_ts = self.base_ts
        try:
            yield eng
        finally:
            # capture rebinds too (host_restore replaces the dicts)
            seat.gids = eng._group_ids
            seat.gvals = eng._group_vals
            seat.gfree = eng._group_free
            seat.glast = eng._group_last
            seat.pane_end = eng._pane_end
            seat.pane_fill = eng._pane_fill
            seat.prev_pane_fill = eng._prev_pane_fill
            seat.last_group_keys = eng.last_group_keys

    # -- combined accumulate -------------------------------------------------

    def _put(self, cols, rel, grp, gkv, n: int, tid=None):
        """One combined or per-tenant segment padded to a power of two
        (at least 16) and put on the device in one ``staged_put``.  Pad
        rows sit on the first row's (packed) group and carry its key, so
        every row of a group writes the same key register, as the
        engine's own padding does; ``tid`` pads with the dump bucket."""
        eng = self.engine
        B = _pow2(n)
        valid = np.zeros(B, dtype=bool)
        valid[:n] = True
        c = {}
        for k, lane in eng.host_lane_cols(cols, n).items():
            col = np.zeros(B, dtype=lane.dtype)
            col[:n] = lane
            c[k] = col
        t = np.zeros(B, dtype=np.int32)
        t[:n] = rel[:n]
        g = np.full(B, grp[0], dtype=np.int32)
        g[:n] = grp[:n]
        kv = np.empty((B, gkv.shape[1]), dtype=np.float32)
        kv[:] = gkv[0]
        kv[:n] = gkv[:n]
        host = (c, t, g, kv, valid)
        if tid is not None:
            tpad = np.full(B, self.slots, dtype=np.int32)
            tpad[:n] = tid
            host = host + (tpad,)
        return staged_put(host, eng.device, self.ingest_stats)

    def _mux_acc(self, state, c, t, g, gkv, valid, tid):
        """The engine's accumulate step over the packed bank, in place,
        and every tenant's passing count: ``(state, counts [slots])``."""
        eng = self.engine
        state, _n = eng.acc_step(state, c, t, g, gkv, valid)
        fmask = eng._filter_mask(eng._base_env(c, t, t.shape[0]), valid)
        counts = torch.zeros(self.slots + 1, dtype=torch.int32,
                             device=t.device)
        counts.index_add_(0, tid.long(), fmask.to(torch.int32))
        return state, counts[:self.slots]

    # -- staging + dispatch -------------------------------------------------

    def stage(self, adapter, cols, ts: np.ndarray, now) -> None:
        """Stage one tenant sub-batch; dispatch when the cycle is full
        (every occupied seat staged) or this tenant re-stages."""
        with self.lock:
            seat = self.seats[adapter.slot]
            if seat.staged is not None:
                self._dispatch_locked()
            seat.staged = (cols, ts, now)
            st = adapter.ingest_stats
            st.staged_batches += 1
            st.max_staging_depth = max(st.max_staging_depth, 1)
            if all(s is None or s.staged is not None for s in self.seats):
                self._dispatch_locked()

    def dispatch_staged(self) -> None:
        """Barrier: dispatch whatever is staged (drain, fire, snapshot)."""
        with self.lock:
            self._dispatch_locked()

    def _dispatch_locked(self) -> None:
        staged = [s for s in self.seats
                  if s is not None and s.staged is not None]
        if not staged:
            return
        eng = self.engine
        batches = []
        for seat in staged:
            cols, ts, now = seat.staged
            seat.staged = None
            batches.append((seat, cols, ts, now))
        self._anchor_base(batches)
        self.dispatches += 1

        fast, slow = [], []
        for seat, cols, ts, now in batches:
            n = len(ts)
            rel = (ts - self.base_ts).astype(np.int32)
            with self._borrow(seat):
                grp = eng._intern_groups(cols, ts, n)
            entry = self._classify(seat, cols, rel, grp, n)
            (fast if entry[0] else slow).append(
                (seat, cols, ts, rel, grp, n, now, entry))

        if fast:
            self._dispatch_fast(fast)
        for item in slow:
            self._dispatch_slow(item)
        for seat, *_rest in fast + slow:
            if seat.adapter is not None:
                seat.adapter.ingest_stats.device_puts += 1
            self._poison_guard(seat)

    def _anchor_base(self, batches) -> None:
        """Establish or shift the shared relative-time anchor.

        Pane anchors are relative to ``base_ts`` and every emitted
        timestamp is absolute, so shifting the base (down for a late
        tenant with older events, up at the int32 horizon as the
        dedicated ``_re_anchor`` does) moves every seat's ``pane_end``
        by the opposite delta and changes nothing a tenant observes."""
        eng = self.engine
        ts_min = min(int(ts.min()) for _s, _c, ts, _n in batches)
        ts_max = max(int(ts.max()) for _s, _c, ts, _n in batches)
        if self.base_ts is None:
            self.base_ts = ts_min - 1
            return
        delta = 0
        if ts_min - self.base_ts <= 0:
            delta = (ts_min - self.base_ts) - 1  # negative: shift down
        elif ts_max - self.base_ts >= eng._REL_LIMIT:
            horizon = (int(eng.window_param)
                       if eng.window_name == "timeBatch" else 0)
            delta = (ts_min - self.base_ts) - 1 - horizon
            if delta <= 0 or (ts_max - self.base_ts) - delta >= 2**31:
                raise SiddhiAppRuntimeError(
                    "device query: timestamp span of one batch plus the "
                    "window horizon exceeds the int32 relative-time range")
        if delta:
            self.base_ts += delta
            for s in self.seats:
                if s is not None and s.pane_end is not None:
                    s.pane_end -= delta

    def _classify(self, seat: _TenantSeat, cols, rel, grp, n):
        """Fast-path eligibility: the sub-batch must not close a pane.

        Returns ``(fast, npass_host)``.  The timeBatch pane anchor is
        committed here as ``_pane_sweep`` would (the first passing batch
        pins ``pane_end = rel[0] + T``)."""
        eng = self.engine
        if eng.window_name == "timeBatch":
            if seat.pane_end is None:
                seat.pane_end = int(rel[0]) + int(eng.window_param)
                seat.pane_fill = 0
                seat.prev_pane_fill = 0
            return (int(rel.max()) < seat.pane_end, None)
        # lengthBatch: a pane closes when its passing events reach L
        with self._borrow(seat):
            fmask = eng._host_filter_mask(cols, rel, n)
        npass = int(np.count_nonzero(fmask))
        remaining = int(eng.window_param) - seat.pane_fill
        return (npass < remaining, npass)

    def _dispatch_fast(self, fast) -> None:
        """ONE accumulate for every pane-interior sub-batch: tenant-major
        concat, group ids offset by slot*G, a tenant-id lane for the
        per-seat passing counts."""
        eng = self.engine
        cat_cols = {
            k: np.concatenate([np.asarray(cols[k])[:n]
                               for _s, cols, _t, _r, _g, n, _now, _e in fast])
            for k in fast[0][1]
        }
        cat_rel = np.concatenate(
            [rel[:n] for _s, _c, _t, rel, _g, n, _now, _e in fast])
        cat_grp = np.concatenate([
            (grp[:n] + seat.slot * self.G).astype(np.int32)
            for seat, _c, _t, _r, grp, n, _now, _e in fast])
        gkv_parts, tid_parts = [], []
        for seat, _cols, _ts, _rel, grp, n, _now, _entry in fast:
            with self._borrow(seat):
                gkv_parts.append(eng._gk_vals(grp[:n]))
            tid_parts.append(np.full(n, seat.slot, dtype=np.int32))
        ntot = len(cat_rel)
        c, t, g, gkv, valid, tid = self._put(
            cat_cols, cat_rel, cat_grp, np.concatenate(gkv_parts), ntot,
            tid=np.concatenate(tid_parts))
        self.state, counts = self._mux_acc(self.state, c, t, g, gkv, valid,
                                           tid)
        self.combined_steps += 1
        counts_h = fetch_coalesced([counts])[0]
        for seat, _cols, _ts, _rel, _grp, _n, _now, entry in fast:
            # timeBatch takes the device count as the dedicated engine
            # does; lengthBatch its host filter count
            npass = entry[1]
            seat.pane_fill += (int(counts_h[seat.slot]) if npass is None
                               else npass)

    def _dispatch_slow(self, item) -> None:
        """Pane-closing sub-batch: the engine's ``_pane_sweep`` against
        this tenant's packed rows."""
        seat, cols, ts, rel, grp, n, now, _entry = item
        eng = self.engine
        self.slow_steps += 1
        chunks = []

        def acc_segment(state, cols_, rel_, grp_, idx, count):
            return self._acc_rows(seat, state, cols_, rel_, grp_, idx, count)

        def flush_pane(st, when):
            st, fcols, nf, keys = self._flush_slice(st, seat)
            chunks.append((fcols, when, nf, keys))
            return st

        with self._borrow(seat):
            self.state = eng._pane_sweep(self.state, cols, rel, grp, n,
                                         flush_pane, acc_segment=acc_segment)
            out_cols, out_ts = eng._concat_chunks(chunks)
        if len(out_ts):
            seat.pending_out.append(
                (out_cols, out_ts, seat.last_group_keys, now))

    def _acc_rows(self, seat: _TenantSeat, state, cols, rel, grp, idx,
                  count: bool):
        """``_acc_segment`` against the packed bank: group ids offset by
        slot*G, group-key values from the tenant's LOCAL ids (the borrow
        is active, so ``_gk_vals`` reads the seat's tables)."""
        eng = self.engine
        n = len(idx)
        c, t, g, gkv, valid = self._put(
            {k: np.asarray(v)[idx] for k, v in cols.items()}, rel[idx],
            (grp[idx] + seat.slot * self.G).astype(np.int32),
            eng._gk_vals(grp[idx]), n)
        state, n_pass = eng.acc_step(state, c, t, g, gkv, valid)
        return state, (int(fetch_coalesced([n_pass])[0]) if count else None)

    # -- flush --------------------------------------------------------------

    def _flush_slice(self, state, seat: _TenantSeat):
        """Flush the tenant's ``[G]`` rows.  A timeBatch pane with no
        passing event left every accumulator at its reset value, so the
        flush is skipped: same state, no output.  (A lengthBatch pane
        only closes full, and its fill is counted after the flush.)"""
        eng = self.engine
        if eng.window_name == "timeBatch" and eng._pane_fill == 0:
            self.flush_skips += 1
            return (state, eng._empty_cols(), 0,
                    [] if eng.group_exprs else None)
        off = seat.slot * self.G
        sl = {k: v[off:off + self.G] for k, v in state.items()}
        # the flush fetches its outputs before returning, so the reset
        # rows may overwrite the slice in place afterwards
        sl, fcols, nf, keys = eng._flush_cols(sl)
        self._write_rows(seat.slot, sl)
        return state, fcols, nf, keys

    def flush_due_for(self, adapter, now: int) -> None:
        """Timer flush of one tenant: ``engine.flush_due`` over the
        tenant's rows (the caller dispatched what was staged)."""
        eng = self.engine
        with self.lock:
            seat = self.seats[adapter.slot]
            chunks = []
            with self._borrow(seat):
                while True:
                    w = eng.pane_wakeup()
                    if w is None or w > now:
                        break
                    self.state, fcols, nf, keys = self._flush_slice(
                        self.state, seat)
                    chunks.append((fcols, w, nf, keys))
                    eng._advance_pane()
                out_cols, out_ts = eng._concat_chunks(chunks)
            if len(out_ts):
                seat.pending_out.append(
                    (out_cols, out_ts, seat.last_group_keys, now))

    def pane_wakeup_for(self, adapter) -> Optional[int]:
        with self.lock:
            seat = self.seats[adapter.slot]
            if seat is None:
                return None
            with self._borrow(seat):
                return self.engine.pane_wakeup()

    # -- per-tenant fault isolation ----------------------------------------

    def _poison_guard(self, seat: _TenantSeat) -> None:
        """Quarantine a poisoned tenant's rows without touching the other
        seats (the packed-bank form of the dedicated runtime's guard).
        Caller holds the lock."""
        adapter = seat.adapter
        fi = adapter.faults if adapter is not None else None
        if fi is None or not fi.watches("state.poison"):
            return
        off = seat.slot * self.G
        rows = {k: v[off:off + self.G] for k, v in self.state.items()}
        if fi.poisoned("state.poison"):
            rows = _faults.poison_state(rows)
            self._write_rows(seat.slot, rows)
        if not _faults.state_has_poison(rows):
            seat.last_good = _faults.host_copy(rows)
            return
        fi.stats.poison_quarantines += 1
        log.warning(
            "multiplex: poisoned state in tenant slot %d quarantined; "
            "restoring last known good rows", seat.slot)
        good = seat.last_good if seat.last_good is not None \
            else self._init_host
        self._write_rows(seat.slot, staged_put(
            {k: np.array(v, copy=True) for k, v in good.items()},
            self.engine.device, self.ingest_stats))

    # -- snapshot / restore -------------------------------------------------

    def snapshot_tenant(self, adapter, fetch: bool = True) -> Dict:
        """Dedicated-shape snapshot of one tenant (device rows ``[G,
        ...]`` and host bookkeeping), interchangeable with a dedicated
        runtime's.  ``fetch=False``: the rows as device clones, taken
        under the group lock (never views: neighbouring tenants write
        the bank in place)."""
        with self.lock:
            self._dispatch_locked()
            seat = self.seats[adapter.slot]
            off = adapter.slot * self.G
            rows = {k: v[off:off + self.G].clone()
                    for k, v in self.state.items()}
            if fetch:
                keys = list(rows)
                rows = dict(zip(keys, fetch_coalesced(
                    [rows[k] for k in keys])))
            with self._borrow(seat):
                host = self.engine.host_snapshot()
            return {"device_state": rows, "host": host}

    def restore_tenant(self, adapter, snap: Dict) -> None:
        eng = self.engine
        with self.lock:
            self._dispatch_locked()
            seat = self.seats[adapter.slot]
            seat.pending_out.clear()
            seat.last_good = None
            dev = snap["device_state"]
            for k, ref in self._init_host.items():
                got = dev.get(k)
                if got is None or tuple(np.shape(got)) != ref.shape:
                    raise SiddhiAppRuntimeError(
                        f"restored device state key '{k}' has shape "
                        f"{None if got is None else tuple(np.shape(got))}, "
                        f"engine expects {ref.shape}")
            self._write_rows(adapter.slot, staged_put(
                {k: np.array(dev[k], copy=True) for k in self._init_host},
                eng.device, self.ingest_stats))
            with self._borrow(seat):
                eng.host_restore(snap["host"])
                # the snapshot's pane anchor is relative to ITS base;
                # re-express it against the group's shared base
                b_snap = eng.base_ts
                if self.base_ts is None:
                    self.base_ts = b_snap
                elif b_snap is not None and eng._pane_end is not None:
                    eng._pane_end += b_snap - self.base_ts


class MultiplexTenantRuntime:
    """One tenant's runtime over a shared :class:`TumblingMultiplexGroup`.

    The surface of ``core/device_single.DeviceQueryRuntime``
    (``process_stream_batch``, ``drain``, ``fire``, ``next_wakeup``,
    ``snapshot``, ``restore``, ``close``, the emit and ingest stats), so
    the planner's wiring, the scheduler's barriers and crash recovery
    treat it the same."""

    def __init__(self, group: TumblingMultiplexGroup, slot: int,
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

    def process_stream_batch(self, batch: EventBatch, keys=None) -> None:
        cur = batch.only(ev.CURRENT)
        n = len(cur)
        if n == 0:
            return
        eng = self.engine
        cols = {a: np.asarray(cur.columns[a]) for a in eng.all_attrs
                if a in cur.columns}
        ts = np.asarray(cur.timestamps, dtype=np.int64)
        # per-tenant transient ingest faults retry or exhaust here, before
        # any group state is touched: a failing tenant never wedges the
        # shared engine
        _faults.retry_site(self.faults, "ingest.put", "multiplex")
        now = self.clock() if self.clock is not None else None
        self.group.stage(self, cols, ts, now)
        self.step_invocations += 1
        self._deliver_pending()

    # -- delivery -----------------------------------------------------------

    def _deliver_pending(self) -> None:
        """Emit this tenant's outputs OUTSIDE the group lock (the lock
        order is app -> group, never group -> app)."""
        while True:
            with self.group.lock:
                seat = self.group.seats[self.slot]
                if seat is None or not seat.pending_out:
                    return
                out_cols, out_ts, gkeys, now = seat.pending_out.popleft()
            try:
                _faults.retry_site(self.faults, "emit.drain", "multiplex")
            except TransferFaultError as e:
                self.faults.stats.drains_failed += 1
                self._on_fault(e)
                log.error("multiplex: emit drain failed for %s after "
                          "retries; dropping batch: %s",
                          self.out_stream_id, e)
                continue
            self._emit(out_cols, out_ts, gkeys, now)

    def _emit(self, out_cols, out_ts, keys, now) -> None:
        if len(out_ts) == 0:
            return
        eng = self.engine
        mb = EventBatch(
            self.out_stream_id, eng.output_names, out_cols, out_ts,
            np.full(len(out_ts), ev.CURRENT, dtype=np.int8))
        if keys is not None:
            if len(keys) != len(mb):
                raise SiddhiAppRuntimeError(
                    f"device query emitted {len(mb)} rows but "
                    f"{len(keys)} group keys")
            mb.aux["group_keys"] = list(keys)
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
            if seat is None:
                return None
            if seat.staged is not None or seat.pending_out:
                return 0
        return self.group.pane_wakeup_for(self)

    def fire(self, now: int) -> None:
        # dispatch the group only when THIS tenant's seat is staged; a
        # fire woken by pending output alone would flush OTHER tenants'
        # half-staged cycles (each app runs its own scheduler, so these
        # fires interleave mid-cycle) and defeat the packing
        with self.group.lock:
            seat = self.group.seats[self.slot]
            mine_staged = seat is not None and seat.staged is not None
        if mine_staged:
            self.group.dispatch_staged()
        self.group.flush_due_for(self, now)
        self._deliver_pending()

    def on_start(self, now: int) -> None:
        pass

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
