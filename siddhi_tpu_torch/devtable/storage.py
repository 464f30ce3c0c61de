"""Device-resident tables: columnar device storage and scatter upserts.

Port of the JAX package's ``devtable/storage.py``: ``table/table.py``'s
``InMemoryTable`` with the row storage moved onto the device, one
``[C]``-capacity column an attribute plus a validity lane, while the
slot map (primary key -> slot), timestamps and a liveness mirror stay on
the host, so probes and eligibility decisions never synchronize.  A
mutation batch is one scatter step: every write row lands on its slot,
and duplicate slots within the batch resolve last-writer-wins on the
device — the reference takes an argmax over an ``[N, C]`` one-hot plane;
the port takes, per slot, the ``amax`` of the writing rows' order
(``scatter_reduce``) and gathers that row, the same winner without the
plane.

Consistency is revision pinning, as in the reference, whose argument
rests on immutable arrays: every scatter here writes NEW column tensors
(``torch.where`` over the old ones), never in place, so a probe in
flight reads the revision it was dispatched against and ``drain()`` —
the app's barrier (``SiddhiAppRuntime.drain``) — advances the revision
and pins the current column references, which ``persist()``/``restore``
and on-demand reads see: the persist capture clones the pinned
revision's gathers under the barrier while the batch loop goes on
writing fresh tensors.

Capacity is fixed by ``@app:devtables(capacity='N')``.  Deletes
tombstone (validity cleared, key unmapped) without recycling the slot
mid-cycle; a counted compaction at the barrier, or on demand when an
insert would overflow, moves tombstones to the free list.  If the table
is still full after compacting, it demotes itself to a host
``InMemoryTable`` mid-run with a WARNING and a counted demotion, never
a crash.  The reference's fault sites and span tracer come with
``ROADMAP.md`` §1 items 15b and 15c.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from siddhi_tpu_torch.core.emit_queue import fetch_coalesced
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.core.ingest_stage import IngestStats, staged_put
from siddhi_tpu_torch.observability.trace import STAGE_TABLE_UPSERT
from siddhi_tpu_torch.query_api import AttrType
from siddhi_tpu_torch.query_api.annotation import find_annotation
from siddhi_tpu_torch.table.table import TBL, InMemoryTable, _scalar

log = logging.getLogger("siddhi_tpu_torch")

# attribute types that ride device lanes BIT-EXACTLY: the host table
# stores these very numpy dtypes, so host/devtable differentials are
# equality, not tolerance (LONG/DOUBLE would narrow on device lanes and
# STRING/OBJECT cannot ride at all — all gate to the host path)
_LANE_DTYPES = {
    AttrType.INT: np.dtype(np.int32),
    AttrType.FLOAT: np.dtype(np.float32),
    AttrType.BOOL: np.dtype(np.bool_),
}


def _pow2(n: int, floor: int = 8) -> int:
    return max(1 << (max(n, 1) - 1).bit_length(), floor)


def scatter_step(cols: Dict[str, torch.Tensor], valid: torch.Tensor,
                 vals: Dict[str, torch.Tensor], write_slots: torch.Tensor,
                 kill_slots: torch.Tensor):
    """The last-writer-wins scatter, out of place: write row ``j`` lands
    at ``write_slots[j]`` (-1 inert); where several rows write one slot
    the LAST row wins (the ``amax`` of their order); ``kill_slots`` clear
    validity and win over same-step writes (a displaced row is dead even
    if the step also wrote it, as the host table's sequential
    delete-then-update bookkeeping has it).  Returns new ``(cols,
    valid)``; the inputs are not written."""
    cap = valid.shape[0]
    dev = valid.device
    n = write_slots.shape[0]
    live = write_slots >= 0
    order = torch.arange(n, dtype=torch.int64, device=dev)
    winner = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, write_slots.clamp_min(0).long(),
                           torch.where(live, order, -1), "amax")
    touched = winner >= 0
    src = winner.clamp_min(0)
    out = {}
    for nm, col in cols.items():
        v = vals.get(nm)
        out[nm] = col if v is None else torch.where(touched, v[src], col)
    killed = torch.zeros(cap, dtype=torch.bool, device=dev)
    k = kill_slots[kill_slots >= 0].long()
    killed[k] = True
    return out, (valid | touched) & ~killed


class _NotDeviceable(Exception):
    """A value this batch cannot ride a typed device lane (null / object
    dtype) — the caller demotes gracefully instead of crashing."""


class DeviceTable:
    """Columnar table resident in device HBM, duck-type compatible with
    ``InMemoryTable`` so every host read path — compiled conditions,
    on-demand queries, generic callbacks, ``IN table`` membership —
    works unchanged (reads fetch through the sanctioned
    ``fetch_coalesced``; the pk probe never leaves the host)."""

    def __init__(self, definition, capacity: int = 1024, device=None,
                 faults=None, tracer=None):
        self.definition = definition
        # the app's fault injector (the scatter's ingest.put site) and
        # tracer (a 'table.upsert' span a scatter)
        self._faults = faults
        self._tracer = tracer
        self.table_id = definition.id
        self._lock = threading.RLock()
        if capacity < 1:
            raise SiddhiAppCreationError(
                f"devtable '{self.table_id}': capacity must be >= 1")
        self._cap = int(capacity)

        # -- eligibility: raise SiddhiAppCreationError -> host fallback --
        pk_ann = find_annotation(definition.annotations, "PrimaryKey")
        pks = ([v for _, v in pk_ann.elements] or None) if pk_ann is not None else None
        if not pks or len(pks) != 1:
            raise SiddhiAppCreationError(
                f"devtable '{self.table_id}': needs exactly one primary "
                "key attribute (slot-index map is a single-key hash)")
        pk = pks[0]
        if pk not in definition.attribute_names:
            raise SiddhiAppCreationError(
                f"table '{definition.id}': primary key '{pk}' is not an attribute")
        for a in definition.attributes:
            if a.type not in _LANE_DTYPES:
                raise SiddhiAppCreationError(
                    f"devtable '{self.table_id}': attribute '{a.name}' is "
                    f"{a.type.name} — device lanes carry INT/FLOAT/BOOL "
                    "bit-exactly; other types keep the host table")
        if any(a.name.lower() == "index" for a in definition.annotations):
            raise SiddhiAppCreationError(
                f"devtable '{self.table_id}': @Index needs host-side "
                "per-value slot sets; indexed tables keep the host path")
        if next(a for a in definition.attributes if a.name == pk).type != AttrType.INT:
            raise SiddhiAppCreationError(
                f"devtable '{self.table_id}': primary key '{pk}' must be "
                "INT (int32 device key lane)")

        self.primary_keys: List[str] = [pk]
        self.pk = pk
        self.indexes: Dict[str, Dict] = {}
        self._dtypes = {a.name: _LANE_DTYPES[a.type] for a in definition.attributes}

        # -- host-side metadata (no device sync to read any of it) --------
        self._pk_map: Dict[int, int] = {}
        self._slot_key: Dict[int, int] = {}
        self._hlive = np.zeros(self._cap, dtype=bool)
        self._ts = np.zeros(self._cap, dtype=np.int64)
        self._hwm = 0
        self._free: List[int] = []
        self._tombstones: List[int] = []

        # -- device-resident state ----------------------------------------
        self.device = torch.device(device)
        self.ingest_stats = IngestStats()
        init = {nm: np.zeros(self._cap, dtype=dt) for nm, dt in self._dtypes.items()}
        init["__valid"] = np.zeros(self._cap, dtype=bool)
        placed = staged_put(init, self.device, self.ingest_stats)
        self._dvalid = placed.pop("__valid")
        self._dcols = placed
        # the probe's sorted key index of the current (cols, valid)
        # tensors: rebuilt after a scatter replaced them
        self._key_index = None

        # -- MVCC pinning / stats ------------------------------------------
        self.revision = 0
        self._dirty = False
        self._pinned: Optional[Dict] = None
        self.scatter_steps = 0
        self.compactions = 0
        self.demotions = 0
        self._host = None  # set on graceful demotion
        self._pin()

    # -- basics ---------------------------------------------------------

    @property
    def demoted(self) -> bool:
        return self._host is not None

    def __len__(self) -> int:
        if self._host is not None:
            return len(self._host)
        return int(self._hlive.sum())

    @property
    def size(self) -> int:
        return len(self)

    def live_slots(self) -> np.ndarray:
        if self._host is not None:
            return self._host.live_slots()
        return np.flatnonzero(self._hlive)

    # -- demotion / capacity --------------------------------------------

    def _demote(self, reason: str):
        """Rebuild the rows in a host InMemoryTable and route every
        future call there — graceful mid-run demotion, never a crash."""
        log.warning(
            "devtable '%s': demoting to the host table path mid-run "
            "(%s); reads/mutations continue host-side", self.table_id, reason)
        host = InMemoryTable(self.definition, capacity=max(self._cap, 64))
        slots = np.flatnonzero(self._hlive)
        names = self.definition.attribute_names
        idx = torch.from_numpy(slots).to(self.device)
        cols = fetch_coalesced([self._dcols[nm][idx] for nm in names])
        with host._lock:
            for i in range(len(slots)):
                row = {nm: cols[k][i] for k, nm in enumerate(names)}
                host._insert_row(row, int(self._ts[slots[i]]))
        self._host = host
        # the slot-index map is the shared currency of compiled pk
        # probes — rebind so in-flight CompiledTableCondition objects
        # follow the demotion without replanning
        self._pk_map = host._pk_map
        self.demotions += 1

    def _compact(self):
        """Counted reclamation of tombstoned slots (their validity lane
        is already False on device) — runs at the barrier and on demand
        when an insert would overflow."""
        if not self._tombstones:
            return
        self._free.extend(self._tombstones)
        self._tombstones = []
        self.compactions += 1

    def _ensure_capacity(self, n_new: int) -> bool:
        avail = len(self._free) + (self._cap - self._hwm)
        if n_new <= avail:
            return True
        self._compact()
        avail = len(self._free) + (self._cap - self._hwm)
        if n_new <= avail:
            return True
        self._demote(
            f"capacity {self._cap} exhausted even after compaction "
            f"({n_new} new keys, {avail} free slots)")
        return False

    def _alloc(self) -> int:
        if self._free:
            return self._free.pop()
        s = self._hwm
        self._hwm += 1
        return s

    # -- lane conversion -------------------------------------------------

    def _lane(self, arr, nm: str, n: int) -> np.ndarray:
        a = arr if isinstance(arr, np.ndarray) else np.empty(0)
        if not isinstance(arr, np.ndarray) or a.dtype.kind == "O":
            raise _NotDeviceable(
                f"attribute '{nm}' carries nulls/objects this batch")
        return a[:n].astype(self._dtypes[nm], copy=False)

    # -- the scatter step -------------------------------------------------

    def _apply_scatter(self, write_slots: List[int],
                       vals: Dict[str, np.ndarray],
                       kill_slots: List[int]):
        """ONE scatter step for this mutation batch, out of place; pads
        to power-of-two row counts, as the reference does."""
        t0 = time.perf_counter()
        n = len(write_slots)
        npad = _pow2(n)
        w = np.full(npad, -1, dtype=np.int32)
        if n:
            w[:n] = np.fromiter(write_slots, dtype=np.int32, count=n)
        kpad = _pow2(len(kill_slots))
        k = np.full(kpad, -1, dtype=np.int32)
        if kill_slots:
            k[:len(kill_slots)] = np.fromiter(
                kill_slots, dtype=np.int32, count=len(kill_slots))
        pv = {}
        for nm, v in vals.items():
            col = np.zeros(npad, dtype=self._dtypes[nm])
            col[:n] = v
            pv[nm] = col
        w_d, k_d, v_d = staged_put((w, k, pv), self.device,
                                   self.ingest_stats, self._faults)
        self._dcols, self._dvalid = scatter_step(
            self._dcols, self._dvalid, v_d, w_d, k_d)
        self._key_index = None
        self.scatter_steps += 1
        self._dirty = True
        if self._tracer is not None:
            self._tracer.record_span(STAGE_TABLE_UPSERT, "devtable", t0,
                                     time.perf_counter(), n_events=n)

    def device_state(self):
        """``(cols, valid, key_index)``: the CURRENT device tensors, which
        no later scatter writes (each makes new ones), so a probe
        dispatched against them reads one revision; ``key_index`` is
        ``(sorted keys, their slots)``, the valid slots' primary keys in
        ascending order (an invalid slot sorts last, under a key no
        int32 takes), built once per revision of the tensors."""
        with self._lock:
            if self._key_index is None:
                pk = torch.where(self._dvalid, self._dcols[self.pk].long(),
                                 torch.full_like(self._dvalid, 1 << 40,
                                                 dtype=torch.int64))
                self._key_index = torch.sort(pk, stable=True)
            return self._dcols, self._dvalid, self._key_index

    # -- batched lowered mutations ----------------------------------------

    def insert(self, batch: EventBatch):
        """Add rows; duplicate keys replace (LWW) — within the batch the
        duplicates share one slot and the kernel argmax picks the last."""
        with self._lock:
            if self._host is not None:
                self._host.insert(batch)
                return
            names = self.definition.attribute_names
            n = len(batch)
            try:
                cols = {nm: self._lane(batch.columns[nm], nm, n) for nm in names}
            except _NotDeviceable as e:
                self._demote(str(e))
                self._host.insert(batch)
                return
            keys = cols[self.pk]
            n_new = 0
            seen = set()
            for kk in keys.tolist():
                if kk not in self._pk_map and kk not in seen:
                    seen.add(kk)
                    n_new += 1
            if not self._ensure_capacity(n_new):
                self._host.insert(batch)
                return
            write_slots: List[int] = []
            for j in range(n):
                kk = int(keys[j])
                s = self._pk_map.get(kk)
                if s is None:
                    s = self._alloc()
                    self._pk_map[kk] = s
                    self._slot_key[s] = kk
                self._hlive[s] = True
                self._ts[s] = int(batch.timestamps[j])
                write_slots.append(s)
            self._apply_scatter(write_slots, cols, [])

    def _insert_row(self, row: Dict, ts: int) -> int:
        """Single-row generic entry (update-or-insert miss branch of the
        host callback).  A None value cannot ride a typed lane — demote
        gracefully and let the host table hold it."""
        with self._lock:
            if self._host is None and any(row.get(nm) is None
                                          for nm in self.definition.attribute_names):
                self._demote("null value in inserted row (partial projection)")
            if self._host is not None:
                with self._host._lock:
                    return self._host._insert_row(row, ts)
            names = self.definition.attribute_names
            cols = {}
            try:
                for nm in names:
                    a = np.zeros(1, dtype=self._dtypes[nm])
                    a[0] = _scalar(row[nm])
                    cols[nm] = a
            except (TypeError, ValueError):
                self._demote(f"non-device value in inserted row: {row!r}")
                with self._host._lock:
                    return self._host._insert_row(row, ts)
            kk = int(cols[self.pk][0])
            s = self._pk_map.get(kk)
            if s is None:
                if not self._ensure_capacity(1):
                    with self._host._lock:
                        return self._host._insert_row(row, ts)
                s = self._alloc()
                self._pk_map[kk] = s
                self._slot_key[s] = kk
            self._hlive[s] = True
            self._ts[s] = int(ts)
            self._apply_scatter([s], cols, [])
            return s

    def delete_keys(self, keys: np.ndarray):
        """Lowered delete: unmap + tombstone, one kill scatter."""
        with self._lock:
            if self._host is not None:
                slots = [self._pk_map[int(kk)] for kk in keys.tolist()
                         if int(kk) in self._pk_map]
                self._host.delete_slots(slots)
                return
            kills: List[int] = []
            for kk in keys.tolist():
                s = self._pk_map.pop(int(kk), None)
                if s is None or not self._hlive[s]:
                    continue
                self._slot_key.pop(s, None)
                self._hlive[s] = False
                self._tombstones.append(s)
                kills.append(s)
            if kills:
                self._apply_scatter([], {}, kills)

    def delete_slots(self, slots):
        """Generic entry (host DeleteTableCallback probing via compiled
        conditions)."""
        with self._lock:
            if self._host is not None:
                self._host.delete_slots(slots)
                return
            kills: List[int] = []
            for s in slots:
                s = int(s)
                if not self._hlive[s]:
                    continue
                kk = self._slot_key.pop(s, None)
                if kk is not None and self._pk_map.get(kk) == s:
                    del self._pk_map[kk]
                self._hlive[s] = False
                self._tombstones.append(s)
                kills.append(s)
            if kills:
                self._apply_scatter([], {}, kills)

    def update_keys(self, keys: np.ndarray, values: Dict[str, np.ndarray]):
        """Lowered update (no primary-key rewrite — gated at plan time):
        rows whose key misses are dropped, matching the host probe."""
        with self._lock:
            if self._host is not None:
                slots, idx = self._key_slots(keys)
                if slots:
                    self._host.update_slots(
                        slots, {nm: v[idx] for nm, v in values.items()})
                return
            slots, idx = self._key_slots(keys)
            if not slots:
                return
            try:
                vals = {nm: self._lane(v[idx], nm, len(slots))
                        for nm, v in values.items()}
            except _NotDeviceable as e:
                self._demote(str(e))
                self._host.update_slots(
                    slots, {nm: v[idx] for nm, v in values.items()})
                return
            self._apply_scatter(slots, vals, [])

    def _key_slots(self, keys: np.ndarray):
        slots: List[int] = []
        idx: List[int] = []
        for j, kk in enumerate(keys.tolist()):
            s = self._pk_map.get(int(kk))
            if s is not None and (self._host is not None or self._hlive[s]):
                slots.append(s)
                idx.append(j)
        return slots, np.fromiter(idx, dtype=np.int64, count=len(idx))

    def update_slots(self, slots, values: Dict):
        """Generic entry; handles primary-key rewrites with the host
        table's sequential last-writer-wins bookkeeping (a displaced
        row dies even when this very step also wrote it)."""
        with self._lock:
            if self._host is not None:
                self._host.update_slots(slots, values)
                return
            live = [(j, int(s)) for j, s in enumerate(slots) if self._hlive[int(s)]]
            if not live:
                return
            idx = np.fromiter((j for j, _ in live), dtype=np.int64, count=len(live))
            wslots = [s for _, s in live]
            try:
                vals = {nm: self._lane(np.ascontiguousarray(v)[idx], nm, len(live))
                        for nm, v in values.items()}
            except _NotDeviceable as e:
                self._demote(str(e))
                self._host.update_slots(slots, values)
                return
            kills: List[int] = []
            if self.pk in vals:
                new_keys = vals[self.pk]
                for r, (_, s) in enumerate(live):
                    old = self._slot_key.get(s)
                    nk = int(new_keys[r])
                    if old == nk:
                        continue
                    if old is not None and self._pk_map.get(old) == s:
                        del self._pk_map[old]
                    other = self._pk_map.get(nk)
                    if other is not None and other != s:
                        # key collision: the displaced row dies (LWW)
                        self._slot_key.pop(other, None)
                        self._hlive[other] = False
                        self._tombstones.append(other)
                        kills.append(other)
                    self._pk_map[nk] = s
                    self._slot_key[s] = nk
            self._apply_scatter(wslots, vals, kills)

    def upsert(self, keys: np.ndarray, insert_cols: Dict[str, np.ndarray],
               set_cols: Dict[str, np.ndarray], ts: np.ndarray) -> bool:
        """Lowered update-or-insert: rows classify sequentially against a
        speculative key view (a key inserted by an earlier row turns later
        duplicates into updates, matching the host's sequential probe),
        then apply as two scatters — inserts (full rows) before updates
        (set attrs).  The probe key and the inserted row's own primary
        key may differ (``on T.k == S.a`` with a projected ``k``); the
        slot map follows the INSERTED key, like the host ``_insert_row``.

        Returns False — with NOTHING mutated — when the batch needs an
        insert of a slot AFTER an update of the same slot (the two-phase
        scatter order would invert host sequential semantics); the
        caller delegates that batch to the generic host-path callback."""
        with self._lock:
            if self._host is not None:
                self._host_upsert(keys, insert_cols, set_cols, ts)
                return True
            try:
                ins = {nm: self._lane(v, nm, len(keys))
                       for nm, v in insert_cols.items()}
                upd = {nm: self._lane(v, nm, len(keys))
                       for nm, v in set_cols.items()}
            except _NotDeviceable as e:
                self._demote(str(e))
                self._host_upsert(keys, insert_cols, set_cols, ts)
                return True
            ikeys = ins[self.pk]

            # pass A: pure simulation — new-slot count + ordering check
            sim: Dict[int, object] = {}

            def tok_of(kk: int):
                t = sim.get(kk)
                if t is not None:
                    return t
                return self._pk_map.get(kk)

            n_new = 0
            ins_last: Dict[object, int] = {}
            upd_first: Dict[object, int] = {}
            for j, kk in enumerate(keys.tolist()):
                t = tok_of(int(kk))
                if t is not None:
                    upd_first.setdefault(t, j)
                else:
                    ik = int(ikeys[j])
                    t2 = tok_of(ik)
                    if t2 is None:
                        t2 = ("new", ik)
                        n_new += 1
                    sim[ik] = t2
                    ins_last[t2] = j
            for t, jl in ins_last.items():
                if t in upd_first and jl > upd_first[t]:
                    return False  # insert after update of the same slot

            if not self._ensure_capacity(n_new):
                self._host_upsert(keys, insert_cols, set_cols, ts)
                return True

            # pass B: apply
            ins_slots: List[int] = []
            ins_idx: List[int] = []
            upd_slots: List[int] = []
            upd_idx: List[int] = []
            for j, kk in enumerate(keys.tolist()):
                s = self._pk_map.get(int(kk))
                if s is not None:
                    upd_slots.append(s)
                    upd_idx.append(j)
                    continue
                ik = int(ikeys[j])
                s = self._pk_map.get(ik)  # in-place replace on collision
                if s is None:
                    s = self._alloc()
                self._pk_map[ik] = s
                self._slot_key[s] = ik
                self._hlive[s] = True
                self._ts[s] = int(ts[j])
                ins_slots.append(s)
                ins_idx.append(j)
            if ins_slots:
                ii = np.fromiter(ins_idx, dtype=np.int64, count=len(ins_idx))
                self._apply_scatter(
                    ins_slots, {nm: v[ii] for nm, v in ins.items()}, [])
            if upd_slots:
                ui = np.fromiter(upd_idx, dtype=np.int64, count=len(upd_idx))
                self._apply_scatter(
                    upd_slots, {nm: v[ui] for nm, v in upd.items()}, [])
            return True

    def _host_upsert(self, keys, insert_cols, set_cols, ts):
        """Demoted path: sequential per-row emulation of the host
        update-or-insert callback."""
        host = self._host
        for j, kk in enumerate(keys.tolist()):
            s = self._pk_map.get(int(kk))
            if s is not None and host._live[s]:
                host.update_slots([s], {nm: v[j:j + 1]
                                        for nm, v in set_cols.items()})
            else:
                row = {nm: insert_cols[nm][j]
                       for nm in self.definition.attribute_names}
                with host._lock:
                    host._insert_row(row, int(ts[j]))

    # -- reads (one coalesced fetch; the pk probe stays on the host) ------

    def rows_batch(self, slots: Optional[np.ndarray] = None) -> EventBatch:
        with self._lock:
            if self._host is not None:
                return self._host.rows_batch(slots)
            if slots is None:
                slots = self.live_slots()
            names = self.definition.attribute_names
            idx = torch.from_numpy(np.asarray(slots, dtype=np.int64)).to(
                self.device)
            cols_dev = [self._dcols[nm][idx] for nm in names]
            ts = self._ts[slots]
        cols = fetch_coalesced(cols_dev)
        return EventBatch(self.table_id, names,
                          {nm: cols[i] for i, nm in enumerate(names)}, ts)

    def column_env(self, slots: np.ndarray) -> Dict[str, np.ndarray]:
        with self._lock:
            if self._host is not None:
                return self._host.column_env(slots)
            names = self.definition.attribute_names
            idx = torch.from_numpy(np.asarray(slots, dtype=np.int64)).to(
                self.device)
            cols_dev = [self._dcols[nm][idx] for nm in names]
        cols = fetch_coalesced(cols_dev)
        return {TBL + nm: cols[i] for i, nm in enumerate(names)}

    def contains_fn(self, attr_hint: Optional[str] = None):
        def member(values) -> np.ndarray:
            with self._lock:
                if self._host is not None:
                    return self._host.contains_fn(attr_hint)(values)
                keys = self._pk_map
            vals = np.atleast_1d(np.ascontiguousarray(values))
            return np.frompyfunc(lambda v: _scalar(v) in keys, 1, 1)(
                vals).astype(bool)

        return member

    # -- barrier / MVCC pinning -------------------------------------------

    def _pin(self):
        self._pinned = {
            "cols": dict(self._dcols),
            "slots": np.flatnonzero(self._hlive),
            "ts": self._ts.copy(),
            "revision": self.revision,
        }

    def drain(self):
        """Batch-cycle barrier (``SiddhiAppRuntime.drain``):
        compact tombstones, advance the revision if mutations landed,
        and pin the current immutable column references — the snapshot
        every consistent reader (persist / on-demand / debugger) sees."""
        with self._lock:
            if self._host is not None:
                return
            self._compact()
            if self._dirty:
                self.revision += 1
                self._dirty = False
                self._pin()

    def state_bytes(self) -> int:
        """Bytes of the table's device columns and validity lane."""
        return sum(t.numel() * t.element_size()
                   for t in (*self._dcols.values(), self._dvalid))

    def devtable_metrics(self) -> Dict[str, object]:
        return {
            "devtableLiveRows": len(self),
            "devtableCapacity": self._cap,
            "devtableRevision": self.revision,
            "devtableScatterSteps": self.scatter_steps,
            "devtableCompactions": self.compactions,
            "devtableDemotions": self.demotions,
            "devtableDemoted": self._host is not None,
        }

    # -- snapshot contract (host-format compatible) -----------------------

    def snapshot(self, fetch: bool = True) -> Dict:
        """State of the PINNED revision: gathers from the pinned column
        tensors, which no scatter writes, fetched to numpy (``fetch=
        False``: left on the device for the persist path's capture,
        which clones them under the barrier and fetches them on the
        writer thread), so an async checkpoint sees revision R while the
        batch loop writes R+1."""
        with self._lock:
            if self._host is not None:
                return self._host.snapshot()
            p = self._pinned
            slots = torch.from_numpy(p["slots"]).to(self.device)
            names = self.definition.attribute_names
            cols = [p["cols"][nm][slots] for nm in names]
            ts = p["ts"][p["slots"]].copy()
            revision = p["revision"]
        if fetch:
            cols = fetch_coalesced(cols)
        return {"cols": dict(zip(names, cols)), "ts": ts,
                "revision": revision}

    def restore(self, state: Dict):
        with self._lock:
            if self._host is not None:
                self._host.restore(state)
                return
            names = self.definition.attribute_names
            ts = np.ascontiguousarray(state["ts"]).astype(np.int64)
            n = len(ts)
            if n > self._cap:
                self._demote(f"restored state has {n} rows > capacity {self._cap}")
                self._host.restore(state)
                return
            cols = [np.asarray(state["cols"][nm]) for nm in names]
            self._pk_map = {}
            self._slot_key = {}
            self._free = []
            self._tombstones = []
            self._hwm = n
            self._hlive[:] = False
            self._hlive[:n] = True
            self._ts[:] = 0
            self._ts[:n] = ts
            init = {}
            for i, nm in enumerate(names):
                col = np.zeros(self._cap, dtype=self._dtypes[nm])
                col[:n] = np.ascontiguousarray(cols[i]).astype(
                    self._dtypes[nm], copy=False)
                init[nm] = col
            init["__valid"] = self._hlive.copy()
            placed = staged_put(init, self.device, self.ingest_stats)
            self._dvalid = placed.pop("__valid")
            self._dcols = placed
            self._key_index = None
            kcol = init[self.pk]
            for s in range(n):
                kk = int(kcol[s])
                self._pk_map[kk] = s
                self._slot_key[s] = kk
            self.revision = int(state.get("revision", 0))
            self._dirty = False
            self._pin()
