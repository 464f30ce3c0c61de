"""Hybrid skew router: hot partition keys ride the fused scan.

Port of the JAX package's ``core/hotkey_router.py``.  The partition axis
cannot split ONE key's event stream: the dense engine advances a
partition's events through sequential collision rounds, so one hot key
sets the length of the whole batch cycle.  ``HotKeyRouterRuntime``
wraps a partitioned ``DensePatternRuntime`` and, per junction cycle:

1. feeds a host-side space-saving heavy-hitter sketch (O(k) state,
   deterministic) with the cycle's key histogram;
2. applies promote/demote hysteresis (``@app:hotkeys(k, promote,
   demote)``): keys whose decayed share crosses ``promote`` move onto a
   ``HotKeyScanEngine`` slot (``ops/hotkey_scan.py``), keys that cool
   below ``demote`` move back;
3. converts pending-match state exactly at each boundary, a dense row's
   instance lanes to and from the scan's per-lane (youngest start,
   count) pair, so routing never alters emissions;
4. splits the batch: cold keys take the unchanged dense path, hot keys
   are packed on the scan's ``[H, n_pad]`` slot axis and advance in one
   fused scan (``kernels/scan_chain.py``).

The hot path rides the dense runtime's own machinery: its ``staged_put``
counters, its ingest stage (the count gate) and its count-gated
``EmitQueue``, the only device-to-host path; state handoffs fetch
through a queued ``PendingEmit`` and a drain barrier.  Within one cycle
the cold sub-batch's rows emit before the hot sub-batch's, each in event
order.  The reference's NaN-poison quarantine waits for the port's fault
harness.

Snapshot/restore demotes every hot key first, so the persisted tree is a
plain dense snapshot plus sketch counters, the same tree the reference
writes: a reference snapshot restores here and the other way round.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np
import torch

from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.emit_queue import PendingEmit, fetch_coalesced
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.ingest_stage import staged_put

log = logging.getLogger("siddhi_tpu_torch")


class HotKeyStats:
    """Router decision counters (host ints)."""

    __slots__ = ("promotions", "demotions", "routed_events")

    def __init__(self):
        self.promotions = 0
        self.demotions = 0
        self.routed_events = 0


class SpaceSavingSketch:
    """Space-saving heavy hitters: at most ``cap`` counters; a new key
    arriving at capacity evicts the minimum counter and inherits its
    count (the classic overestimate bound).  ``decay`` ages counts each
    cycle so share tracks the recent mix.  Deterministic: same input
    sequence, same estimates."""

    __slots__ = ("cap", "decay", "counts", "total")

    def __init__(self, cap: int, decay: float = 0.9):
        self.cap = int(cap)
        self.decay = float(decay)
        self.counts: Dict = {}
        self.total = 0.0

    def update(self, keys: np.ndarray, counts: np.ndarray):
        """One cycle's key histogram (np.unique output)."""
        self.total = self.total * self.decay + float(counts.sum())
        for k in list(self.counts):
            v = self.counts[k] * self.decay
            if v < 0.5:
                del self.counts[k]
            else:
                self.counts[k] = v
        for k, c in zip(keys.tolist(), counts.tolist()):
            cur = self.counts.get(k)
            if cur is not None:
                self.counts[k] = cur + c
            elif len(self.counts) < self.cap:
                self.counts[k] = float(c)
            else:
                mk = min(self.counts, key=self.counts.get)
                mv = self.counts.pop(mk)
                self.counts[k] = mv + c

    def share(self, key) -> float:
        if self.total <= 0:
            return 0.0
        return self.counts.get(key, 0.0) / self.total

    def heavy(self, threshold: float) -> List:
        """Keys at or above ``threshold`` share, heaviest first
        (deterministic tie-break on the printable key)."""
        floor = threshold * self.total
        out = [(v, k) for k, v in self.counts.items() if v >= floor]
        out.sort(key=lambda vk: (-vk[0], repr(vk[1])))
        return [k for _v, k in out]


def _put_row(arr: torch.Tensor, row: int, value) -> None:
    """``arr[row] = value`` in place (``index_put_``); ``value`` is host
    data staged to ``arr``'s device."""
    idx = torch.tensor([row], dtype=torch.int64, device=arr.device)
    val = staged_put(np.asarray(value, dtype=_NP[arr.dtype])[None],
                     arr.device)
    arr.index_put_((idx,), val)


_NP = {torch.bool: np.bool_, torch.int32: np.int32,
       torch.float32: np.float32}


class HotKeyRouterRuntime:
    """Junction-facing wrapper of one partitioned DensePatternRuntime
    plus one HotKeyScanEngine.  Everything not routing-specific delegates
    to the dense runtime (``__getattr__``), so the partition receiver and
    the app runtime see one runtime."""

    def __init__(self, dense, scan_engine, *, promote: float,
                 demote: float, query_name: str = ""):
        self._dense = dense
        self._scan = scan_engine
        self._promote_at = float(promote)
        self._demote_at = float(demote)
        self.query_name = query_name
        self.hot_stats = HotKeyStats()
        self.sketch = SpaceSavingSketch(cap=max(16, 4 * scan_engine.n_slots))
        # key -> {"slot": int, "row": dense row}
        self._slots: Dict = {}
        self._free_slots: List[int] = list(range(scan_engine.n_slots))[::-1]
        self._state = scan_engine.init_state()
        self.lowered_to = "hotkey"

    def __getattr__(self, name):
        return getattr(self._dense, name)

    # -- metrics -------------------------------------------------------------

    def hot_metrics(self) -> Dict[str, float]:
        s = self.hot_stats
        return {
            "hotkeyPromotions": s.promotions,
            "hotkeyDemotions": s.demotions,
            "hotkeyRoutedEvents": s.routed_events,
            "hotkeyActiveKeys": len(self._slots),
        }

    # -- state handoff -------------------------------------------------------

    def _fetch_rows(self, arrays) -> List[np.ndarray]:
        """Barrier-fetch small device slices through the emit queue (FIFO
        with the pending emissions)."""
        got: Dict[str, List[np.ndarray]] = {}

        def grab(host):
            got["host"] = list(host)

        self._dense.emit_queue.push(PendingEmit(list(arrays), grab))
        self._dense.drain()
        return got["host"]

    def _promote(self, key, row: int) -> bool:
        if not self._free_slots:
            return False
        dense, scan = self._dense, self._scan
        st = dense.state
        # basic-index views of the dense row: the drain inside _fetch_rows
        # copies them to the host before any write below touches the row
        # (the port updates state in place where JAX made new arrays)
        host = self._fetch_rows([st["active"][row], st["first_ts"][row]])
        dense_base = dense.engine.base_ts or 0
        if scan.base_ts is None:
            scan.base_ts = dense_base
        v_row, c_row = scan.dense_row_to_slot(
            host[0], host[1], dense_base, scan.base_ts)
        slot = self._free_slots.pop()
        _put_row(self._state["v"], slot, v_row)
        _put_row(self._state["c"], slot, c_row)
        # clear the dense row to its init template (the pending chains
        # moved); the row stays interned to the key — demotion writes
        # back into it.  `overflow` is a durable drop counter, keep it.
        init = dense.engine.init_state_host()
        for k, arr in st.items():
            if k != "overflow":
                _put_row(arr, row, init[k][0])
        self._slots[key] = {"slot": slot, "row": row}
        self.hot_stats.promotions += 1
        log.info("hotkey router '%s': promoted key %r (share %.3f) to "
                 "scan slot %d", self.query_name, key,
                 self.sketch.share(key), slot)
        return True

    def _demote(self, key) -> bool:
        rec = self._slots.pop(key)
        slot, row = rec["slot"], rec["row"]
        dense, scan = self._dense, self._scan
        # views of the slot, fetched by the drain before the writes below
        host = self._fetch_rows([self._state["v"][slot],
                                 self._state["c"][slot]])
        active, first_ts, dropped = scan.slot_to_dense_row(
            host[0], host[1], scan.base_ts or 0,
            dense.engine.base_ts or 0, dense.engine.I)
        st = dense.state
        _put_row(st["active"], row, active)
        _put_row(st["first_ts"], row, first_ts)
        if dropped:
            st["overflow"][row] += dropped
        v0, c0 = scan.slot_init_rows()
        _put_row(self._state["v"], slot, v0)
        _put_row(self._state["c"], slot, c0)
        self._free_slots.append(slot)
        self.hot_stats.demotions += 1
        log.info("hotkey router '%s': demoted key %r (share %.3f) back "
                 "to dense row %d", self.query_name, key,
                 self.sketch.share(key), row)
        return True

    def demote_all(self):
        for key in list(self._slots):
            self._demote(key)

    # -- routing decisions ---------------------------------------------------

    def _route_cycle(self, keys: np.ndarray, part: np.ndarray):
        """Update the sketch with this cycle's histogram and apply the
        promote/demote hysteresis.  Promotion needs the key's dense row,
        so only keys present in this cycle promote."""
        try:
            uniq, counts = np.unique(keys, return_counts=True)
        except TypeError:  # mixed-type keys cannot histogram — stay dense
            return
        self.sketch.update(uniq, counts)
        for key in list(self._slots):
            if self.sketch.share(key) < self._demote_at:
                self._demote(key)
        if self._free_slots:
            hot_now = self.sketch.heavy(self._promote_at)
            if hot_now:
                in_cycle = {k: i for i, k in enumerate(uniq.tolist())}
                for key in hot_now:
                    if not self._free_slots:
                        break
                    if key in self._slots or key not in in_cycle:
                        continue
                    pos = np.flatnonzero(keys == key)
                    self._promote(key, int(part[pos[0]]))

    # -- event path ----------------------------------------------------------

    def process_stream_batch(self, stream_key: str, batch: EventBatch,
                             part: np.ndarray, keys):
        cur = batch.only(ev.CURRENT)
        n = len(cur)
        if n == 0:
            return
        self._route_cycle(keys, part)
        hot_mask = np.zeros(n, dtype=bool)
        slot_pos: Dict[int, np.ndarray] = {}
        for key, rec in self._slots.items():
            pos = np.flatnonzero(keys == key)
            if len(pos):
                hot_mask[pos] = True
                slot_pos[rec["slot"]] = pos
        if not slot_pos:
            self._dense.process_stream_batch(stream_key, cur, part, keys)
            return
        cold_mask = ~hot_mask
        if cold_mask.any():
            self._dense.process_stream_batch(
                stream_key, cur.mask(cold_mask), part[cold_mask],
                keys[cold_mask])
        # hot keys stay "in use" for the row activity clock even though
        # their dense rows see no events while promoted
        np.maximum.at(self._dense._row_last_used, part[hot_mask],
                      cur.timestamps[hot_mask])
        self._process_hot(slot_pos, cur)

    def _process_hot(self, slot_pos: Dict[int, np.ndarray],
                     cur: EventBatch):
        dense, scan = self._dense, self._scan
        cols = {a: c for a, c in cur.columns.items()
                if a in scan.base._lane_dtype}
        ts = cur.timestamps
        put, meta = scan.pack_cycle(slot_pos, cols, ts)
        put_dev = staged_put(put, scan.device, dense.ingest_stats)
        self._state, emit_dev, n_rows = scan.dispatch(self._state, put_dev)
        self.hot_stats.routed_events += int(
            sum(len(p) for p in slot_pos.values()))
        dense.step_invocations += 1
        out_cols = {attr: cur.columns[attr] for _nm, attr in self._out_pairs()}

        def _finish(nr=n_rows, emit=emit_dev, m=meta, oc=out_cols, t=ts):
            # the count gate: one scalar through the sanctioned fetch
            if int(fetch_coalesced([nr])[0]) == 0:
                dense.emit_queue.skip()
                return
            dense.emit_queue.push(PendingEmit(
                [emit], lambda host: self._emit_hot(host, m, oc, t)))

        dense.ingest_stage.submit(_finish)

    def _out_pairs(self):
        """(output name, final-node attribute) pairs — eligibility
        guarantees every dense out_spec source is ('cand', attr)."""
        return [(nm, src[1]) for nm, src in self._dense.engine.out_spec]

    def _emit_hot(self, host, meta, out_cols, ts):
        emit_h = host[0]  # [H, n_pad] f32 per-event row counts
        parts = []
        for slot, pos in meta["slot_pos"].items():
            cnt = np.rint(emit_h[slot, :len(pos)]).astype(np.int64)
            if cnt.any():
                parts.append(np.repeat(pos, cnt))
        if not parts:
            return
        rep = np.sort(np.concatenate(parts))
        pairs = self._out_pairs()
        # the rows carry the event's own column values (as the reference
        # does), not the float32 lanes the dense path emits from
        self._dense.emit_cb(EventBatch(
            self._dense.out_stream_id, [nm for nm, _a in pairs],
            {nm: out_cols[attr][rep] for nm, attr in pairs},
            ts[rep], np.full(len(rep), ev.CURRENT, dtype=np.int8)))

    # -- barriers / lifecycle ------------------------------------------------

    def drain(self):
        self._dense.drain()

    def purge_idle(self, now: int, idle_ms: int):
        """Hot rows' activity clocks advance every routed cycle, so a
        promoted key looks idle only when it is: demote it first, so its
        pending chains are back in its dense row, then purge."""
        for key in list(self._slots):
            row = self._slots[key]["row"]
            if now - int(self._dense._row_last_used[row]) >= idle_ms:
                self._demote(key)
        self._dense.purge_idle(now, idle_ms)

    def snapshot(self) -> Dict:
        """Demote-all first: the persisted tree is a plain dense snapshot
        (restorable under other @app:hotkeys settings); the sketch rides
        along so routing warmth survives restore."""
        self.demote_all()
        tree = self._dense.snapshot()
        tree["hotkey_sketch"] = {
            "counts": dict(self.sketch.counts),
            "total": self.sketch.total,
        }
        return tree

    def restore(self, state: Dict):
        """Restore a snapshot of this router or of the reference's."""
        self._slots.clear()
        self._free_slots = list(range(self._scan.n_slots))[::-1]
        self._state = self._scan.init_state()
        self._scan.base_ts = None
        sk = state.get("hotkey_sketch")
        self.sketch = SpaceSavingSketch(cap=self.sketch.cap,
                                        decay=self.sketch.decay)
        if sk:
            self.sketch.counts = dict(sk["counts"])
            self.sketch.total = float(sk["total"])
        self._dense.restore(
            {k: v for k, v in state.items() if k != "hotkey_sketch"})

    def close(self):
        self._dense.close()
