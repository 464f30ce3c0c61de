"""Device-resident accumulator rows for incremental-aggregation ingest.

Port of the JAX package's ``aggregation/device_bank.py``.
``DeviceBucketBank`` keeps the mergeable base fields of the RUNNING
buckets of the finest duration as rows of torch tensors on its device
(``cuda``, or the CPU in tests).  Ingest adds each micro-batch into the
rows in place: one packed ``staged_put`` of the batch's row indices and
lane values, then per lane ``bank_scatter.accumulate_(a, rows, v)``, the
reference's ``a ⊕ segmented_reduce(rows, v)`` folded into one launch of
the hand-written kernel on a card (``kernels/bank_scatter.py``).
Nothing crosses back per batch: rows reach the host bucket store only at
flush barriers (watermark rollover, pull queries, snapshot, capacity and
overflow pressure), through one ``fetch_coalesced``.

Lane plan, as in the reference:

* FLOAT/DOUBLE sum/min/max fields, the stdDev sumsq row, and count
  fields (avg/stdDev denominators and bare counts) ride one float32 row
  each.  Counts are exact below 2**24; ``count_overflow_risk`` lets the
  runtime flush before any row could cross it.
* LONG sums ride a hi/lo int32 PAIR: hi accumulates ``v >> 16`` and lo
  ``v & 0xFFFF``; the flush recombines ``hi * 65536 + lo`` exactly.
  ``long_overflow_risk`` flushes (or sends one too-hot batch to the
  exact host path) before either lane could wrap.
* INT min/max ride one int32 row at native width.
* LONG min/max ride a LEXICOGRAPHIC hi/lo int32 pair: the signed high
  word and the bias-signed low word (``(v & 0xFFFFFFFF) - 2**31``), so a
  signed int32 compare of the pair is the exact 64-bit compare.  The
  update takes the hi extrema first, then the lo extrema among events
  whose hi ties the row's new hi.

The reference's bank has two formulations (XLA's ``.at[rows].add`` or,
under ``@app:kernels('bank')``, the Pallas reduce); the port has one,
``a ⊕ segmented_reduce(...)``, the reference's kernel branch, computed in
place by ``accumulate_`` (the LONG-extrema pairs still take the deltas of
``segmented_reduce``: their lo lane needs the new hi first).

Row layout: ``cap`` assignable rows + one dump row (index ``cap``) that
absorbs padded lanes and out-of-order events, which take the host merge
path instead (``aggregation/runtime.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.core.emit_queue import fetch_coalesced
from siddhi_tpu_torch.core.ingest_stage import IngestStats, staged_put
from siddhi_tpu_torch.kernels import bank_scatter
from siddhi_tpu_torch.ops.dense_nfa import resolve_device
from siddhi_tpu_torch.query_api import AttrType

_IDENTITY = {"sum": 0.0, "count": 0.0, "min": np.inf, "max": -np.inf}

# int32 lane identities: 0 for the LONG-sum hi/lo pairs, the int32
# extrema for INT/LONG min/max rows (padded lanes leave the dump row
# intact)
_I32_IDENTITY = {"sum": 0, "count": 0,
                 "min": np.iinfo(np.int32).max,
                 "max": np.iinfo(np.int32).min}

# float32 holds consecutive integers exactly up to 2**24: the largest
# count any bank row may accumulate between flushes
COUNT_EXACT_MAX = 1 << 24

# LONG sums split per event into hi = v >> 16 (signed) and
# lo = v & 0xFFFF (in [0, 65535]); each lane accumulates in int32 and
# the flush merge recombines hi * 65536 + lo exactly
_LONG_LO_BITS = 16
_LONG_LO_MAX = (1 << _LONG_LO_BITS) - 1
_I32_MAX = (1 << 31) - 1


class DeviceBucketBank:
    """Device rows for the bankable base fields of running finest buckets.

    One ``[cap+1]`` tensor per lane (float32, or int32 for LONG sums,
    INT/LONG extrema); ``rows`` maps (bucket_start, group_key) -> row
    index shared by every lane.
    """

    def __init__(self, fields, cap: int = 4096, device=None):
        self.fields = list(fields)
        self.names: List[str] = [f.name for f in self.fields]
        self.ops: Tuple[str, ...] = tuple(f.op for f in self.fields)
        self.cap = int(cap)
        self.device = resolve_device(device)
        self.r_pad = bank_scatter.pad_rows(self.cap + 1)
        self.rows: Dict[Tuple[int, Tuple], int] = {}
        self._free: List[int] = list(range(self.cap))
        self._arrays: Optional[List[torch.Tensor]] = None  # lazy
        # lane plan: each field owns one lane, except LONG sums and LONG
        # extrema, which own an exact hi/lo int32 pair (module docstring)
        self._lanes: List[Tuple[str, str]] = []  # (op, "f32"|"i32")
        self._field_lanes: List[Tuple[int, ...]] = []
        for f in self.fields:
            if f.op in ("sum", "min", "max") and f.type == AttrType.LONG:
                self._field_lanes.append((len(self._lanes),
                                          len(self._lanes) + 1))
                self._lanes += [(f.op, "i32"), (f.op, "i32")]
            elif f.op in ("min", "max") and f.type == AttrType.INT:
                self._field_lanes.append((len(self._lanes),))
                self._lanes.append((f.op, "i32"))
            else:
                self._field_lanes.append((len(self._lanes),))
                self._lanes.append((f.op, "f32"))
        # LONG-sum pairs only: extrema pairs never accumulate, so they
        # need no overflow guard and no recombine-by-65536
        self.long_names: List[str] = [
            f.name for f, ln in zip(self.fields, self._field_lanes)
            if len(ln) == 2 and f.op == "sum"
        ]
        # hi-lane index -> op of each LONG extrema pair: its two lanes
        # update together lexicographically
        self._pair_ops: Dict[int, str] = {
            fl[0]: op for fl, op in zip(self._field_lanes, self.ops)
            if len(fl) == 2 and op in ("min", "max")}
        # flush-barrier evidence: batches absorbed on the device vs host
        # materializations, and the batches' host-to-device puts
        self.scatters = 0
        self.flushes = 0
        self.ingest = IngestStats()
        # events scattered since the last flush: bounds the count any row
        # may hold (float32 counts are exact below COUNT_EXACT_MAX) and
        # the lo int32 lane of a LONG sum (each event adds <= 65535)
        self._has_count = "count" in self.ops
        self.events_since_flush = 0
        # per-LONG-field conservative bound on |hi| accumulated since the
        # last flush (long_overflow_risk)
        self._long_hi_used: Dict[str, int] = {}

    @property
    def dump_row(self) -> int:
        return self.cap

    def count_overflow_risk(self, n: int) -> bool:
        """True when scattering ``n`` more events could push a float32
        count row past exact-integer territory — the caller must flush
        first.  Always False when no count field is banked."""
        return (self._has_count
                and self.events_since_flush + n > COUNT_EXACT_MAX)

    @staticmethod
    def _hi_bound(v: np.ndarray, n: int) -> int:
        """Conservative bound on the |hi| lane growth one batch can cause
        in any single row: every event at the batch's max magnitude
        landing on one bucket.  Python ints — no int64 overflow."""
        m = max(abs(int(v.max())), abs(int(v.min())))
        return n * ((m >> _LONG_LO_BITS) + 1)

    def long_overflow_risk(self, fvals: Dict[str, np.ndarray],
                           n: int) -> bool:
        """True when scattering ``n`` more events with these values could
        wrap either int32 lane of a LONG-sum pair row — the caller must
        flush first (and if one batch is alone too hot, take the exact
        host path for it).  Always False when no LONG sum is banked."""
        if not self.long_names:
            return False
        if (self.events_since_flush + n) * _LONG_LO_MAX > _I32_MAX:
            return True
        return any(
            self._long_hi_used.get(name, 0)
            + self._hi_bound(fvals[name], n) > _I32_MAX
            for name in self.long_names
        )

    # -- device lanes --------------------------------------------------------

    def _ensure_arrays(self):
        if self._arrays is None:
            self._arrays = [
                torch.full((self.cap + 1,), _I32_IDENTITY[op],
                           dtype=torch.int32, device=self.device)
                if kind == "i32"
                else torch.full((self.cap + 1,), _IDENTITY[op],
                                dtype=torch.float32, device=self.device)
                for op, kind in self._lanes
            ]

    def _delta(self, rows, v, op):
        """This batch's per-row reduction of one int32 lane, ``[cap+1]``."""
        d = bank_scatter.segmented_reduce(rows, v, self.r_pad, op,
                                          _I32_IDENTITY[op])
        return d[:self.cap + 1]

    def _pair_update(self, a_hi, a_lo, rows, rows_long, vh, vl, op):
        """Lexicographic (hi, lo) extrema in place: hi decides; lo
        competes only where its hi TIES the row's new hi.  ``base`` reads
        the OLD hi, so neither lane is written before both are known."""
        ident = _I32_IDENTITY[op]
        pick = torch.minimum if op == "min" else torch.maximum
        new_hi = pick(a_hi, self._delta(rows, vh, op))
        cand = torch.where(vh == new_hi[rows_long], vl, ident)
        base = torch.where(a_hi == new_hi, a_lo, ident)
        new_lo = pick(base, self._delta(rows, cand, op))
        a_hi.copy_(new_hi)
        a_lo.copy_(new_lo)

    # -- row assignment ------------------------------------------------------

    def assign(self, keys) -> bool:
        """Reserve a row per key (idempotent for known keys).  Returns
        False when the free list cannot cover the new keys — the caller
        flushes (a capacity barrier) and retries, or falls back to the
        host path for the batch."""
        fresh = [k for k in keys if k not in self.rows]
        if len(fresh) > len(self._free):
            return False
        for k in fresh:
            self.rows[k] = self._free.pop()
        return True

    def _pack(self, ev_rows: np.ndarray, fvals: Dict[str, np.ndarray]):
        """One int32 ``[1 + lanes, n_pad]`` host array: the event rows,
        then each lane's values (float32 lanes as their bits).  ``n_pad``
        is a power of two >= 256; padded events target the dump row with
        each op's identity."""
        n = len(ev_rows)
        n_pad = max(1 << max(n - 1, 1).bit_length(), 256)
        packed = np.empty((1 + len(self._lanes), n_pad), dtype=np.int32)
        packed[0, :n] = ev_rows
        packed[0, n:] = self.dump_row
        for fi, (name, op) in enumerate(zip(self.names, self.ops)):
            lanes = self._field_lanes[fi]
            li = lanes[0] + 1
            if len(lanes) == 2:
                v = np.asarray(fvals[name]).astype(np.int64)
                if op == "sum":
                    # exact signed hi/lo split; padding adds 0
                    hi, lo = v >> _LONG_LO_BITS, v & _LONG_LO_MAX
                    self._long_hi_used[name] = (
                        self._long_hi_used.get(name, 0)
                        + self._hi_bound(v, n))
                else:
                    # lexicographic split: signed high word, bias-signed
                    # low word
                    hi, lo = v >> 32, (v & 0xFFFFFFFF) - (1 << 31)
                packed[li, :n] = hi
                packed[li + 1, :n] = lo
                packed[li:li + 2, n:] = _I32_IDENTITY[op]
            elif self._lanes[lanes[0]][1] == "i32":
                packed[li, :n] = fvals[name].astype(np.int32)
                packed[li, n:] = _I32_IDENTITY[op]
            else:
                col = packed[li].view(np.float32)
                col[:n] = fvals[name].astype(np.float32)
                col[n:] = _IDENTITY[op]
        return packed

    def scatter(self, ev_rows: np.ndarray, fvals: Dict[str, np.ndarray]):
        """Accumulate one micro-batch in place: ``ev_rows`` [n] row per
        event (``dump_row`` for events that take the host path),
        ``fvals`` the per-event value columns keyed by field name."""
        self._ensure_arrays()
        d = staged_put(self._pack(ev_rows, fvals), self.device, self.ingest)
        rows = d[0]
        rows_long = rows.long() if self._pair_ops else None
        vals = [d[1 + i].view(torch.float32) if kind == "f32" else d[1 + i]
                for i, (_op, kind) in enumerate(self._lanes)]
        arrays = self._arrays
        li = 0
        while li < len(self._lanes):
            op = self._lanes[li][0]
            if li in self._pair_ops:
                self._pair_update(arrays[li], arrays[li + 1], rows, rows_long,
                                  vals[li], vals[li + 1], op)
                li += 2
                continue
            bank_scatter.accumulate_(arrays[li], rows, vals[li], op)
            li += 1
        self.scatters += 1
        self.events_since_flush += len(ev_rows)

    # -- flush barriers ------------------------------------------------------

    def flush(self) -> Dict[Tuple[int, Tuple], Dict[str, object]]:
        """Materialize every assigned row to host and reset the bank: one
        coalesced device fetch, called only at barriers.  Returns
        {bucket_key: {field_name: value}} (Python floats and ints)."""
        if not self.rows:
            return {}
        host = fetch_coalesced(self._arrays)
        idx = np.fromiter(self.rows.values(), dtype=np.int64,
                          count=len(self.rows))
        cols = []
        for fi, op in enumerate(self.ops):
            lanes = self._field_lanes[fi]
            col = host[lanes[0]][idx]
            if len(lanes) == 2:
                hi = col.astype(np.int64)
                lo = host[lanes[1]][idx].astype(np.int64)
                # LONG sum: hi * 65536 + lo; LONG extrema: undo the bias
                col = (hi * (_LONG_LO_MAX + 1) + lo if op == "sum"
                       else hi * (1 << 32) + (lo + (1 << 31)))
            cols.append(col.tolist())
        out = {key: dict(zip(self.names, vals))
               for key, vals in zip(self.rows, zip(*cols))}
        self.flushes += 1
        self.clear()
        return out

    def clear(self):
        """Drop all rows and device lanes (restore path: the host
        snapshot is the single source of truth)."""
        self.rows.clear()
        self._free = list(range(self.cap))
        self._arrays = None
        self.events_since_flush = 0
        self._long_hi_used.clear()

    # -- state carry-over ----------------------------------------------------

    def lanes_to_numpy(self) -> Optional[List[np.ndarray]]:
        """Host copies of the lanes, in lane order (None before the first
        scatter), fetched with one ``fetch_coalesced``."""
        return None if self._arrays is None else fetch_coalesced(self._arrays)

    def load_lanes(self, rows: Dict[Tuple[int, Tuple], int],
                   arrays: Sequence[np.ndarray], events_since_flush: int = 0,
                   long_hi_used: Optional[Dict[str, int]] = None):
        """Adopt a bank's rows map and lane arrays (the JAX package's
        ``rows`` and ``_arrays`` as numpy, or ``lanes_to_numpy``) without
        a flush; the overflow counters carry over when given."""
        want = [(self.cap + 1,), ] * len(self._lanes)
        got = [tuple(np.shape(a)) for a in arrays]
        if got != want:
            raise ValueError(f"load_lanes: lane shapes {got}, expected {want}")
        self.rows = dict(rows)
        used = set(self.rows.values())
        self._free = [r for r in range(self.cap) if r not in used]
        dtypes = [np.int32 if kind == "i32" else np.float32
                  for _op, kind in self._lanes]
        # copies: the lanes are updated in place, and on the CPU a put
        # would alias the caller's arrays
        self._arrays = staged_put(
            [np.array(a, dtype=dt) for a, dt in zip(arrays, dtypes)],
            self.device, self.ingest)
        self.events_since_flush = int(events_since_flush)
        self._long_hi_used = dict(long_hi_used or {})
