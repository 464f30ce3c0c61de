"""Stream-table joins against device-resident tables.

Port of the JAX package's ``devtable/join.py``.  ``DevTableJoinRuntime``
replaces the host ``JoinRuntime`` and ``JoinStreamReceiver`` for an
eligible query (an inner join, one ``DeviceTable`` side, a stream side
with no window and no filters, a primary-key equality conjunct): the
arriving batch puts its key lane and the lanes the condition reads on
the device once, the probe finds each event's table slot, gathers the
row and evaluates the FULL join condition on device lanes, and matched
pairs go through the emit queue, with nothing materialized on the host
between ingest and emit.

The reference's probe compares ``[B, C]`` keys against slots; the port
finds the same slot with the table's sorted key index (``torch.
searchsorted`` over the valid slots' keys, sorted once a revision):
because a primary key lives in at most one valid slot, the slot and the
``matched`` flag equal the reference's.  The condition compiles with
the device query path's compiler (float32 lanes flushed of subnormals,
as the join probe's, ``core/join.py``).

Snapshot consistency: the probe reads the table's CURRENT tensors at
dispatch (``DeviceTable.device_state`` under the table lock).  A later
scatter writes new tensors and never the ones a probe in flight reads,
so the probe sees exactly the revision it was dispatched against.

Because the gate requires a primary-key equality conjunct, at most ONE
table row matches each event, so outputs are fixed ``[B]`` lanes and
matched pairs emit in arrival order, the host ``JoinRuntime._join``'s
row-major order.  A batch runs in chunks of at most ``MAX_CHUNK`` events,
one emit a chunk, as in the reference.  A demoted table (or a batch
carrying nulls in a condition lane) falls back for that batch to the
host cross product, after a pipeline drain, so the emit order holds.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

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
from siddhi_tpu_torch.core.ingest_stage import (
    IngestStage,
    IngestStats,
    staged_put,
    step_probe,
)
from siddhi_tpu_torch.kernels.dense_step import flush_subnormals
from siddhi_tpu_torch.observability.trace import STAGE_TABLE_PROBE
from siddhi_tpu_torch.ops.device_query import _pow2
from siddhi_tpu_torch.planner.host_expr import N_KEY, TS_KEY
from siddhi_tpu_torch.util import faults as _faults

class DevTableJoinRuntime:
    """One stream-table join lowered onto the device batch cycle."""

    MAX_CHUNK = 4096  # events a probe (the reference's bound); one emit each

    def __init__(self, name: str, stream_side, table_side, stream_is_left: bool,
                 condition, key_expr, cond_stream_lanes: Dict[str, Tuple[str, np.dtype]],
                 out_stream_id: str, emit, emit_depth=1, ingest_depth=1,
                 clock=None, device=None, device_condition=None,
                 faults=None, tracer=None):
        self.name = name
        self.faults = faults
        self.tracer = tracer
        self.stream_side = stream_side
        self.table_side = table_side
        self.table = table_side.table
        self.stream_is_left = stream_is_left
        # the host condition (the per-batch fallback's cross product) and
        # its device form (the probe's)
        self.condition = condition
        self.device_condition = device_condition
        self.key_expr = key_expr
        # condition-referenced stream attrs riding device lanes:
        # env key -> (attribute name, lane dtype)
        self._cond_lanes = cond_stream_lanes
        self.out_stream_id = out_stream_id
        self.emit = emit
        self.clock = clock
        self.device = torch.device(device)
        self.engine_kind = "devtable_join"
        self.step_invocations = 0
        self.probe_invocations = 0
        self.host_fallback_batches = 0
        self.emit_stats = EmitStats()
        self.emit_queue = EmitQueue(depth=emit_depth, stats=self.emit_stats,
                                    faults=faults, on_fault=self._on_fault)
        self.ingest_stats = IngestStats()
        self.ingest_stage = IngestStage(
            depth=ingest_depth, stats=self.ingest_stats,
            on_fault=self._on_fault if faults is not None else None)
        left, right = ((stream_side, table_side) if stream_is_left
                       else (table_side, stream_side))
        self._out_names = [
            left.qualified_key(a.name) for a in left.definition.attributes
        ] + [right.qualified_key(a.name) for a in right.definition.attributes]
        self._tbl_names = [a.name for a in self.table.definition.attributes]
        self._tbl_env = {table_side.qualified_key(a.name): a.name
                         for a in self.table.definition.attributes}

    def probe(self, keys, ev_mask, ev_lanes, tcols, key_index):
        """``[B]`` lanes in, ``(mask, gathered {attr: [B]}, count)``:
        the slot holding each event's key among the valid slots (the
        reference's ``argmax`` of the ``[B, C]`` key match), the table
        row there, and the full condition over both."""
        skeys, sslots = key_index
        k = keys.long()
        pos = torch.searchsorted(skeys, k).clamp_max(skeys.shape[0] - 1)
        matched = (skeys[pos] == k) & ev_mask
        slot = torch.where(matched, sslots[pos], 0)
        gathered = {nm: c[slot] for nm, c in tcols.items()}
        env = dict(ev_lanes)
        for qk, nm in self._tbl_env.items():
            g = gathered[nm]
            env[qk] = flush_subnormals(g) if g.dtype == torch.float32 else g
        env[N_KEY] = keys.shape[0]
        ok = torch.as_tensor(self.device_condition.fn(env),
                             device=keys.device)
        mask = matched & ok.to(torch.bool).broadcast_to(matched.shape)
        return mask, gathered, mask.sum(dtype=torch.int32)

    # -- batch entry ------------------------------------------------------

    def process_stream_batch(self, batch: EventBatch):
        cur = batch.only(ev.CURRENT)
        n = len(cur)
        if n == 0:
            return
        now = self.clock() if self.clock is not None else 0
        host_reason = self._host_only_reason(cur)
        if host_reason is not None:
            # pipeline barrier first so the synchronous host emit cannot
            # overtake queued device emits from earlier batches
            self.ingest_stage.flush()
            self.emit_queue.drain()
            self.host_fallback_batches += 1
            self._host_join(cur, now)
            return
        # one sampled-or-None cycle token a batch, its chunks' spans in it
        tok = (self.tracer.begin_cycle(self.engine_kind, n)
               if self.tracer is not None else None)
        keys = self._event_keys(cur)
        for lo in range(0, n, self.MAX_CHUNK):
            hi = min(n, lo + self.MAX_CHUNK)
            self._dispatch_chunk(cur, keys, lo, hi, now, tok)

    def _host_only_reason(self, cur: EventBatch) -> Optional[str]:
        if self.table.demoted:
            return "table demoted to host"
        for _, (attr, _dt) in self._cond_lanes.items():
            if cur.columns[attr].dtype.kind == "O":
                return f"nulls in condition attribute '{attr}'"
        return None

    def _event_keys(self, cur: EventBatch) -> np.ndarray:
        env = {self.stream_side.qualified_key(a.name): cur.columns[a.name]
               for a in self.stream_side.definition.attributes}
        env[TS_KEY] = cur.timestamps
        env[N_KEY] = len(cur)
        return np.broadcast_to(self.key_expr.fn(env), (len(cur),))

    def _dispatch_chunk(self, cur, keys, lo, hi, now, tok=None):
        cn = hi - lo
        B = _pow2(cn)
        klane = np.zeros(B, dtype=np.int32)
        klane[:cn] = keys[lo:hi].astype(np.int32, copy=False)
        mlane = np.zeros(B, dtype=bool)
        mlane[:cn] = True
        lanes = {}
        for ek, (attr, dt) in self._cond_lanes.items():
            col = np.zeros(B, dtype=dt)
            col[:cn] = cur.columns[attr][lo:hi].astype(dt, copy=False)
            lanes[ek] = col
        # snapshot-consistent: the CURRENT tensors, under the table lock
        tcols, _tvalid, key_index = self.table.device_state()
        t0 = time.perf_counter()
        k_d, m_d, l_d = staged_put((klane, mlane, lanes), self.device,
                                   self.ingest_stats, self.faults)
        l_d = {k: flush_subnormals(v) if v.dtype == torch.float32 else v
               for k, v in l_d.items()}
        mask_d, gathered_d, count_d = self.probe(k_d, m_d, l_d, tcols,
                                                 key_index)
        self.step_invocations += 1
        self.probe_invocations += 1
        if self.tracer is not None:
            # the probe's dispatch, host clock (no wait on the device)
            self.tracer.record_span(STAGE_TABLE_PROBE, self.engine_kind,
                                    t0, time.perf_counter(), n_events=cn)

        def finish():
            c = int(fetch_coalesced([count_d])[0])
            if tok is not None:
                tok.step_done(c)
            if c == 0:
                self.emit_queue.skip()
                return
            arrays = [mask_d] + [gathered_d[nm] for nm in self._tbl_names]
            self.emit_queue.push(PendingEmit(
                arrays,
                lambda host: self._materialize(host, cur, lo, now),
                trace=tok))

        self.ingest_stage.submit(step_probe(self.device), finish, trace=tok)

    def _on_fault(self, e: BaseException):
        _faults.isolate(self.tracer, self.faults, e)

    # -- deferred materialization (runs on fetched HOST arrays) -----------

    def _materialize(self, host: List[np.ndarray], cur: EventBatch,
                     lo: int, now: int):
        mask = host[0]
        sel = np.flatnonzero(mask)
        rows = sel + lo
        cols: Dict[str, np.ndarray] = {}
        for a in self.stream_side.definition.attributes:
            cols[self.stream_side.qualified_key(a.name)] = \
                cur.columns[a.name][rows]
        for i, nm in enumerate(self._tbl_names):
            cols[self.table_side.qualified_key(nm)] = host[1 + i][sel]
        out = EventBatch(
            self.out_stream_id,
            self._out_names,
            {k: cols[k] for k in self._out_names},
            cur.timestamps[rows],
            np.full(len(rows), ev.CURRENT, dtype=np.int8),
        )
        out.aux["emit_now"] = now
        self.emit(out)

    # -- per-batch host fallback (exact host-join semantics) ---------------

    def _host_join(self, cur: EventBatch, now: int):
        buf = self.table.rows_batch()
        n_a, n_b = len(cur), len(buf)
        if n_b == 0:
            return
        env: Dict[str, np.ndarray] = {}
        for a in self.stream_side.definition.attributes:
            env[self.stream_side.qualified_key(a.name)] = np.repeat(
                cur.columns[a.name], n_b)
        for a in self.table.definition.attributes:
            env[self.table_side.qualified_key(a.name)] = np.tile(
                buf.columns[a.name], n_a)
        env[TS_KEY] = np.repeat(cur.timestamps, n_b)
        env[N_KEY] = n_a * n_b
        mask2 = np.broadcast_to(
            self.condition.fn(env), (n_a * n_b,)).reshape(n_a, n_b)
        ai, bi = np.nonzero(mask2)
        if len(ai) == 0:
            return
        cols: Dict[str, np.ndarray] = {}
        for a in self.stream_side.definition.attributes:
            cols[self.stream_side.qualified_key(a.name)] = \
                cur.columns[a.name][ai]
        for a in self.table.definition.attributes:
            cols[self.table_side.qualified_key(a.name)] = buf.columns[a.name][bi]
        out = EventBatch(
            self.out_stream_id,
            self._out_names,
            {k: cols[k] for k in self._out_names},
            cur.timestamps[ai],
            np.full(len(ai), ev.CURRENT, dtype=np.int8),
        )
        out.aux["emit_now"] = now
        self.emit(out)

    # -- barrier contract ---------------------------------------------------

    def drain(self):
        self.ingest_stage.flush()
        self.emit_queue.drain()

    def close(self):
        self.drain()

    def snapshot(self, fetch: bool = True) -> Dict:
        self.drain()
        return {}

    def restore(self, state: Dict):
        self.drain()


class DevTableJoinReceiver:
    """Junction subscriber replacing ``JoinStreamReceiver`` for the
    stream side of a devtable-lowered join."""

    def __init__(self, runtime: DevTableJoinRuntime):
        self.runtime = runtime

    def receive(self, batch: EventBatch):
        self.runtime.process_stream_batch(batch)
