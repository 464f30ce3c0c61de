"""Device execution of general single-stream queries inside the app.

Port of the JAX package's ``core/device_single.py``: the glue the
planner uses to run a ``SiddhiManager`` filter, window or group-by query
under ``@app:execution('tpu')`` on the device query engine
(``ops/device_query.py``) instead of the host chain.  Each junction
batch advances the engine; its outputs stay on the device until the
count gate (one fetch a batch) says there is something to fetch, then
go through the emit queue into the query's selector (order by, limit
and offset), rate limiter and output.  Every point where host code
could observe emit timing (snapshot, restore, timer flushes, rate-limit
decisions, purges, shutdown) drains first, so callback content and
order do not depend on the queue depths.

The runtime is also an app scheduler task: ``next_wakeup``/``fire``
close timeBatch panes on watermark time when no further event arrives.
Under ``@app:faults`` the emit queue retries its drains and isolates a
failing one (``on_fault``), the engine checks ``step.device`` and
``ingest.put``, and a ``state.poison`` fault arms the NaN/Inf
quarantine (``util/faults.poison_guard``): a poisoned step's outputs
are dropped and the state goes back to the last clean copy.  Each
batch may carry a sampled cycle token of the app's tracer (ingest,
step and emit spans).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.emit_queue import EmitQueue, EmitStats, PendingEmit
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import SiddhiAppRuntimeError
from siddhi_tpu_torch.core.ingest_stage import (
    IngestStage,
    IngestStats,
    step_probe,
)
from siddhi_tpu_torch.util import faults as _faults


class DeviceQueryRuntime:
    """App-side wrapper of one DeviceQueryEngine: junction batches in,
    output batches into ``emit``."""

    def __init__(self, engine, out_stream_id: str,
                 emit: Callable[[EventBatch], None], emit_depth: int = 1,
                 ingest_depth: int = 1,
                 clock: Optional[Callable[[], int]] = None,
                 faults=None, tracer=None):
        self.engine = engine
        self.out_stream_id = out_stream_id
        self.emit_cb = emit
        self.tracer = tracer
        self.engine_kind = "device"
        # the app's fault injector (the engine reads step.device and
        # ingest.put from engine.faults)
        self.faults = faults
        engine.faults = faults
        # the engine carries the stats so its staged puts count there
        self.ingest_stats = IngestStats()
        engine.ingest_stats = self.ingest_stats
        self.state = engine.init_state()
        # junction batches stepped on the device (reference: the proof
        # that the device path ran)
        self.step_invocations = 0
        self.emit_stats = EmitStats()
        self.emit_queue = EmitQueue(depth=emit_depth, stats=self.emit_stats,
                                    faults=faults, on_fault=self._on_fault)
        self.ingest_stage = IngestStage(
            depth=ingest_depth, stats=self.ingest_stats,
            on_fault=self._on_fault if faults is not None else None)
        # the state.poison quarantine's restore point
        self._last_good = None
        # the app clock, sampled when a batch is processed: a deferred
        # emit replays it to the query's time rate limiter
        self.clock = clock

    def _on_fault(self, e: BaseException):
        _faults.isolate(self.tracer, self.faults, e)

    # -- event path ----------------------------------------------------------

    def reads(self, stream_id: str) -> bool:
        return self.engine.stream_id == stream_id

    def process_partitioned(self, stream_id: str, batch: EventBatch, keys):
        """Partition mode: a partitioned stream's batch with each row's
        raw key, composed into the engine's group axis."""
        self.process_stream_batch(batch, keys=keys)

    def process_stream_batch(self, batch: EventBatch, keys=None):
        """Advance the engine with a junction batch's CURRENT rows.
        ``keys`` (partition mode): the raw partition key of each of those
        rows, from the partition receiver."""
        cur = batch.only(ev.CURRENT)
        if len(cur) == 0:
            return
        tok = (self.tracer.begin_cycle(self.engine_kind, len(cur))
               if self.tracer is not None else None)
        eng = self.engine
        cols = {a: np.asarray(cur.columns[a])
                for a in eng.all_attrs if a in cur.columns}
        ts = np.asarray(cur.timestamps, dtype=np.int64)
        self.state, pending = eng.process_batch_deferred(
            self.state, cols, ts, part_keys=keys)
        self.step_invocations += 1
        self.state, self._last_good, quarantined = _faults.poison_guard(
            self.faults, self.state, self._last_good, eng.init_state)
        if quarantined:
            # the corrupted step's outputs are dropped
            if tok is not None:
                tok.aborted("step")
            if self.tracer is not None:
                self.tracer.dump("poison-quarantine")
            return
        now = self.clock() if self.clock is not None else None

        def _finish(p=pending, t=now):
            c = 0 if p is None else p.resolve()
            if tok is not None:
                tok.step_done(c)
            if c == 0:
                self.emit_queue.skip()
                return
            self.emit_queue.push(PendingEmit(
                p.device_arrays(),
                lambda host: self._emit_deferred(p, host, t), trace=tok))

        # the count fetch (resolve) is the blocking device sync; with
        # ingest.depth > 1 it runs after the next batch's dispatch
        self.ingest_stage.submit(
            None if pending is None else step_probe(eng.device), _finish,
            trace=tok)

    def drain(self):
        """Flush barrier: the ingest stage first (staged batches enqueue
        or skip their emits), then the emit queue."""
        self.ingest_stage.flush()
        self.emit_queue.drain()

    def close(self):
        self.drain()

    def _emit_deferred(self, pending, host_arrays, now=None):
        out_cols, out_ts, keys = pending.materialize(host_arrays)
        self._emit(out_cols, out_ts, keys, now=now)

    def _emit(self, out_cols: Dict[str, np.ndarray], out_ts: np.ndarray,
              keys=None, now=None):
        if len(out_ts) == 0:
            return
        mb = EventBatch(
            self.out_stream_id, self.engine.output_names, out_cols, out_ts,
            np.full(len(out_ts), ev.CURRENT, dtype=np.int8))
        if keys is not None:
            if len(keys) != len(mb):
                raise SiddhiAppRuntimeError(
                    f"device query emitted {len(mb)} rows but {len(keys)} "
                    "group keys")
            # the group-key side channel per-group rate limiters read
            mb.aux["group_keys"] = list(keys)
        if now is not None:
            mb.aux["emit_now"] = now
        self.emit_cb(mb)

    def purge_idle(self, now: int, idle_ms) -> int:
        """Partition mode: reclaim the rows of idle keys (``@purge``).
        Drains first, so the purged keys' pending emits go out."""
        self.drain()
        self.state, n = self.engine.purge_idle_keys(self.state, now, idle_ms)
        return n

    # -- scheduler task (timeBatch pane flushes) -----------------------------

    def next_wakeup(self) -> Optional[int]:
        return self.engine.pane_wakeup()

    def fire(self, now: int):
        # batches processed before this tick emit first
        self.drain()
        self.state, out_cols, out_ts = self.engine.flush_due(self.state, now)
        self._emit(out_cols, out_ts, self.engine.last_group_keys, now=now)

    # -- snapshot contract ---------------------------------------------------

    def snapshot(self, fetch: bool = True) -> Dict:
        """The reference's snapshot tree: the device state as numpy
        copies (``fetch=False``: the live state tensors, which the
        persist path's capture clones), and the engine's host
        bookkeeping."""
        self.drain()
        return {"device_state": (self.engine.state_to_host(self.state)
                                 if fetch else dict(self.state)),
                "host": self.engine.host_snapshot()}

    def restore(self, state: Dict):
        """Restore a snapshot of this runtime or of the reference's."""
        self.drain()
        self.state = self.engine.state_from_host(state["device_state"])
        self.engine.host_restore(state["host"])


class DeviceQueryReceiver:
    """Junction subscriber feeding one device-lowered query."""

    def __init__(self, runtime: DeviceQueryRuntime):
        self.runtime = runtime

    def receive(self, batch: EventBatch):
        self.runtime.process_stream_batch(batch)
