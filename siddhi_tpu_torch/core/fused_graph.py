"""The app-side runtime of one fused chain (``ops/fused_graph.py``).

Port of the JAX package's ``core/fused_graph.py``.  ``FusedChainRuntime``
is the chain's counterpart of ``DeviceQueryRuntime``
(``core/device_single.py``): it turns the head stream's junction batches
into device lanes, advances the whole chain with one fused pass a batch,
and emits the tail's output batches into the tail query's selector,
rate limiter and output.  Intermediate streams build no ``EventBatch``
and dispatch nothing through their junctions.

It uses the same machinery as the per-query runtimes (the ingest stage,
the count-gated emit queue) and the same barriers: a drain before a
snapshot or restore, a rate-limit decision, a pull query and shutdown,
so callback content and order equal the junction path's.  The planner
makes it the tail query's ``device_runtime``, so the query's snapshot
carries the whole chain's state (every stage's device state and host
bookkeeping) under the tail query's name, in the reference's tree, and
the input journal's replay rebuilds it.  The reference's NaN quarantine
comes with ``ROADMAP.md`` §1 item 15b, as for the device query runtime.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

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
from siddhi_tpu_torch.ops.dense_nfa import state_from_numpy, state_to_numpy


class FusedChainRuntime:
    """One fused chain: a head-junction subscriber in, the tail query's
    output chain out, everything between on the device."""

    def __init__(self, graph, out_stream_id: str,
                 emit: Callable[[EventBatch], None], emit_depth=1,
                 clock: Optional[Callable[[], int]] = None,
                 ingest_depth=1):
        self.graph = graph
        self.out_stream_id = out_stream_id
        self.emit_cb = emit
        self.state = graph.init_state()
        self.engine_kind = "fused"
        self.step_invocations = 0  # fused steps dispatched (tests)
        # junction hops kept on the device a dispatch (stages - 1)
        self.hops_per_dispatch = (
            len(graph.stages) + (1 if graph.dense is not None else 0) - 1)
        self.fused_hops = 0
        self.emit_stats = EmitStats()
        self.emit_queue = EmitQueue(depth=emit_depth, stats=self.emit_stats)
        self.ingest_stats = IngestStats()
        graph.ingest_stats = self.ingest_stats
        self.ingest_stage = IngestStage(depth=ingest_depth,
                                        stats=self.ingest_stats)
        # the app clock, sampled when a batch is processed: a deferred
        # emit replays it to the tail's time rate limiter
        self.clock = clock

    # -- event path ----------------------------------------------------------

    def process_stream_batch(self, batch: EventBatch, keys=None):
        cur = batch.only(ev.CURRENT)
        if len(cur) == 0:
            return
        head = self.graph.stages[0]
        cols = {a: np.asarray(cur.columns[a])
                for a in head.all_attrs if a in cur.columns}
        ts = np.asarray(cur.timestamps, dtype=np.int64)
        self.state, pending = self.graph.process_batch_deferred(
            self.state, cols, ts)
        self.step_invocations += 1
        self.fused_hops += self.hops_per_dispatch
        now = self.clock() if self.clock is not None else None

        def _finish(p=pending, t=now):
            c = 0 if p is None else p.resolve()
            if c == 0:
                self.emit_queue.skip()
                return
            self.emit_queue.push(PendingEmit(
                p.device_arrays(),
                lambda host: self._emit_deferred(p, host, t)))

        self.ingest_stage.submit(
            None if pending is None else step_probe(self.graph.device),
            _finish)

    def drain(self):
        """Flush barrier: staged batches enqueue or skip their emits,
        then one coalesced drain emits everything in the synchronous
        order."""
        self.ingest_stage.flush()
        self.emit_queue.drain()

    def _emit_deferred(self, pending, host_arrays, now=None):
        out_cols, out_ts = pending.materialize(host_arrays)
        if len(out_ts) == 0:
            return
        mb = EventBatch(
            self.out_stream_id, self.graph.output_names, out_cols, out_ts,
            np.full(len(out_ts), ev.CURRENT, dtype=np.int8))
        if now is not None:
            mb.aux["emit_now"] = now
        self.emit_cb(mb)

    def close(self):
        self.drain()

    # -- scheduler task (the fused kinds have no pane timers; registering
    # keeps the planner's wiring uniform) ------------------------------------

    def next_wakeup(self) -> Optional[int]:
        return None

    def fire(self, now: int):
        self.drain()

    def on_start(self, now: int):
        pass

    # -- stats ---------------------------------------------------------------

    def stats(self) -> Dict:
        return {
            "engine": "fused",
            "stages": len(self.graph.stages)
            + (1 if self.graph.dense is not None else 0),
            "step_invocations": self.step_invocations,
            "fused_hops": self.fused_hops,
        }

    # -- snapshot contract ---------------------------------------------------

    def snapshot(self, fetch: bool = True) -> Dict:
        """The reference's tree: each stage's device state in its
        engine's host layout (``fetch=False``: the live tensors, which
        the persist path's capture clones), each device stage's host
        bookkeeping, the dense tail's epoch."""
        self.drain()
        g = self.graph
        chain: List[Dict] = []
        for si, st in enumerate(self.state):
            if not fetch:
                chain.append(dict(st))
            elif si < len(g.stages):
                chain.append(g.stages[si].state_to_host(st))
            else:
                chain.append(state_to_numpy(g.dense, st)[0])
        snap: Dict = {
            "chain": chain,
            "hosts": [eng.host_snapshot() for eng in g.stages],
        }
        if g.dense is not None:
            snap["dense_base_ts"] = g.dense.base_ts
        return snap

    def restore(self, state: Dict):
        """Restore a snapshot of this runtime or of the reference's."""
        self.drain()
        g = self.graph
        chain = state["chain"]
        n_states = len(g.stages) + (1 if g.dense is not None else 0)
        if len(chain) != n_states:
            raise SiddhiAppRuntimeError(
                f"fused-chain snapshot has {len(chain)} stage states; "
                f"this chain has {n_states} — persist and restore must "
                "use the same app definition")
        restored: List = []
        for si, st in enumerate(chain):
            if si < len(g.stages):
                restored.append(g.stages[si].state_from_host(st))
            else:
                restored.append(state_from_numpy(
                    g.dense, dict(st), state.get("dense_base_ts")))
        self.state = tuple(restored)
        for eng, h in zip(g.stages, state["hosts"]):
            eng.host_restore(h)


class FusedChainReceiver:
    """Head-junction subscriber feeding one fused chain."""

    def __init__(self, runtime: FusedChainRuntime):
        self.runtime = runtime

    def receive(self, batch: EventBatch):
        self.runtime.process_stream_batch(batch)
