"""Device-resident stream-graph fusion: one chain, one pass a batch.

Port of the JAX package's ``ops/fused_graph.py``.  Without fusion every
hop between two queries of an ``insert into`` chain goes through the
host: the producer's outputs are fetched, built into an ``EventBatch``,
dispatched by the junction, then padded and put on the device again by
the consumer.  ``FusedGraphEngine`` runs a chain of device queries
(filter, then window, then pattern) as torch ops over each junction
batch: each stage's computed output lanes feed the next stage's input
lanes on the device, a passthrough forwards the producer's own input
lane, and a row the producer dropped only loses its valid bit.  Nothing
is compacted, fetched or put again between stages; the host is touched
at the chain head (one ``staged_put`` a batch), at the count gate of
the emit queue and at the int32 re-anchor horizon, as for one device
query.

The chain runs stage by stage over the whole batch, padded to one width
(a power of two up to ``MAX_DEVICE_BATCH`` rows, whole chunks of it
above): a filter stage takes one step over every row, as the junction
path's filter query does, and only the running and sliding stages,
whose ``[B, B]`` masks and ``[B, W + B]`` gathers need the bound, step
chunk by chunk.  Each stage sees its rows in the order the reference's
chunk-by-chunk program gives them, so its state and outputs are the
same; each stage's epoch is re-anchored once a batch, before its first
step, as a standalone filter query's is.

Stages (the planner, ``planner/fusion.py``, keeps anything else on the
junction path, with its reason at WARNING):

- head and interior stages: single-input device queries of kind filter,
  running or sliding, no group by, CURRENT output;
- lanes between stages: INT (int32), FLOAT (float32), BOOL, and DOUBLE
  expression outputs (computed in float32 on both paths, so forwarding
  the float32 lane equals the junction's float64 column re-padded to
  float32);
- the tail: a device query as above (its order by, limit and offset run
  in the planner's host selector, as on the junction path) or an
  unpartitioned dense pattern over the last intermediate stream, without
  absent deadlines.

The dense tail steps the pattern engine's general step once per row of
the batch, as the junction path steps an unpartitioned pattern one
collision round per row (``DensePatternEngine._process_general``); a
row an earlier stage dropped steps the engine's scratch row ``P``, so
the partition row sees exactly the junction path's sequence (the
reference scans the rows with ``lax.scan`` inside its jitted program).
The padding rows past the batch's events are not stepped: they would
touch only row ``P``.  Integer lanes become the engine's bias-signed
hi/lo pair on the device, as ``prepare_cols`` does on the host.

Emission follows the emit queue's contract (``core/emit_queue.py``):
one count a batch gates it, and the count stays a device scalar until
``resolve`` fetches it in one ``fetch_coalesced``; matched rows stay on
the device until the queue drains, and ``FusedDeferredEmit.materialize``
gives what the junction path's tail query would have emitted for the
batch.  A dense tail's batch is one part of a ``DeferredDenseEmit``,
whose matches are compacted and ordered on the device as every dense
emit's are.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.core.emit_queue import fetch_coalesced
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.core.ingest_stage import staged_put
from siddhi_tpu_torch.ops.dense_nfa import _INT_TYPES, DeferredDenseEmit
from siddhi_tpu_torch.ops.device_query import (
    MAX_DEVICE_BATCH,
    _pow2,
    _split_i64,
)

TAIL_DEVICE = "device"
TAIL_DENSE = "dense"


class FusedGraphEngine:
    """One fused chain: device-query stages wired output to input on the
    device, with an optional dense-pattern tail.

    ``stages``: the chain's DeviceQueryEngines in flow order (each
    stage's input stream is the previous stage's ``insert into``
    target).  ``dense_tail``/``dense_stream_key``: the DensePatternEngine
    reading the last intermediate stream (None for a device tail)."""

    def __init__(self, stages: List, dense_tail=None,
                 dense_stream_key: Optional[str] = None):
        if not stages:
            raise SiddhiAppCreationError("fused chain needs device stages")
        if len(stages) + (1 if dense_tail is not None else 0) < 2:
            raise SiddhiAppCreationError("fused chain needs >= 2 stages")
        self.stages = list(stages)
        self.dense = dense_tail
        self.dense_stream_key = dense_stream_key
        self.device = stages[0].device
        for eng in stages:
            if eng.kind not in ("filter", "running", "sliding"):
                raise SiddhiAppCreationError(
                    f"fused chain: stage kind '{eng.kind}' not fusable")
            if eng.group_exprs or eng.partition_mode:
                raise SiddhiAppCreationError(
                    "fused chain: group-by/partition stages not fusable")
        for eng in stages[1:]:
            if eng.long_attrs:
                raise SiddhiAppCreationError(
                    "fused chain: LONG intermediate attributes have no "
                    "device-resident lane")
        # stage-to-stage wires: consumer attr -> producer lane
        self._wires: List[Optional[List[Tuple[str, str, str]]]] = [None]
        for si in range(1, len(stages)):
            self._wires.append(
                self._wire_for(stages[si - 1], stages[si].attrs))
        if dense_tail is not None:
            if dense_stream_key is None:
                raise SiddhiAppCreationError(
                    "fused chain: dense tail needs its stream key")
            if dense_tail.has_deadlines:
                raise SiddhiAppCreationError(
                    "fused chain: absent-deadline patterns need the "
                    "scheduler-driven junction path")
            sdef = dense_tail._stream_def(dense_stream_key)
            spec = {name: (kind, v)
                    for kind, v, name in stages[-1].out_spec}
            # (attr, "out"|"in", producer lane, integer: a hi/lo pair)
            self._dense_wire: List[Tuple[str, str, str, bool]] = []
            for a in dense_tail.numeric_stream_attrs(dense_stream_key):
                kind, v = self._resolve_spec(spec, a)
                self._dense_wire.append(
                    (a, kind, v, sdef.attribute_type(a) in _INT_TYPES))
            self.tail_kind = TAIL_DENSE
            self.output_names = list(dense_tail.output_names)
        else:
            tail = stages[-1]
            self.tail_kind = TAIL_DEVICE
            self.output_names = list(tail.output_names)
            # tail passthroughs gather the tail's input lanes on the host;
            # those lanes are float32/int32/bool here, so only types
            # whose lane is exact may ride them (the planner checks)
            self.fwd_names = sorted({
                v for kind, v, _n in tail.out_spec if kind == "passthrough"
            })
        # set by the runtime: staged puts count there; the app's fault
        # injector (step.device, step.dense, ingest.put)
        self.ingest_stats = None
        self.faults = None
        # general-step calls of the dense tail (one a stepped row)
        self.dense_steps = 0

    @staticmethod
    def _resolve_spec(spec, attr):
        if attr not in spec:
            raise SiddhiAppCreationError(
                f"fused chain: consumer attribute '{attr}' is not an "
                "output of the producer stage")
        kind, v = spec[attr]
        if kind == "expr":
            return "out", attr
        if kind == "passthrough":
            return "in", v
        raise SiddhiAppCreationError(
            f"fused chain: producer select item '{attr}' ({kind}) "
            "cannot stay device-resident")

    def _wire_for(self, producer, attrs):
        spec = {name: (kind, v) for kind, v, name in producer.out_spec}
        return [(a, *self._resolve_spec(spec, a)) for a in attrs]

    # -- state ---------------------------------------------------------------

    def init_state(self) -> Tuple:
        states = [eng.init_state() for eng in self.stages]
        if self.dense is not None:
            states.append(self.dense.init_state())
        return tuple(states)

    # -- the fused step ------------------------------------------------------

    @staticmethod
    def _stage_step(eng, state, cur, rel, grp, v):
        """One stage over the batch: one step, or one a chunk of
        ``MAX_DEVICE_BATCH`` rows for the kinds that need the bound
        (the batch width is then a whole number of chunks), the chunks'
        output lanes joined back to the batch width."""
        B = v.shape[0]
        if B <= MAX_DEVICE_BATCH or eng.kind == "filter":
            st, ov, out, _n = eng.step(state, cur, rel, grp, grp, v)
            return st, ov, out
        ovs, outs = [], []
        for i in range(0, B, MAX_DEVICE_BATCH):
            sl = slice(i, i + MAX_DEVICE_BATCH)
            state, ov, out, _n = eng.step(
                state, {k: x[sl] for k, x in cur.items()}, rel[sl],
                grp[sl], grp[sl], v[sl])
            ovs.append(ov)
            outs.append(out)
        return state, torch.cat(ovs), {
            k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def step(self, states, cols, rels, grp, valid, n: int):
        """The chain over one padded batch, on the device:

            (states, cols {head lane: [B]}, rels (each stage's [B] int32
             relative ms), grp [B], valid [B], n real rows)
              -> device tail: (states, emitmask [B], {name: [B]},
                               {attr: [B]}, count)
              -> dense tail: (states, emitmask [n, 2I], f, i, anchor,
                              count)

        ``count`` is already masked by the chain's valid lane, so the
        count gate never counts padding.  Stage states change in place
        where their steps write in place."""
        new_states = []
        v = valid
        cur = cols
        ov = valid
        out: Dict = {}
        for si, eng in enumerate(self.stages):
            if si > 0:
                # the hop: the producer's lanes straight into the
                # consumer's input env; dropped rows lose their valid bit
                v = v & ov
                cur = {a: (out[key] if src == "out" else cur[key])
                       for a, src, key in self._wires[si]}
            st, ov, out = self._stage_step(eng, states[si], cur, rels[si],
                                           grp, v)
            new_states.append(st)
        if self.dense is None:
            emitmask = ov & v
            count = emitmask.sum(dtype=torch.int32)
            fwd = {k: cur[k] for k in self.fwd_names}
            return tuple(new_states), emitmask, out, fwd, count
        v = v & ov
        dcols = {}
        for a, src, key, is_int in self._dense_wire:
            lane = out[key] if src == "out" else cur[key]
            if is_int:
                lane = lane.to(torch.int32)
                dcols[a + "|hi"] = torch.where(
                    lane < 0, torch.full_like(lane, -1),
                    torch.zeros_like(lane))
                dcols[a + "|lo"] = torch.bitwise_xor(
                    lane, torch.full_like(lane, -(2 ** 31)))
            else:
                dcols[a] = lane.to(torch.float32)
        P = self.dense.n_partitions
        part = torch.where(v, 0, P).to(torch.int32)
        rel = rels[-1]
        dstep = self.dense.make_general_step(self.dense_stream_key)
        dstate = states[-1]
        emits, fs, iis, anchors = [], [], [], []
        # one general step a row: the unpartitioned junction path's
        # collision rounds, in batch order
        for r in range(n):
            dstate, emit, outs, anchor, _ne = dstep(
                dstate, part[r:r + 1],
                {k: c[r:r + 1] for k, c in dcols.items()},
                rel[r:r + 1], v[r:r + 1])
            emits.append(emit)
            fs.append(outs["f"])
            iis.append(outs["i"])
            anchors.append(anchor)
        self.dense_steps += n
        new_states.append(dstate)
        emitmask = torch.cat(emits) & v[:n, None]
        count = emitmask.sum(dtype=torch.int32)
        return (tuple(new_states), emitmask, torch.cat(fs), torch.cat(iis),
                torch.cat(anchors), count)

    # -- host entry point ----------------------------------------------------

    def process_batch_deferred(self, states: Tuple,
                               cols: Dict[str, np.ndarray],
                               ts: np.ndarray):
        """Run the chain over one junction batch and keep every output on
        the device behind a ``FusedDeferredEmit``."""
        ts = np.asarray(ts, dtype=np.int64)
        n = len(ts)
        if n == 0:
            return states, None
        states, chunks = self._batch(states, cols, ts)
        return states, FusedDeferredEmit(self, chunks, ts)

    def _pad_batch(self, n: int) -> int:
        """The padded batch width (the sharded subclass rounds it up to
        split evenly over its mesh)."""
        return (_pow2(n) if n <= MAX_DEVICE_BATCH
                else -(-n // MAX_DEVICE_BATCH) * MAX_DEVICE_BATCH)

    def _batch(self, states: Tuple, cols: Dict[str, np.ndarray],
               ts: np.ndarray) -> Tuple[Tuple, List]:
        n = len(ts)
        states, host = self._host_batch(states, cols, ts,
                                        self._pad_batch(n))
        c, rels_t, grp, valid = staged_put(
            host, self.device, self.ingest_stats, self.faults)
        if self.faults is not None:
            self.faults.check("step.device")
            if self.dense is not None:
                self.faults.check("step.dense")
        res = self.step(tuple(states), c, rels_t, grp, valid, n)
        return res[0], [self._chunk(res, n, ts)]

    def _host_batch(self, states: Tuple, cols: Dict[str, np.ndarray],
                    ts: np.ndarray, B: int):
        """Each stage's epoch (re-anchored) and the head lanes, padded to
        ``B`` rows: ``(states, (cols, rels, grp, valid))`` as numpy."""
        n = len(ts)
        states = list(states)
        # each stage keeps its own epoch (base_ts), re-anchored on the
        # host at the int32 horizon as its own runtime would
        rels: List[np.ndarray] = []
        for si, eng in enumerate(self.stages):
            if eng.base_ts is None:
                eng.base_ts = int(ts[0]) - 1
            rel64 = ts - eng.base_ts
            if int(rel64.max()) >= eng._REL_LIMIT:
                states[si], rel64 = eng._re_anchor(states[si], rel64)
            r = np.zeros(B, dtype=np.int32)
            r[:n] = rel64.astype(np.int32)
            rels.append(r)
        if self.dense is not None:
            rel64 = self.dense.rel_ts64(ts)
            states[-1], rel64 = self.dense.maybe_re_anchor(
                states[-1], rel64)
            r = np.zeros(B, dtype=np.int32)
            r[:n] = rel64.astype(np.int32)
            rels.append(r)
        # head lanes zero-padded to B: one staged_put for the chain
        head = self.stages[0]
        c: Dict[str, np.ndarray] = {}
        for a, lane in head._lane_dtype.items():
            col = np.zeros(B, dtype=lane)
            if a in cols:
                col[:n] = np.asarray(cols[a]).astype(lane)
            c[a] = col
        for a in head.long_attrs:
            hi = np.zeros(B, dtype=np.int32)
            lo = np.zeros(B, dtype=np.int32)
            if a in cols:
                hi[:n], lo[:n] = _split_i64(np.asarray(cols[a]))
            c[a + "|hi"] = hi
            c[a + "|lo"] = lo
        grp = np.zeros(B, dtype=np.int32)
        valid = np.zeros(B, dtype=bool)
        valid[:n] = True
        return states, (c, tuple(rels), grp, valid)

    def _chunk(self, res, n: int, ts: np.ndarray):
        """A step's outputs over ``n`` rows: a device tail's emit chunk,
        or a dense tail's ``DeferredDenseEmit`` of one part."""
        if self.tail_kind == TAIL_DENSE:
            _states, emitmask, out_f, out_i, anchor, count = res
            pending = DeferredDenseEmit(self.dense)
            pending.add(emitmask, out_f, out_i, anchor, count, np.arange(n))
            return pending
        _states, emitmask, out, fwd, count = res
        return {
            "emitmask": emitmask, "out": dict(out), "names": list(out),
            "fwd": dict(fwd), "fwd_names": list(fwd),
            "count": count, "n": n, "ts": ts,
        }


class FusedDeferredEmit:
    """The device-resident outputs of one fused junction batch, pending
    drain: ``resolve`` fetches only the count scalars, then
    ``device_arrays`` and ``materialize`` give what the junction path's
    tail query would have emitted for the batch (one ``EventBatch``
    worth of columns, in the declared output dtypes).  A dense tail's
    batch is its one ``DeferredDenseEmit`` (``dense``), a device tail's
    its emit chunks."""

    __slots__ = ("graph", "chunks", "dense", "ts64", "_total")

    def __init__(self, graph: FusedGraphEngine, chunks: List,
                 ts64: np.ndarray):
        self.graph = graph
        dense = graph.tail_kind == TAIL_DENSE
        self.dense: Optional[DeferredDenseEmit] = chunks[0] if dense else None
        self.chunks: List[dict] = [] if dense else chunks
        self.ts64 = ts64
        self._total: Optional[int] = None

    def resolve(self) -> int:
        if self.dense is not None:
            return self.dense.resolve()
        if self._total is not None:
            return self._total
        counts = (fetch_coalesced([ch["count"] for ch in self.chunks])
                  if self.chunks else [])
        self.chunks = [ch for ch, c in zip(self.chunks, counts) if int(c)]
        self._total = int(sum(int(c) for c in counts))
        return self._total

    def device_arrays(self) -> List:
        if self.dense is not None:
            return self.dense.device_arrays()
        arrs: List = []
        for ch in self.chunks:
            arrs.append(ch["emitmask"])
            arrs.extend(ch["out"][nm] for nm in ch["names"])
            arrs.extend(ch["fwd"][k] for k in ch["fwd_names"])
        return arrs

    def materialize(self, host_arrays
                    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        if self.dense is not None:
            ev, out = self.dense.materialize(host_arrays)
            return out.columns(), self.ts64[ev]
        return self._materialize_device(host_arrays)

    def _materialize_device(self, host):
        tail = self.graph.stages[-1]
        pos = 0
        col_parts: List[Dict[str, np.ndarray]] = []
        ts_parts: List[np.ndarray] = []
        for ch in self.chunks:
            n = ch["n"]
            em = host[pos][:n]
            pos += 1
            out_np = {}
            for nm in ch["names"]:
                out_np[nm] = host[pos][:n]
                pos += 1
            fwd_cols = {}
            for k in ch["fwd_names"]:
                fwd_cols[k] = host[pos][:n]
                pos += 1
            idx = np.flatnonzero(em)
            if len(idx) == 0:
                continue
            col_parts.append(
                tail._out_columns(out_np, idx, None, fwd_cols, idx))
            ts_parts.append(ch["ts"][idx])
        if not ts_parts:
            return tail._empty_cols(), np.empty(0, dtype=np.int64)
        out_cols = {nm: np.concatenate([p[nm] for p in col_parts])
                    for nm in tail.output_names}
        return out_cols, np.concatenate(ts_parts)
