"""The device query engine sharded over a mesh.

Port of the JAX package's ``parallel/device_shard.py``.
``ShardedDeviceQueryEngine`` wraps a stateful
``ops.device_query.DeviceQueryEngine`` of any of ``SHARDED_KINDS``:

- ``running``: the per-group accumulator rows are laid out shard-major
  along the group axis, one scratch row a shard; events route on the
  host to their owning shard, and each shard steps its own rows.
- ``tumbling`` (lengthBatch/timeBatch): the same layout for the pane
  accumulators, but every shard takes the whole segment at its
  single-device positions, the events it does not own on its scratch
  row, so that each float sum adds its events in the single-device
  order and has its bits; the pane bookkeeping stays on the base
  engine's host sweep, fed the sum of the shards' passing counts, so
  both paths place boundaries alike.  A pane flush runs the flush step on every shard and
  recovers each row's global group id; an empty timeBatch pane skips
  the flush (``flush_skips``).
- ``sliding`` (length/time): the global ring cannot shard by key, so
  every shard holds the whole ring and advances it alike, while the
  batch axis is split: each shard gathers and reduces the windows of
  its own block of output rows.
- ``keyed_sliding`` (partitioned length/time): the per-key ring rows
  shard along the window-group axis.  minForever/maxForever accumulate
  per composed (key, group) id, which does not sit with its key, so
  that combination is refused (the planner keeps one device and counts
  why).

Group and window-group ids intern on the host as in the unsharded
engine; a round-robin bijection (``gid -> (gid % n) * rows_per_shard +
gid // n``) spreads sequentially allocated ids over the shards.  Each
shard's state is its own dict of tensors on its device
(``mesh.ShardedState``); each step reaches the state scatters'
``accumulate_`` kernel on the shard's rows.  The wrapper keeps the
engine's host surface (``process_batch``, snapshots, purge, pane
timers), so ``DeviceQueryRuntime`` holds it as it holds an unsharded
engine, and every output is the single-device engine's.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Optional

import numpy as np
import torch

from siddhi_tpu_torch.core.emit_queue import fetch_coalesced
from siddhi_tpu_torch.core.exceptions import (
    SiddhiAppCreationError,
    SiddhiAppRuntimeError,
)
from siddhi_tpu_torch.core.ingest_stage import staged_put
from siddhi_tpu_torch.ops.device_query import _pow2
from siddhi_tpu_torch.parallel.mesh import ShardedState, route_to_shards

log = logging.getLogger("siddhi_tpu_torch")

#: kinds the wrapper takes ('filter' is stateless: there is nothing to
#: shard, and one device already saturates on the host-to-device copy)
SHARDED_KINDS = ("running", "tumbling", "sliding", "keyed_sliding")


class ShardedDeviceQueryEngine:
    """A stateful DeviceQueryEngine with its window state sharded across
    the mesh (group axis, key axis, or batch axis; see the module
    docstring)."""

    #: span label of the cycle tracer: sharded dispatches trace as 'shard'
    engine_kind = "shard"

    def __init__(self, engine, mesh, axis_name: str = "p"):
        if engine.kind not in SHARDED_KINDS:
            raise SiddhiAppCreationError(
                f"mesh sharding of the device query engine covers the "
                f"{'/'.join(SHARDED_KINDS)} kinds; kind="
                f"'{engine.kind}' is stateless and runs single-device")
        host = engine.init_state_host()
        if engine.kind == "keyed_sliding" and (
                "acc_minf" in host or "acc_maxf" in host):
            raise SiddhiAppCreationError(
                "sharded keyed_sliding: minForever/maxForever accumulate "
                "per composed (key, group) id, which does not co-locate "
                "with the partition-key shard axis; runs single-device")
        self.__dict__["engine"] = engine
        self.mesh = list(mesh)
        self.axis_name = axis_name
        self.n_shards = len(self.mesh)
        if engine.kind == "keyed_sliding":
            axis_len, axis_what = engine.n_wgroups, "window groups"
        else:
            axis_len, axis_what = engine.n_groups, "groups"
        if engine.kind != "sliding" and axis_len % self.n_shards:
            # @app:execution checks partitions % devices at app creation;
            # this guards direct construction
            raise SiddhiAppCreationError(
                f"{axis_len} {axis_what} not divisible by "
                f"{self.n_shards} shards")
        if engine.kind == "sliding":
            self.per_shard = 0
            self.rows_per_shard = 0
        else:
            self.per_shard = axis_len // self.n_shards
            self.rows_per_shard = self.per_shard + 1  # +1 scratch row
        # empty timeBatch panes skip the flush step: their accumulators
        # are already at their reset values and it would emit nothing
        self.flush_skips = 0

    # -- the engine's surface ------------------------------------------------

    def __getattr__(self, name):
        return getattr(self.__dict__["engine"], name)

    # the runtime sets these on the engine it holds: the base engine's
    # host code reads them too
    @property
    def faults(self):
        return self.engine.faults

    @faults.setter
    def faults(self, v):
        self.engine.faults = v

    @property
    def ingest_stats(self):
        return self.engine.ingest_stats

    @ingest_stats.setter
    def ingest_stats(self, v):
        self.engine.ingest_stats = v

    @property
    def device(self):
        """The first shard's device (the runtime's step probe)."""
        return self.mesh[0]

    # -- sharded state -------------------------------------------------------

    def _put(self, x, shard: int):
        # the shared staged_put owns the ingest.put fault site and its
        # retry ladder
        return staged_put(x, self.mesh[shard], self.ingest_stats,
                          self.faults)

    def init_state(self) -> ShardedState:
        """Each shard's initial rows, built on its own device (every row
        of the engine's initial state is the same)."""
        host = self.engine.init_state_host()
        shards = []
        for dev in self.mesh:
            sh = {}
            for k, v in host.items():
                if self.engine.kind == "sliding":
                    sh[k] = torch.from_numpy(v).to(dev)
                    continue
                row = torch.from_numpy(np.ascontiguousarray(v[:1])).to(dev)
                sh[k] = row.expand((self.rows_per_shard,)
                                   + v.shape[1:]).contiguous()
            shards.append(sh)
        return ShardedState(shards)

    def state_to_host(self, state: ShardedState) -> Dict[str, np.ndarray]:
        """The reference's snapshot layout: the global shard-major rows
        (the sliding kind: its one replicated ring), one coalesced fetch
        a device."""
        keys = list(state)
        if self.engine.kind == "sliding":
            return dict(zip(keys, fetch_coalesced(
                [state.shards[0][k] for k in keys])))
        n = self.n_shards
        flat = fetch_coalesced([sh[k] for k in keys for sh in state.shards])
        return {k: np.concatenate(flat[i * n:(i + 1) * n])
                for i, k in enumerate(keys)}

    def live_state(self, state: ShardedState) -> Dict[str, torch.Tensor]:
        """The snapshot layout as device tensors: the global shard-major
        rows (copies), or the sliding kind's one replicated ring."""
        if self.engine.kind == "sliding":
            return dict(state.shards[0])
        return dict(state.items())

    def state_from_host(self, host_state: Dict[str, np.ndarray]
                        ) -> ShardedState:
        """A snapshot back onto the shards.  An axis-sharded snapshot must
        carry this layout's row count: one taken under another device
        count has another shard-major bijection and would cross-wire
        groups.  The sliding kind's replicated ring keeps the
        single-device layout and restores under any device count."""
        if self.engine.kind == "sliding":
            expect = {k: v.shape
                      for k, v in self.engine.init_state_host().items()}
            for k, v in host_state.items():
                shape = np.asarray(v).shape
                if k in expect and shape != expect[k]:
                    raise SiddhiAppCreationError(
                        f"sliding device-query snapshot '{k}' has shape "
                        f"{shape}; this query needs {expect[k]}")
            return ShardedState([
                self._put({k: np.array(v, copy=True)
                           for k, v in host_state.items()}, s)
                for s in range(self.n_shards)])
        rps = self.rows_per_shard
        n_rows = self.n_shards * rps
        for k, v in host_state.items():
            v = np.asarray(v)
            if v.shape[0] != n_rows:
                raise SiddhiAppCreationError(
                    f"sharded device-query snapshot '{k}' has "
                    f"{v.shape[0]} rows; this {self.n_shards}-device "
                    f"layout needs {n_rows} — persist and restore "
                    "must use the same @app:execution devices count")
        return ShardedState([
            self._put({k: np.array(np.asarray(v)[s * rps:(s + 1) * rps])
                       for k, v in host_state.items()}, s)
            for s in range(self.n_shards)])

    def _remap(self, gid: np.ndarray) -> np.ndarray:
        """Sequential id -> shard-major row id, round-robin across the
        shards, each shard's scratch row accounted for."""
        owner = gid % self.n_shards
        local = gid // self.n_shards
        return owner * self.rows_per_shard + local

    def _route_part(self, gid: np.ndarray) -> np.ndarray:
        """Global id -> the global partition id ``route_to_shards``
        takes (owner * per_shard + local)."""
        owner = gid % self.n_shards
        local = gid // self.n_shards
        return owner * self.per_shard + local

    def _count(self, counts):
        """The shards' counts summed on the first shard's device."""
        dev0 = self.mesh[0]
        return torch.stack([c.to(dev0, non_blocking=True)
                            for c in counts]).sum(dtype=torch.int32)

    # -- host entry points (the engine's) ------------------------------------

    def process_batch(self, state, cols: Dict[str, np.ndarray],
                      ts: np.ndarray,
                      part_keys: Optional[np.ndarray] = None):
        """The synchronous form of the deferred path: one count-gated,
        coalesced fetch a call."""
        eng = self.engine
        state, pending = self.process_batch_deferred(state, cols, ts,
                                                     part_keys)
        if pending is not None and pending.resolve() == 0:
            pending = None
        if pending is None:
            eng.last_group_keys = (
                [] if eng.group_exprs and not eng.partition_mode else None)
            return state, eng._empty_cols(), np.empty(0, dtype=np.int64)
        out_cols, out_ts, keys = pending.materialize(
            fetch_coalesced(pending.device_arrays()))
        eng.last_group_keys = keys
        return state, out_cols, out_ts

    def process(self, state, cols, ts, part_keys=None):
        state, out_cols, out_ts = self.process_batch(state, cols, ts,
                                                     part_keys)
        names = self.engine.output_names
        rows = [{nm: out_cols[nm][i] for nm in names}
                for i in range(len(out_ts))]
        return state, rows

    def process_batch_deferred(self, state, cols: Dict[str, np.ndarray],
                               ts: np.ndarray,
                               part_keys: Optional[np.ndarray] = None):
        """The async-emit entry point: the summed count is the only value
        fetched later (``resolve``); the outputs stay on the shards'
        devices until the emit queue drains them."""
        from siddhi_tpu_torch.ops.device_query import (
            MAX_DEVICE_BATCH,
            DeferredDeviceEmit,
        )

        eng = self.engine
        ts = np.asarray(ts, dtype=np.int64)
        n = len(ts)
        if n == 0:
            return state, None
        pk_all = np.asarray(part_keys) if part_keys is not None else None
        pending = DeferredDeviceEmit(eng)
        if eng.kind == "tumbling":
            # pane sweeps segment the batch themselves
            state = self._deferred_chunk(state, cols, ts, pk_all, pending)
            return state, (pending if pending.chunks else None)
        # the unsharded engine's chunk bound: [B, B] same-group masks
        for i in range(0, n, MAX_DEVICE_BATCH):
            sl = slice(i, i + MAX_DEVICE_BATCH)
            state = self._deferred_chunk(
                state, {k: np.asarray(v)[sl] for k, v in cols.items()},
                ts[sl], pk_all[sl] if pk_all is not None else None, pending)
        return state, (pending if pending.chunks else None)

    def _re_anchor(self, state: ShardedState, rel64: np.ndarray):
        """The engine's re-anchor: the window entries shift on every
        shard."""
        eng = self.engine
        delta = eng._re_anchor_delta(rel64)
        state.shards = [eng._shift_window(sh, delta) for sh in state.shards]
        return state, rel64 - delta

    def _deferred_chunk(self, state, cols, ts, pk, pending):
        eng = self.engine
        n = len(ts)
        if eng.base_ts is None:
            eng.base_ts = int(ts[0]) - 1
        rel64 = ts - eng.base_ts
        if int(rel64.max()) >= eng._REL_LIMIT:
            state, rel64 = self._re_anchor(state, rel64)
        rel = rel64.astype(np.int32)
        now = int(ts.max())
        if eng.partition_mode:
            if pk is None:
                raise SiddhiAppRuntimeError(
                    "partitioned device query needs per-row partition keys")
            # window groups intern unconditionally: their last-use clock
            # drives the idle purge even when composed groups hold state
            wgrp = eng._intern_wgroups(pk, now)
            grp = (eng._intern_groups(cols, ts, n, pk=pk, now=now)
                   if eng.group_exprs else wgrp)
        else:
            wgrp = None
            grp = eng._intern_groups(cols, ts, n)
        if eng.kind == "tumbling":
            state, out_cols, out_ts = self._process_tumbling(
                state, cols, rel, grp, n)
            if len(out_ts):
                pending.chunks.append({
                    "kind": "host", "cols": out_cols, "ts": out_ts,
                    "keys": eng.last_group_keys})
            return state
        if eng.kind == "sliding":
            return self._sliding_chunk(state, cols, rel, grp, n, ts,
                                       pending)
        lanes = eng.host_lane_cols(cols, n)
        if eng.kind == "keyed_sliding":
            # route by the owning ring row (the partition key); the
            # composed group id rides along as a pseudo-lane
            lanes["__grp"] = grp.astype(np.int32)
            key = wgrp
        else:
            key = grp
        local, rcols, rts, valid, pos = route_to_shards(
            self.n_shards, self.per_shard, self._route_part(key), lanes,
            rel)
        rgrp = rcols.pop("__grp", None)
        B = len(local) // self.n_shards
        puts = []
        for s in range(self.n_shards):
            sl = slice(s * B, (s + 1) * B)
            if rgrp is None:  # running: the local row is the group
                g, wg = local[sl], np.zeros(B, dtype=np.int32)
            else:  # keyed: the local ring row, the global composed id
                g, wg = rgrp[sl], local[sl]
            puts.append(self._put(
                ({k: v[sl] for k, v in rcols.items()},
                 rts[sl].astype(np.int32), g, wg, valid[sl]), s))
        if self.faults is not None:
            self.faults.check("step.shard")
        ovs, outs, counts = [], [], []
        for s, (c, t, g, wg, v) in enumerate(puts):
            _st, ov, out, n_match = eng.step(state.shards[s], c, t, g, wg,
                                             v)
            ovs.append(ov)
            outs.append(dict(out))
            counts.append(n_match)
        # the count gate stays on the device until resolve(); the group
        # ids stay on the host for the key capture
        pending.chunks.append({
            "kind": "device", "ov": ovs, "out": outs,
            "names": list(outs[0]), "n": n, "pos": pos,
            "count": self._count(counts),
            "gids": (grp.copy() if eng.group_exprs else None),
            "ts": ts, "cols": {k: np.asarray(v) for k, v in cols.items()}})
        return state

    def _sliding_chunk(self, state, cols, rel, grp, n, ts, pending):
        """The batch-axis split: the batch, padded to a power of two and
        then to a multiple of the shard count, goes whole to every
        shard; shard ``s`` advances the ring and computes output rows
        ``[s * b, (s + 1) * b)``, so the shards' outputs in shard order
        are the rows in order."""
        eng = self.engine
        B = _pow2(n)
        B *= self.n_shards // math.gcd(B, self.n_shards)
        b = B // self.n_shards
        c, t, g, valid = self._padded(cols, rel, grp, n, B)
        puts = [self._put((c, t, g, valid), s) for s in range(self.n_shards)]
        if self.faults is not None:
            self.faults.check("step.shard")
        ovs, outs, counts = [], [], []
        for s, (cd, td, gd, vd) in enumerate(puts):
            env = eng._base_env(cd, td, B)
            fmask = eng._filter_mask(env, vd)
            state.shards[s], ov, out = eng._sliding_step(
                state.shards[s], env, fmask, td, gd, B, r0=s * b, nb=b)
            ovs.append(ov)
            outs.append(dict(out))
            counts.append((ov & vd[s * b:(s + 1) * b]).sum(
                dtype=torch.int32))
        pending.chunks.append({
            "kind": "device", "ov": ovs, "out": outs,
            "names": list(outs[0]), "n": n, "count": self._count(counts),
            "gids": (grp[:n].copy() if eng.group_exprs else None),
            "ts": ts, "cols": {k: np.asarray(v) for k, v in cols.items()}})
        return state

    # -- tumbling panes ------------------------------------------------------

    def _process_tumbling(self, state, cols, rel, grp, n):
        """The base engine's pane sweep (its host pane bookkeeping) over
        the sharded accumulate and flush steps."""
        eng = self.engine
        chunks = []  # (cols, abs_ts, n_rows, keys|None)

        def flush_pane(st, when):
            return self._flush_pane(st, when, chunks)

        state = eng._pane_sweep(state, cols, rel, grp, n, flush_pane,
                                acc_segment=self._acc_segment)
        out_cols, out_ts = eng._concat_chunks(chunks)
        return state, out_cols, out_ts

    def _padded(self, cols, rel, grp, n: int, B: int):
        """The first ``n`` events as host lanes padded to ``B``, as the
        engine pads a chunk: ``(cols, ts, grp, valid)``, the padding on
        group 0 and invalid."""
        valid = np.zeros(B, dtype=bool)
        valid[:n] = True
        c = {}
        for k, v in self.engine.host_lane_cols(cols, n).items():
            col = np.zeros(B, dtype=v.dtype)
            col[:n] = v
            c[k] = col
        t = np.zeros(B, dtype=np.int32)
        t[:n] = rel[:n]
        g = np.zeros(B, dtype=np.int32)
        g[:n] = grp[:n]
        return c, t, g, valid

    def _acc_segment(self, state, cols, rel, grp, idx, count: bool):
        """The engine's ``_acc_segment`` on the shards.  Every shard takes
        the whole segment at the single-device positions, padded as the
        engine pads it: its own events on their local rows, the others'
        on its scratch row and masked out.  Kernel 3 then combines each
        row's events in the order of the single-device launch, so every
        sum has its bits.  The shards' passing counts are summed, which
        keeps the pane fill counts of the host sweep the single-device
        ones."""
        eng = self.engine
        n = len(idx)
        c, t, g, valid = self._padded(
            {k: np.asarray(v)[idx] for k, v in cols.items()}, rel[idx],
            grp[idx], n, _pow2(n))
        # the padding carries group 0's key, as the engine's does
        gkv = eng._gk_vals(g)
        owner = g % self.n_shards
        local = (g // self.n_shards).astype(np.int32)
        puts = []
        for s in range(self.n_shards):
            mine = owner == s
            puts.append(self._put(
                (c, t, np.where(mine, local, self.per_shard).astype(np.int32),
                 gkv, valid & mine), s))
        if self.faults is not None:
            self.faults.check("step.shard")
        counts = []
        for s, (c, t, g, gk, v) in enumerate(puts):
            _st, n_pass = eng.acc_step(state.shards[s], c, t, g, gk, v)
            counts.append(n_pass)
        if not count:
            return state, None
        return state, int(fetch_coalesced([self._count(counts)])[0])

    def _flush_pane(self, state, when, chunks):
        """Close the open pane: the flush step on every shard; the rows
        that emit are shard-major (owner * rows_per_shard + local), so
        each recovers its global group id, and they emit in ascending
        id order, the single-device flush's."""
        eng = self.engine
        if eng.window_name == "timeBatch" and not eng._pane_fill:
            # no passing event touched this pane: nothing to flush.
            # timeBatch only: lengthBatch counts its fill after the flush
            self.flush_skips += 1
            return state
        if self.faults is not None:
            self.faults.check("step.shard")
        flushed, counts = [], []
        for s, sh in enumerate(state.shards):
            state.shards[s], ov, out, n_match = eng.flush_step(sh)
            flushed.append((ov, out))
            counts.append(n_match)
        if int(fetch_coalesced([self._count(counts)])[0]) == 0:
            return state  # count gate: an empty pane fetches no column
        names = list(flushed[0][1])
        w = 1 + len(names)
        host = fetch_coalesced([x for ov, out in flushed
                                for x in [ov] + [out[k] for k in names]])
        raw_ov = np.concatenate(host[0::w])
        out_np = {nm: np.concatenate(host[1 + j::w])
                  for j, nm in enumerate(names)}
        rows = np.flatnonzero(raw_ov)
        rps = self.rows_per_shard
        gid = (rows % rps) * self.n_shards + rows // rps
        order = np.argsort(gid, kind="stable")
        sel, gids = rows[order], gid[order]
        out_cols = eng._out_columns(out_np, sel, gids, None, None)
        keys = eng._keys_for_gids(gids) if eng.group_exprs else None
        chunks.append((out_cols, when, len(sel), keys))
        return state

    def flush_due(self, state, now: int):
        """Timer flush: close every pane whose boundary is <= ``now``
        with the sharded flush.  Returns ``(state, out_cols, out_ts)``."""
        eng = self.engine
        if eng.kind != "tumbling":
            return eng.flush_due(state, now)
        chunks = []
        while True:
            w = eng.pane_wakeup()
            if w is None or w > now:
                break
            state = self._flush_pane(state, w, chunks)
            eng._advance_pane()
        out_cols, out_ts = eng._concat_chunks(chunks)
        return state, out_cols, out_ts

    def purge_idle_keys(self, state, now: int, idle_ms):
        """Partition-mode purge: the engine's own, with the dead ids
        mapped to this layout's shard-major rows (group rows and
        keyed_sliding ring rows shard alike) and reset on their
        shards."""
        eng = self.engine
        dead = eng.purge_idle_ids(now, idle_ms)
        if dead is None:
            return state, 0
        g_rows = self._remap(np.asarray(dead[0], dtype=np.int64))
        w_rows = self._remap(np.asarray(dead[1], dtype=np.int64))
        rps = self.rows_per_shard
        for s, sh in enumerate(state.shards):
            g = g_rows[g_rows // rps == s] % rps
            wr = w_rows[w_rows // rps == s] % rps
            if len(g) or len(wr):
                eng.reset_rows(sh, g, wr, self.mesh[s])
        return state, len(dead[1])
