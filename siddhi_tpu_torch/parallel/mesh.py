"""Device meshes, the sharded pattern engine, event routing.

Port of the JAX package's ``parallel/mesh.py``.  The mesh is an ordered
list of ``torch.device``s, one a shard: on ``"cpu"`` every shard sits on
the CPU (the counterpart of the reference's virtual CPU mesh, which its
tests run at eight devices); on ``cuda`` shard ``i`` sits on
``cuda:(i % torch.cuda.device_count())``, so several shards share a card
when there are fewer cards than shards (logged once, and reported as
``shards_per_card``).  A mesh never moves to the CPU.

The reference's ``ensure_virtual_devices`` and ``get_shard_map`` are JAX
plumbing (configuring XLA's CPU device count, resolving ``shard_map``'s
import path) and have no counterpart: a torch shard is a dict of
tensors on its device, and the step runs once a shard.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.core.emit_queue import fetch_coalesced
from siddhi_tpu_torch.core.exceptions import (
    SiddhiAppCreationError,
    SiddhiAppRuntimeError,
)
from siddhi_tpu_torch.core.ingest_stage import staged_put
from siddhi_tpu_torch.kernels.plane_pack import unpack_state
from siddhi_tpu_torch.ops.device_query import _pow2

log = logging.getLogger("siddhi_tpu_torch")

_warned_shared = set()


def distributed_initialize(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None):
    """Multi-process bring-up: one process a host, joined by
    ``torch.distributed`` (gloo on the CPU, nccl on cards).  Call once
    per process before any collective.  ``coordinator_address`` is
    ``host:port`` of process 0 (or a full ``tcp://`` URL); ``device``:
    ``"cpu"`` for gloo, else the cards (nccl)."""
    import torch.distributed as dist

    dev = torch.device("cuda" if device is None else device)
    backend = "gloo" if dev.type == "cpu" else "nccl"
    addr = coordinator_address or "localhost:29500"
    if "://" not in addr:
        addr = "tcp://" + addr
    dist.init_process_group(backend, init_method=addr,
                            world_size=num_processes, rank=process_id)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "p",
              devices=None, device=None) -> List[torch.device]:
    """The 1-D mesh over the partition axis: ``n_devices`` shards (all
    the cards when None; one on the CPU) on ``device`` (``cuda`` when
    None), or the explicit ``devices`` list.  ``axis_name`` is the
    reference's and names nothing here."""
    if devices is not None:
        mesh = [torch.device(d) for d in devices]
        if n_devices is not None:
            if len(mesh) < n_devices:
                raise SiddhiAppCreationError(
                    f"need {n_devices} devices, have {len(mesh)}")
            mesh = mesh[:n_devices]
        return mesh
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    if dev.type != "cuda":
        raise SiddhiAppCreationError(f"no mesh on device type {dev.type!r}")
    if not torch.cuda.is_available():
        raise SiddhiAppCreationError(
            "a device mesh on 'cuda' needs a CUDA card "
            "(pass device='cpu' for the CPU mesh)")
    cards = torch.cuda.device_count()
    n = n_devices or cards
    if n > cards and n not in _warned_shared:
        _warned_shared.add(n)
        log.info("device mesh: %d shards over %d card(s); %d shards share "
                 "a card", n, cards, -(-n // cards))
    return [torch.device("cuda", i % cards) for i in range(n)]


def shards_per_card(mesh) -> int:
    """The most shards any one device of ``mesh`` holds."""
    counts: Dict[torch.device, int] = {}
    for d in mesh:
        counts[d] = counts.get(d, 0) + 1
    return max(counts.values()) if counts else 0


def route_to_shards(n_shards: int, parts_per_shard: int,
                    part: np.ndarray, cols: Dict[str, np.ndarray],
                    ts: np.ndarray,
                    batch_per_shard: Optional[int] = None
                    ) -> Tuple[np.ndarray, Dict[str, np.ndarray], np.ndarray,
                               np.ndarray, np.ndarray]:
    """Host-side event routing, the reference's: bucket a batch by owning
    shard (``global_part // parts_per_shard``, shard-major layout),
    rewrite partition ids to shard-local indices, and pad every shard's
    bucket to the same pow-2 length, so that equal slices of the result
    are the shards' inputs.  Padded rows carry local index
    ``parts_per_shard``, each shard's scratch row.

    Returns ``(local_part, cols, ts, valid, pos)``, ``pos[i]`` the
    padded slot of input event ``i``.  Callers must not route two events
    of one partition in one call."""
    part = np.asarray(part)
    owner = part // parts_per_shard
    if len(part) and (owner.max() >= n_shards or owner.min() < 0):
        raise SiddhiAppCreationError(
            f"partition id out of range for {n_shards} x {parts_per_shard} layout")
    counts = np.bincount(owner, minlength=n_shards)
    max_count = int(counts.max()) if len(part) else 0
    B = int(batch_per_shard) if batch_per_shard is not None else _pow2(max_count)
    if max_count > B:
        raise SiddhiAppCreationError(
            f"shard bucket overflow: {max_count} events for one shard "
            f"> batch_per_shard={B}")
    n = n_shards * B
    local_part = np.full(n, parts_per_shard, dtype=np.int32)
    out_ts = np.zeros(n, dtype=np.asarray(ts).dtype)
    valid = np.zeros(n, dtype=bool)
    out_cols = {k: np.zeros(n, dtype=np.asarray(v).dtype) for k, v in cols.items()}
    # within-bucket rank (cumcount over stably sorted owners)
    order = np.argsort(owner, kind="stable")
    sorted_owner = owner[order]
    starts = np.searchsorted(sorted_owner, np.arange(n_shards), side="left")
    rank_sorted = np.arange(len(part)) - starts[sorted_owner]
    pos = np.empty(len(part), dtype=np.int64)
    pos[order] = sorted_owner * B + rank_sorted
    local_part[pos] = (part % parts_per_shard).astype(np.int32)
    out_ts[pos] = np.asarray(ts)
    valid[pos] = True
    for k, v in cols.items():
        out_cols[k][pos] = np.asarray(v)
    return local_part, out_cols, out_ts, valid, pos


class ShardedState:
    """A sharded engine's state: ``shards[i]``, a dict of tensors on mesh
    device ``i``, holds shard ``i``'s rows (its partitions, then its
    scratch row).  ``state[k]`` is the global shard-major array, the
    reference's layout, concatenated on the first shard's device: a
    copy, for snapshots and inspection; the steps work on ``shards``."""

    __slots__ = ("shards",)

    def __init__(self, shards: List[Dict[str, torch.Tensor]]):
        self.shards = list(shards)

    def __getitem__(self, key: str) -> torch.Tensor:
        parts = [sh[key] for sh in self.shards]
        d0 = parts[0].device
        return torch.cat([p.to(d0) for p in parts])

    def __iter__(self):
        return iter(self.shards[0])

    def keys(self):
        return self.shards[0].keys()

    def items(self):
        return [(k, self[k]) for k in self]

    @property
    def devices(self) -> List[torch.device]:
        return [next(iter(sh.values())).device for sh in self.shards]


def split_rows(n_shards: int, per_shard: int, rows: np.ndarray):
    """Logical ids (shard-major, no scratch rows) -> ``[(shard, local
    ids)]`` for the shards that hold any."""
    rows = np.asarray(rows, dtype=np.int64)
    owner = rows // per_shard
    return [(s, rows[owner == s] % per_shard)
            for s in np.unique(owner).tolist()]


class ShardedPatternEngine:
    """A dense NFA engine with its partition axis sharded over a mesh.

    Wraps ``ops.dense_nfa.compile_pattern``'s engine in the reference's
    shard-major layout: shard ``i`` owns partitions ``[i*pps, (i+1)*pps)``
    as rows ``[0, pps)`` of its own state dict, plus its scratch row
    ``pps``.  A batch is routed on the host and each shard's events go
    to its device in one ``staged_put``.  Each shard with events then
    runs the engine's own step on its rows: one ``batch_step`` launch
    (the ``dense_batch`` kernel) for a capture-free chain, else the
    general step a collision round.  Each shard's step is a part of its
    own in the ``DeferredDenseEmit``: its match count and outputs stay
    on its device until the count gate, and it compacts its own matches
    there.

    It keeps the engine's state surface (``process_deferred`` with its
    stream key, the snapshots, purge and timers), so a
    ``DensePatternRuntime`` holds it as it holds the engine; ``process``
    keeps the reference's one-stream signature.  Each shard takes
    exactly its own events: no bucket is padded, since nothing here
    recompiles a shape, so the scratch rows stay at their initial
    values.
    """

    def __init__(self, engine, mesh, axis_name: str = "p",
                 stream_key: Optional[str] = None):
        self.engine = engine
        self.mesh = list(mesh)
        self.axis_name = axis_name
        self.n_shards = len(self.mesh)
        if engine.n_partitions % self.n_shards:
            raise SiddhiAppCreationError(
                f"{engine.n_partitions} partitions not divisible by "
                f"{self.n_shards} shards")
        # usable partitions per shard; +1 scratch row per shard
        self.parts_per_shard = engine.n_partitions // self.n_shards
        self.rows_per_shard = self.parts_per_shard + 1
        # the stream process() steps (the reference's wrapper is one a
        # stream)
        self.stream_key = stream_key or engine.stream_keys[0]

    @property
    def device(self) -> torch.device:
        """The first shard's device (the runtime's step probe)."""
        return self.mesh[0]

    # -- state ---------------------------------------------------------------

    @property
    def n_state_rows(self) -> int:
        return self.n_shards * self.rows_per_shard

    def deal_rows(self, ids: np.ndarray) -> np.ndarray:
        """Allocation-counter ids -> logical partition ids, dealt
        round-robin (key #k on shard k % n_shards), so the load spreads
        from the first key on."""
        return ((ids % self.n_shards) * self.parts_per_shard
                + ids // self.n_shards)

    def init_state(self) -> ShardedState:
        """Each shard's initial rows, built on its own device."""
        return ShardedState([
            self.engine.init_state(n_rows=self.rows_per_shard, device=d)
            for d in self.mesh])

    def state_to_host(self, state: ShardedState) -> Dict[str, np.ndarray]:
        """The global shard-major state as numpy arrays (the reference's
        snapshot layout), one coalesced fetch a device."""
        keys = list(self.engine.state_layout())
        flat = fetch_coalesced([sh[k] for k in keys for sh in state.shards])
        n = self.n_shards
        return {k: np.concatenate(flat[i * n:(i + 1) * n])
                for i, k in enumerate(keys)}

    def state_from_host(self, host_state: Dict, base_ts: Optional[int]
                        ) -> ShardedState:
        """A global shard-major snapshot (this layout's row count; packed
        planes too) back onto the shards' devices.  Sets ``base_ts``."""
        rows = len(next(iter(host_state.values())))
        if rows != self.n_state_rows:
            raise SiddhiAppRuntimeError(
                f"cannot restore: snapshot has {rows} state rows but "
                f"this app's sharded layout needs {self.n_state_rows} "
                "(snapshot taken under a different @app:execution "
                "devices/partitions setting)")
        if "active_planes" in host_state:
            host_state = unpack_state(host_state)
        layout = self.engine.state_layout()
        if set(host_state) != set(layout):
            raise SiddhiAppRuntimeError(
                f"state keys {sorted(host_state)} do not match the engine's "
                f"{sorted(layout)}")
        rps = self.rows_per_shard
        for k, (shape, dt) in layout.items():
            v = np.asarray(host_state[k])
            if v.shape != (self.n_state_rows,) + shape[1:] or v.dtype != dt:
                raise SiddhiAppRuntimeError(
                    f"cannot restore: snapshot state '{k}' is "
                    f"{v.dtype}{list(v.shape)}; this app's sharded layout "
                    f"needs {dt}{[self.n_state_rows, *shape[1:]]}")
        shards = []
        for i, dev in enumerate(self.mesh):
            shards.append(staged_put(
                {k: np.array(np.asarray(host_state[k])[i * rps:(i + 1) * rps])
                 for k in layout}, dev, self.engine.ingest_stats))
        self.engine.base_ts = None if base_ts is None else int(base_ts)
        return ShardedState(shards)

    def live_state(self, state: ShardedState) -> Dict[str, torch.Tensor]:
        """The snapshot layout as device tensors (global copies)."""
        return {k: state[k] for k in self.engine.state_layout()}

    def maybe_re_anchor(self, state: ShardedState, rel64: np.ndarray):
        """The engine's re-anchor on every shard, each put back on its
        own device."""
        eng = self.engine
        delta = eng.re_anchor_delta(rel64)
        if delta is None:
            return state, rel64
        state.shards = [eng.shift_state(sh, delta, dev)
                        for sh, dev in zip(state.shards, self.mesh)]
        return state, rel64 - delta

    def _psum(self, scalars) -> torch.Tensor:
        """Per-shard 0-d tensors summed on the first shard's device."""
        dev0 = self.mesh[0]
        return torch.stack([x.to(dev0, non_blocking=True)
                            for x in scalars]).sum(dtype=torch.int32)

    def overflow_sum(self, state: ShardedState) -> torch.Tensor:
        return self._psum([sh["overflow"].sum() for sh in state.shards])

    def active_sum(self, state: ShardedState, rows) -> torch.Tensor:
        """Pending lanes of logical ``rows``, a 0-d tensor on the first
        shard's device."""
        out = [torch.zeros((), dtype=torch.int32, device=self.mesh[0])]
        for s, local in split_rows(self.n_shards, self.parts_per_shard,
                                   rows):
            sh = state.shards[s]
            idx = torch.as_tensor(local, device=sh["active"].device)
            out.append(sh["active"][idx].sum())
        return self._psum(out)

    def reset_rows(self, state: ShardedState, rows, ingest_stats=None):
        """Logical ``rows`` back to the initial row (a purge)."""
        tmpl_host = self.engine.init_state_host(n_rows=1)
        for s, local in split_rows(self.n_shards, self.parts_per_shard,
                                   rows):
            sh = state.shards[s]
            idx, tmpl = staged_put((local, tmpl_host), self.mesh[s],
                                   ingest_stats)
            for key, arr in sh.items():
                arr[idx] = tmpl[key]

    # -- timers (absent deadlines) -------------------------------------------

    def next_wakeup_state(self, state: ShardedState) -> Optional[int]:
        eng = self.engine
        if not eng.has_deadlines or eng.base_ts is None:
            return None
        return eng.wakeup_from_mins(fetch_coalesced(
            [eng.wake_min(sh) for sh in state.shards]))

    def on_time_state(self, state: ShardedState, now: int):
        """The engine's timer step on every shard, the fires merged in
        the reference's (fire time, row, lane) order; the rows it returns
        are logical partition ids (a fire never sits on a scratch row,
        which no step arms)."""
        eng = self.engine
        rel = eng.timer_rel(now)
        if rel is None:
            return state, None
        mats = []
        for s, sh in enumerate(state.shards):
            _sh, mat = eng.time_fires(sh, rel,
                                      row0=s * self.parts_per_shard)
            if mat is not None:
                mats.append(mat)
        if not mats:
            return state, None
        return state, eng.fires_from_host(fetch_coalesced(mats))

    # -- stepping ------------------------------------------------------------

    def process(self, state, part: np.ndarray, cols: Dict[str, np.ndarray],
                ts: np.ndarray):
        """``DensePatternEngine.process`` for this wrapper's stream.
        Returns ``(state, match_ev_idx[m], out[m, n_out], total_matches)``."""
        from siddhi_tpu_torch.ops.dense_nfa import DeferredDenseEmit

        state, pending = self.process_deferred(state, self.stream_key, part,
                                               cols, ts)
        ev, out = (pending or DeferredDenseEmit(self.engine)).rows()
        return state, ev, out, len(ev)

    def process_deferred(self, state: ShardedState, stream_key: str,
                         part: np.ndarray, cols: Dict[str, np.ndarray],
                         ts: np.ndarray, trace=None):
        """``DensePatternEngine.process_deferred`` over the shards: every
        output stays on the devices in a ``DeferredDenseEmit`` (None only
        for empty input), its count a device scalar until ``resolve()``.
        Returns ``(state, pending_or_None)``.  ``trace`` is taken for the
        engine's signature: a sharded batch records no detail spans (its
        shards' puts and rounds run on several cards)."""
        from siddhi_tpu_torch.ops.dense_nfa import (
            DeferredDenseEmit,
            _round_order,
        )

        eng = self.engine
        part = np.asarray(part)
        n = len(part)
        pps, n_shards = self.parts_per_shard, self.n_shards
        if n and (int(part.min()) < 0 or int(part.max()) >= eng.n_partitions):
            raise SiddhiAppCreationError(
                f"partition id out of range for {n_shards} x {pps} layout")
        rel64 = eng.rel_ts64(np.asarray(ts, dtype=np.int64))
        state, rel64 = self.maybe_re_anchor(state, rel64)
        rel = rel64.astype(np.int32)
        prepared = eng.prepare_cols(stream_key, cols)
        faults = eng.faults
        if faults is not None:
            faults.check("step.shard")
        if n == 0:
            return state, None
        owner = part // pps
        local = (part % pps).astype(np.int32)
        pending = DeferredDenseEmit(eng)
        if eng.step_kind == "batch":
            # one dense_batch launch a shard with events, on its rows
            by_shard = np.argsort(owner, kind="stable")
            ends = np.cumsum(np.bincount(owner, minlength=n_shards))
            for s, (lo, hi) in enumerate(zip(np.r_[0, ends[:-1]], ends)):
                if hi > lo:
                    rows = by_shard[lo:hi]
                    eng.batch_chunk(
                        pending, state.shards[s], stream_key, local[rows],
                        {k: v[rows] for k, v in prepared.items()}, rel[rows],
                        self.mesh[s], rows)
            return state, pending
        order, bounds = _round_order(part)
        n_rounds = len(bounds) - 1
        rnd = np.empty(n, dtype=np.int64)
        rnd[order] = np.repeat(np.arange(n_rounds), np.diff(bounds))
        # shard-major, then round by round, in batch order within each
        lay = np.argsort(owner * n_rounds + rnd, kind="stable")
        shard_end = np.cumsum(np.bincount(owner, minlength=n_shards))
        shard_start = shard_end - np.bincount(owner, minlength=n_shards)
        step = eng.make_general_step(stream_key)
        per_shard = []  # (shard, batch rows, round bounds, device inputs)
        for s in range(n_shards):
            rows = lay[shard_start[s]:shard_end[s]]
            if not len(rows):
                continue
            rb = np.concatenate([[0], np.cumsum(
                np.bincount(rnd[rows], minlength=n_rounds))])
            dev_in = staged_put(
                (local[rows], rel[rows],
                 {k: v[rows] for k, v in prepared.items()}),
                self.mesh[s], eng.ingest_stats, faults)
            per_shard.append((s, rows, rb, dev_in))
        for r in range(n_rounds):
            for s, rows, rb, (part_d, rel_d, cols_d) in per_shard:
                lo, hi = int(rb[r]), int(rb[r + 1])
                if hi == lo:
                    continue
                valid = torch.ones(hi - lo, dtype=torch.bool,
                                   device=part_d.device)
                _st, emit, outs, anchor, n_emit = step(
                    state.shards[s], part_d[lo:hi],
                    {k: v[lo:hi] for k, v in cols_d.items()},
                    rel_d[lo:hi], valid)
                pending.add(emit, outs["f"], outs["i"], anchor, n_emit,
                            rows[lo:hi])
        return state, pending
