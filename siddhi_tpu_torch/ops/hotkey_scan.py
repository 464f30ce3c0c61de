"""Batched hot-key scan NFA: the skew router's engine.

Port of the JAX package's ``ops/hotkey_scan.py``.  H promoted hot keys
ride an ``[H, n_pad]`` slot axis through ONE fused scan per junction
cycle (``kernels/scan_chain.py``: the CUDA kernel on a card, its plain
twin on the CPU), while cold keys stay on the dense partition path.
The reference's other step, two associative-scan passes over
materialized max-plus and counting matrices, is pinned identical to its
kernel there and is not ported.

Two chains ride one pass:

- the max-plus chain carries the per-lane YOUNGEST pending start
  (liveness: does a chain complete here);
- the counting chain carries the NUMBER of pending chains per lane.

In the eligible class (every-headed linear chain, capture-free
current-event filters, selects of the final node only, no ``within``)
same-node chains are interchangeable and their emitted rows are
identical, so emitting ``count_before[S-1]`` copies of the final-node
row at each completing event equals the dense engine's
one-row-per-pending-chain emission.  Counts are float32, exact below
2**24 pending chains per lane.

Padding: slots and events beyond the cycle's real work carry an
all-False filter row, which leaves both chains unchanged.

State handoff (promotion/demotion) converts between a dense partition
row (``active``/``first_ts`` instance lanes) and the scan's per-lane
(youngest start, count) pair: dense node ``j`` holds chains that
consumed pattern events ``1..j``, exactly scan lane ``j``.  Promotion
takes the youngest active start and the lane population; demotion
re-arms ``min(count, I)`` instance lanes at the youngest start (the
excess is counted in the row's ``overflow``), which is exact for
emissions because starts are unobservable in the eligible class.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.core.emit_queue import fetch_coalesced
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.kernels.scan_chain import fused_scan
from siddhi_tpu_torch.planner.expr import N_KEY
from siddhi_tpu_torch.query_api import StateInputStream

from .nfa_scan import NEG, ScanPatternEngine


class HotKeyScanEngine:
    """H hot-key slots of one linear chain, advanced by one fused scan
    per junction cycle.

    Wraps a ``ScanPatternEngine`` for chain validation and filter
    compilation (its constructor raises ``SiddhiAppCreationError`` with
    the reason for every ineligible shape), then adds the slot axis and
    the dense handoff converters.  State is ``{"v": [H, S] f32,
    "c": [H, S] f32}`` on ``device``: youngest start (relative to
    ``base_ts``) and pending-chain count per lane; lane 0 is the
    constant lane (v=0, c=1)."""

    def __init__(self, st: StateInputStream, stream_def, n_slots: int,
                 device):
        if st.type == StateInputStream.SEQUENCE:
            raise SiddhiAppCreationError(
                "hotkey scan: sequence (consecutive-event) semantics — "
                "the scan keep-transition implements pattern semantics")
        if st.within_ms is not None:
            raise SiddhiAppCreationError(
                "hotkey scan: 'within' needs per-chain starts for "
                "partial expiry; the count abstraction cannot express it")
        base = ScanPatternEngine(st, stream_def)
        self.base = base
        self.n_nodes = base.n_nodes
        self.stream_id = base.stream_id
        self.n_slots = int(n_slots)
        self.device = torch.device(device)
        self.base_ts: Optional[int] = None

    # -- state ---------------------------------------------------------------

    def init_state(self) -> Dict[str, torch.Tensor]:
        H, S = self.n_slots, self.n_nodes
        v = torch.full((H, S), NEG, dtype=torch.float32, device=self.device)
        v[:, 0] = 0.0
        c = torch.zeros((H, S), dtype=torch.float32, device=self.device)
        c[:, 0] = 1.0
        return {"v": v, "c": c}

    def slot_init_rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host template of one empty slot (promotion writes start from
        this, demotion resets to it)."""
        S = self.n_nodes
        v = np.full(S, NEG, dtype=np.float32)
        v[0] = 0.0
        c = np.zeros(S, dtype=np.float32)
        c[0] = 1.0
        return v, c

    # -- dense handoff -------------------------------------------------------

    def dense_row_to_slot(self, active: np.ndarray, first_ts: np.ndarray,
                          dense_base: int, scan_base: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """One dense partition row (host ``active`` [S, I] bool,
        ``first_ts`` [S, I] int32 rel ``dense_base``) -> scan slot rows
        (v, c) relative to ``scan_base``.  Dense node j == scan lane j;
        every-start engines keep node 0 as the implicit virgin, so only
        lanes 1..S-1 carry chains."""
        v, c = self.slot_init_rows()
        for j in range(1, self.n_nodes):
            lanes = active[j]
            nj = int(lanes.sum())
            if nj:
                youngest = int(first_ts[j][lanes].max()) + int(dense_base)
                v[j] = np.float32(youngest - scan_base)
                c[j] = np.float32(nj)
        return v, c

    def slot_to_dense_row(self, v: np.ndarray, c: np.ndarray,
                          scan_base: int, dense_base: int, n_instances: int
                          ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Scan slot rows -> one dense partition row: re-arm
        ``min(count, I)`` instance lanes per node at the youngest start;
        the excess is returned as the row's overflow increment."""
        S, I = self.n_nodes, int(n_instances)
        active = np.zeros((S, I), dtype=bool)
        first_ts = np.zeros((S, I), dtype=np.int32)
        dropped = 0
        for j in range(1, S):
            if v[j] <= NEG / 2:
                continue
            cnt = int(round(float(c[j])))
            if cnt <= 0:
                continue
            youngest = int(round(float(v[j]))) + int(scan_base)
            # rel-0 means "unset" in the dense layout; a start exactly at
            # the dense base clamps forward 1ms, which cannot change any
            # emission (starts are unobservable in the eligible class)
            rel = max(youngest - int(dense_base), 1)
            k = min(cnt, I)
            active[j, :k] = True
            first_ts[j, :k] = np.int32(rel)
            dropped += cnt - k
        return active, first_ts, dropped

    # -- step ----------------------------------------------------------------

    def _filter_matrix(self, env, H, n):
        """[H, n, S+1] boolean; col j = f_j (col 0 placeholder)."""
        ones = torch.ones((H, n), dtype=torch.bool, device=self.device)
        cols = [ones]
        for fs in self.base.filters:
            m = ones
            for c in fs:
                m = m & torch.as_tensor(c.fn(env), device=self.device
                                        ).to(torch.bool).broadcast_to((H, n))
            cols.append(m)
        return torch.stack(cols, dim=2)

    def step(self, state, cols, ts_rel, valid, delta):
        """(state, cols {attr: [H, n]}, ts_rel [H, n] f32, valid [H, n]
        bool, delta f32 scalar) -> (state', emit [H, n] f32 row counts,
        n_rows i32 scalar), all on the device.

        ``delta`` shifts carried live starts for the cycle's rebase on
        the device, so state never round-trips to the host."""
        v, c = state["v"], state["c"]
        live = v > NEG / 2
        live[:, 0] = False  # constant lane stays 0
        v = torch.where(live, v - delta, v)
        H, n = ts_rel.shape
        env = dict(cols)
        env[N_KEY] = n
        F = self._filter_matrix(env, H, n) & valid[:, :, None]
        nv, nc, emit = fused_scan(F.to(torch.float32), ts_rel,
                                  v.contiguous(), c)
        n_rows = emit.sum().to(torch.int32)
        return {"v": nv, "c": nc}, emit, n_rows

    # -- host packing helpers ------------------------------------------------

    def rebase(self, cycle_min_ts: int) -> float:
        """Advance ``base_ts`` to just below the cycle's earliest event;
        returns the f32 delta the step must shift carried live starts by
        (0.0 on the first cycle or when time stands still)."""
        new_base = int(cycle_min_ts) - 1
        if self.base_ts is None:
            self.base_ts = new_base
            return 0.0
        if new_base > self.base_ts:
            delta = float(new_base - self.base_ts)
            self.base_ts = new_base
            return delta
        return 0.0

    def pack_cycle(self, slot_pos, cols: Dict[str, np.ndarray],
                   ts: np.ndarray) -> Tuple[Dict[str, np.ndarray], dict]:
        """Pack per-slot event subsets into the fixed ``[H, n_pad]``
        layout.  ``slot_pos``: {slot: positions into the junction batch
        (ascending)}.  Returns (host arrays for one staged_put, meta for
        the deferred emit).  ``n_pad`` is a power of two, at least 16."""
        H = self.n_slots
        n_max = max(len(p) for p in slot_pos.values())
        n_pad = max(1 << max(n_max - 1, 1).bit_length(), 16)
        min_ts = min(int(ts[p[0]]) for p in slot_pos.values())
        delta = self.rebase(min_ts)
        ts_pad = np.full((H, n_pad), min_ts, dtype=np.int64)
        valid = np.zeros((H, n_pad), dtype=bool)
        packed: Dict[str, np.ndarray] = {}
        lane_dtype = self.base._lane_dtype
        for a, dt in lane_dtype.items():
            if a in cols:
                packed[a] = np.zeros((H, n_pad), dtype=dt)
        for slot, pos in slot_pos.items():
            k = len(pos)
            ts_pad[slot, :k] = ts[pos]
            valid[slot, :k] = True
            for a in packed:
                packed[a][slot, :k] = cols[a][pos].astype(
                    lane_dtype[a], copy=False)
        rel = (ts_pad - self.base_ts).astype(np.float32)
        put = dict(packed)
        put["__ts_rel"] = rel
        put["__valid"] = valid
        put["__delta"] = np.full((), delta, dtype=np.float32)
        meta = {"slot_pos": slot_pos, "n_pad": n_pad}
        return put, meta

    def dispatch(self, state, put_dev: Dict):
        """Run the step on device-resident packed arrays (the router
        stages them through ``staged_put``).  Returns
        (state', emit_dev [H, n_pad], n_rows_dev scalar)."""
        ts_rel = put_dev.pop("__ts_rel")
        valid = put_dev.pop("__valid")
        delta = put_dev.pop("__delta")
        return self.step(state, put_dev, ts_rel, valid, delta)


def scan_state_from_numpy(engine: HotKeyScanEngine, host_state: Dict,
                          base_ts: Optional[int]) -> Dict[str, torch.Tensor]:
    """The reference scan engine's ``{"v", "c"}`` state (``[H, S]``
    float32 each, as numpy) and its ``base_ts`` → tensors on the engine's
    device.  Sets ``engine.base_ts``."""
    want = (engine.n_slots, engine.n_nodes)
    state = {}
    for k in ("v", "c"):
        a = np.asarray(host_state[k])
        if a.shape != want or a.dtype != np.float32:
            raise ValueError(f"scan state '{k}' is {a.dtype}{list(a.shape)}, "
                             f"the engine expects float32{list(want)}")
        state[k] = torch.from_numpy(np.array(a)).to(engine.device)
    engine.base_ts = None if base_ts is None else int(base_ts)
    return state


def scan_state_to_numpy(engine: HotKeyScanEngine, state: Dict
                        ) -> Tuple[Dict[str, np.ndarray], Optional[int]]:
    """Inverse of :func:`scan_state_from_numpy`."""
    v, c = fetch_coalesced([state["v"], state["c"]])
    return {"v": v, "c": c}, engine.base_ts
