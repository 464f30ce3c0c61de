"""Linear-chain NFA as a max-plus scan: one hot key's events in parallel.

Port of the JAX package's ``ops/nfa_scan.py``: ``NEG``, the chain walk
``_chain_nodes`` and the ``ScanPatternEngine`` (chain validation, filter
compilation, lane dtypes, the filter check; ``init_state``,
``make_scan``/``process``) with ``compile_scan_pattern``.  The hot-key
scan (``ops/hotkey_scan.py``) builds on the constructor.

Algebra: lane ``j`` of a state vector ``v`` holds the start timestamp of
the YOUNGEST partial match that has consumed pattern events ``1..j``
(``NEG`` = none pending); lane 0 is the constant lane that carries event
timestamps into the algebra.  Each event is an ``S x S`` max-plus matrix
over {0, NEG, ts}: advancing from node ``j-1`` needs filter ``f_j``, an
instance leaves its node when it advances, and an ``every`` head arms a
fresh start per matching event.  For an ``every``-headed linear chain
whose filters read only the current event, same-node instances are
interchangeable, so this abstraction is exact.  ``within`` prunes only
at emission: a chain whose completion lies within W of its start was
within W at every event before it.

The reference composes the matrices with ``jax.lax.associative_scan``;
the port with a doubling (Hillis-Steele) prefix scan in torch ops, in
chunks whose ``[c, S, S, S]`` products fit a fixed budget, carrying the
state vector from chunk to chunk.  No Pallas kernel stands behind
either.  Live lanes and starts are bit-exact in any composition order
(every live entry is one timestamp plus zeros); dead lanes stay at or
below ``NEG / 2``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.core.emit_queue import fetch_coalesced
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.core.ingest_stage import staged_put
from siddhi_tpu_torch.planner.expr import N_KEY, ExpressionCompiler, Scope
from siddhi_tpu_torch.query_api import (
    AttrType,
    EveryStateElement,
    NextStateElement,
    SingleInputStream,
    StateInputStream,
    StreamStateElement,
)

NEG = -1e30  # −inf stand-in (float32-safe)


def _chain_nodes(st: StateInputStream) -> Tuple[List, bool]:
    """Flatten ``every a=S[...] -> b=S[...] -> ...`` into its
    StreamStateElements; raises outside the linear-chain subset."""
    nodes: List[StreamStateElement] = []
    every_head = False

    def walk(el, at_head):
        nonlocal every_head
        if isinstance(el, NextStateElement):
            walk(el.element, at_head)
            walk(el.next, False)
            return
        if isinstance(el, EveryStateElement):
            if not at_head or nodes:
                raise SiddhiAppCreationError(
                    "scan NFA: only a leading 'every' is supported")
            every_head = True
            walk(el.element, False)
            return
        if isinstance(el, StreamStateElement):
            nodes.append(el)
            return
        raise SiddhiAppCreationError(
            f"scan NFA: unsupported state element {type(el).__name__} "
            "(linear chains only — counts/logical/absent need the dense "
            "or host engine)")

    walk(st.state, True)
    if len(nodes) < 2:
        raise SiddhiAppCreationError("scan NFA: chain needs >= 2 nodes")
    return nodes, every_head


class ScanPatternEngine:
    """One hot key's linear pattern chain as a max-plus prefix scan.

    Usage::

        eng = compile_scan_pattern(app_str, "q", device="cpu")
        state = eng.init_state()            # [S] start-ts vector
        state, idx, starts = eng.process(state, cols, ts)
        # idx: indices of events that completed a match (detections)

    ``filters[j]`` is the list of compiled filters of node ``j`` (all
    must hold); ``_lane_dtype`` maps each attribute a filter may read to
    the dtype its device lane carries (INT int32, other numeric and BOOL
    float32; LONG has no scan lane).  ``device``: the state's and the
    scan's (the CPU when None; the hot-key engine validates through the
    constructor alone)."""

    # bytes of one chunk's [c, S, S, S] composition: the chunk length is
    # the largest power of two within this budget
    SCAN_BYTES = {"cuda": 256 << 20, "cpu": 32 << 20}

    def __init__(self, st: StateInputStream, stream_def, device=None):
        self.device = torch.device("cpu" if device is None else device)
        nodes, self.every_head = _chain_nodes(st)
        if not self.every_head:
            raise SiddhiAppCreationError(
                "scan NFA: a non-'every' head arms exactly once, which "
                "is history-dependent — use the dense/host engines")
        self.within_ms = st.within_ms  # None = unbounded
        self.n_nodes = len(nodes)
        if self.n_nodes > 32:
            raise SiddhiAppCreationError("scan NFA: > 32 chain nodes")

        sid = nodes[0].stream.stream_id
        for nd in nodes:
            if nd.stream.stream_id != sid:
                raise SiddhiAppCreationError(
                    "scan NFA: one hot stream only (multi-stream chains "
                    "need the dense engine)")
        self.stream_id = sid
        self.stream_def = stream_def

        # filters see ONLY the current event (capture references would
        # break same-node interchangeability — the exactness contract)
        scope = Scope()
        for a in stream_def.attributes:
            scope.add(sid, a.name, a.name, a.type)
        compiler = ExpressionCompiler(scope)
        self.filters = []
        for nd in nodes:
            s = nd.stream
            if not isinstance(s, SingleInputStream):
                raise SiddhiAppCreationError("scan NFA: plain stream nodes")
            exprs = [h.expression for h in s.handlers
                     if type(h).__name__ == "Filter"]
            if len(exprs) != len(s.handlers):
                raise SiddhiAppCreationError(
                    "scan NFA: only filters on chain nodes")
            compiled = [compiler.compile(e) for e in exprs]
            for c in compiled:
                if c.type != AttrType.BOOL:
                    raise SiddhiAppCreationError(
                        "scan NFA: filters must be boolean")
            self.filters.append(compiled)

        self._lane_dtype: Dict[str, np.dtype] = {
            a.name: (np.dtype(np.int32) if a.type == AttrType.INT
                     else np.dtype(np.float32))
            for a in stream_def.attributes
            if (a.type.is_numeric or a.type == AttrType.BOOL)
            and a.type != AttrType.LONG
        }
        self.base_ts: Optional[int] = None
        self._trace_check()

    # S = n_nodes: lanes 0..S-1 — lane 0 constant, lanes 1..S-1 the
    # youngest start having consumed nodes 1..j.  The final node S
    # completes at emission and never occupies a lane.

    def _trace_check(self):
        """Evaluate every filter once on a tiny CPU env of the scan's lane
        columns (the reference traces them abstractly); a filter that
        reads anything else raises the reference's reason."""
        B = 8
        # NO timestamp key: a filter reading eventTimestamp() would see
        # base-rebased relative float32 time here, silently diverging
        # from the host engine — its KeyError rejects it instead
        env = {a: torch.zeros(B, dtype=_TORCH_DTYPES[dt])
               for a, dt in self._lane_dtype.items()}
        env[N_KEY] = B
        try:
            for fs in self.filters:
                for c in fs:
                    c.fn(env)
        except Exception as e:
            raise SiddhiAppCreationError(
                f"scan NFA: filter not device-evaluable (timestamp "
                f"functions / host-only ops need the dense or host "
                f"engine): {e}") from e


    def init_state(self) -> torch.Tensor:
        v = torch.full((self.n_nodes,), NEG, dtype=torch.float32,
                       device=self.device)
        v[0] = 0.0  # constant lane
        return v

    def _filter_matrix(self, env, n: int) -> torch.Tensor:
        """[n, S+1] bool: col j = f_j for each event (col 0 unused)."""
        ones = torch.ones(n, dtype=torch.bool, device=self.device)
        cols = [ones]
        for fs in self.filters:
            m = ones
            for c in fs:
                m = m & torch.as_tensor(c.fn(env), device=self.device
                                        ).to(torch.bool).broadcast_to((n,))
            cols.append(m)
        return torch.stack(cols, dim=1)

    def _chunk_len(self) -> int:
        S = self.n_nodes
        budget = self.SCAN_BYTES.get(self.device.type, 32 << 20)
        per_event = 2 * 4 * S * S * S  # the product and the concat
        return 1 << max(budget // per_event, 1).bit_length() - 1

    def make_scan(self):
        """``scan(state [S] f32, cols {attr: [n]}, ts [n] f32 relative) ->
        (state', match [n] bool, start [n] f32)``, torch ops on the
        engine's device."""
        S = self.n_nodes
        W = self.within_ms
        chunk = self._chunk_len()

        def prefix(M):
            # inclusive prefix products P_i = M_i (x) ... (x) M_1 in
            # log2(c) doubling rounds; (b (x) a)[r, c] = max_k b[r, k] +
            # a[k, c] applies a, then b
            d, n = 1, M.shape[0]
            while d < n:
                M = torch.cat([M[:d], torch.amax(
                    M[d:, :, :, None] + M[:-d, None, :, :], dim=2)])
                d *= 2
            return M

        def scan(v0, cols, ts):
            n = ts.shape[0]
            env = dict(cols)  # no TS_KEY: _trace_check rejected ts use
            env[N_KEY] = n
            F = self._filter_matrix(env, n)  # [n, S+1]
            neg = torch.full((), NEG, dtype=torch.float32, device=self.device)
            zero = torch.zeros((), dtype=torch.float32, device=self.device)
            M = torch.full((n, S, S), NEG, dtype=torch.float32,
                           device=self.device)
            M[:, 0, 0] = 0.0  # the constant lane persists
            M[:, 1, 0] = torch.where(F[:, 1], ts, neg)  # 'every' arms
            for j in range(1, S):
                # a chain at lane j leaves it by consuming event j+1
                # (j+1 == S completes)
                M[:, j, j] = torch.where(F[:, j + 1], neg, zero)
                if j + 1 < S:
                    M[:, j + 1, j] = torch.where(F[:, j + 1], zero, neg)
            afters = []
            v = v0
            for lo in range(0, n, chunk):
                P = prefix(M[lo:lo + chunk])
                after = torch.amax(P + v[None, None, :], dim=-1)  # [c, S]
                afters.append(after)
                v = after[-1]
            after = torch.cat(afters)
            before = torch.cat([v0[None, :], after[:-1]])
            # completion: event i passes f_S with a chain at lane S-1
            start = before[:, S - 1]
            match = F[:, S] & (start > NEG / 2)
            if W is not None:
                match = match & (start > ts - W)
            return v, match, start

        return scan

    def process(self, state, cols: Dict[str, np.ndarray], ts: np.ndarray):
        """Host entry: ``(state, match_event_indices, match_starts_ms)``.

        The base is rebased every batch so relative times stay small
        (float32 is millisecond-exact below about 4.7 h): carried live
        starts shift by the float32 delta, as in the reference, on the
        device.  One put of the batch, one fetch of the match mask and
        the starts."""
        ts = np.asarray(ts, dtype=np.int64)
        n = len(ts)
        if n == 0:
            return state, np.empty(0, np.int64), np.empty(0, np.int64)
        new_base = int(ts[0]) - 1
        if self.base_ts is None:
            self.base_ts = new_base
        elif new_base > self.base_ts:
            delta = np.float32(new_base - self.base_ts)
            live = state > NEG / 2
            live[0] = False  # the constant lane stays 0
            state = torch.where(live, state - float(delta), state)
            self.base_ts = new_base
        rel = (ts - self.base_ts).astype(np.float32)
        host = {a: np.ascontiguousarray(
                    np.asarray(cols[a])[:n].astype(dt, copy=False))
                for a, dt in self._lane_dtype.items() if a in cols}
        dev_cols, rel_d = staged_put((host, rel), self.device)
        scan = self.make_scan()
        state, match, start = scan(state, dev_cols, rel_d)
        match_h, start_h = fetch_coalesced([match, start])
        idx = np.flatnonzero(match_h)
        starts = start_h[idx].astype(np.int64) + self.base_ts
        return state, idx, starts


def compile_scan_pattern(app_str: str, query_name: Optional[str] = None,
                         device=None) -> ScanPatternEngine:
    """Compile a SiddhiQL linear pattern into a ScanPatternEngine on
    ``device`` (``cuda`` when None; raises without a card)."""
    from siddhi_tpu_torch.compiler import SiddhiCompiler
    from siddhi_tpu_torch.ops.dense_nfa import resolve_device
    from siddhi_tpu_torch.query_api.annotation import find_annotation

    dev = resolve_device(device)
    app = SiddhiCompiler.parse(app_str)
    query = None
    for i, q in enumerate(app.queries):
        info = find_annotation(q.annotations, "info")
        nm = (info.element("name") if info else None) or f"query_{i}"
        if query_name is None or nm == query_name:
            query = q
            break
    if query is None:
        raise SiddhiAppCreationError(f"query '{query_name}' not found")
    st = query.input_stream
    if not isinstance(st, StateInputStream):
        raise SiddhiAppCreationError("compile_scan_pattern needs a pattern")
    nodes, _ = _chain_nodes(st)
    d = app.stream_definitions.get(nodes[0].stream.stream_id)
    if d is None:
        raise SiddhiAppCreationError("pattern stream is not defined")
    return ScanPatternEngine(st, d, device=dev)


_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32}
