"""Linear-chain NFA as a max-plus scan: chain checks and filters.

Port of the JAX package's ``ops/nfa_scan.py`` for what the hot-key scan
(``ops/hotkey_scan.py``) builds on: ``NEG``, the chain walk
``_chain_nodes`` and the ``ScanPatternEngine`` constructor (chain
validation, filter compilation, lane dtypes, the filter check).  The
reference's single-key ``make_scan``/``process``/``compile_scan_pattern``
are a later slice of the port.

Algebra: lane ``j`` of a state vector ``v`` holds the start timestamp of
the YOUNGEST partial match that has consumed pattern events ``1..j``
(``NEG`` = none pending); lane 0 is the constant lane that carries event
timestamps into the algebra.  Each event is an ``S x S`` max-plus matrix
over {0, NEG, ts}: advancing from node ``j-1`` needs filter ``f_j``, an
instance leaves its node when it advances, and an ``every`` head arms a
fresh start per matching event.  For an ``every``-headed linear chain
whose filters read only the current event, same-node instances are
interchangeable, so this abstraction is exact.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
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
    """One linear pattern chain's validated nodes and compiled filters.

    ``filters[j]`` is the list of compiled filters of node ``j`` (all
    must hold); ``_lane_dtype`` maps each attribute a filter may read to
    the dtype its device lane carries (INT int32, other numeric and BOOL
    float32; LONG has no scan lane)."""

    def __init__(self, st: StateInputStream, stream_def):
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
        self._trace_check()

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


_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32}
