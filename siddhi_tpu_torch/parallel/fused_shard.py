"""Fused chains sharded over the device mesh: fuse and shard composed.

Port of the JAX package's ``parallel/fused_shard.py``.  For all-filter
chains (stateless per-row stages, no dense tail) fusion and mesh
sharding compose exactly: each row's output depends only on that row's
lanes, so splitting the batch axis over the mesh gives the
single-device chain's outputs, and the emit path already orders rows by
their batch position.

Stateful stages (running, sliding, dense tails) do not compose this
way: their state update order couples rows across the batch, and the
shard layouts of ``device_shard.py`` have no fused formulation.  The
cost model lists those compositions as infeasible with their reason,
and the fusion planner falls back to the single-device fused engine
with a counted ``shardedFallbackReason``.

``ShardedFusedGraphEngine`` is a subclass of the fused engine: the
runtime and the deferred emit read its stages, outputs and snapshots
directly, and filter stages hold empty state dicts, so the one seam is
``_batch``: the padded batch (a multiple of the shard count) is cut
into one block a shard, each block goes to its shard's device in one
``staged_put`` and runs the chain there, and each block's outputs are
one emit chunk with its own count, in shard order.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.core.ingest_stage import staged_put
from siddhi_tpu_torch.ops.device_query import _pow2
from siddhi_tpu_torch.ops.fused_graph import FusedGraphEngine


class ShardedFusedGraphEngine(FusedGraphEngine):
    """An all-filter fused chain with its batch axis split over an
    N-shard mesh."""

    #: span label of the cycle tracer (a single-device chain's is
    #: 'fused'; sharded dispatches must be told apart)
    engine_kind = "fused_shard"

    def __init__(self, stages: List, mesh, axis_name: str = "p"):
        for eng in stages:
            if eng.kind != "filter":
                raise SiddhiAppCreationError(
                    f"fuse+shard covers all-filter chains (stateless "
                    f"elementwise stages); stage kind '{eng.kind}' "
                    "couples rows through window state — single-device "
                    "fused engine used")
        super().__init__(stages, None, None)
        self.mesh = list(mesh)
        self.axis_name = axis_name
        self.n_shards = len(self.mesh)

    def _pad_batch(self, n: int) -> int:
        B = _pow2(n)
        if B % self.n_shards:
            B = -(-B // self.n_shards) * self.n_shards
        return B

    def _batch(self, states: Tuple, cols: Dict[str, np.ndarray],
               ts: np.ndarray) -> Tuple[Tuple, List[dict]]:
        n = len(ts)
        B = self._pad_batch(n)
        b = B // self.n_shards
        states, (c, rels, grp, valid) = self._host_batch(states, cols, ts, B)
        if self.faults is not None:
            self.faults.check("step.device")
        chunks = []
        for s, dev in enumerate(self.mesh):
            lo = s * b
            n_s = min(max(n - lo, 0), b)
            if n_s == 0:
                continue  # a block of padding rows only
            blk = slice(lo, lo + b)
            cd, rd, gd, vd = staged_put(
                ({k: v[blk] for k, v in c.items()},
                 tuple(r[blk] for r in rels), grp[blk], valid[blk]),
                dev, self.ingest_stats, self.faults)
            res = self.step(states, cd, rd, gd, vd, n_s)
            chunks.append(self._chunk(res, n_s, ts[lo:lo + n_s]))
        return tuple(states), chunks
