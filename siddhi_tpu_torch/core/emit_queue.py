"""Count-gated device-to-host emits.

Port of the JAX package's ``core/emit_queue.py``:

- ``fetch_coalesced``: the port's single device-to-host path.
  ``np.asarray`` raises on a CUDA tensor, so every materializer of the
  port, and every host read of device state, goes through here.
- ``EmitStats``: per-runtime transfer counters.
- ``PendingEmit``: one junction batch whose match outputs are still on
  the device, with the materializer that turns the fetched host arrays
  into the batch's emit.
- ``EmitQueue``: a FIFO of pending emits of a fixed integer depth; when
  it holds ``depth`` entries, all of them drain with one coalesced fetch.
  Depth 1 (the default) drains right after each batch.  The reference's
  ``emit.depth='auto'`` controller is a later slice of the port.

Entries drain strictly FIFO and each materializes into exactly the batch
the synchronous path would emit, so callback content and order do not
depend on the depth.  A failing materializer (a selector, limiter or
callback downstream of the emit) is isolated as in the reference: its
one pending batch is dropped and logged, and the rest of the drain goes
on.  A failed fetch is a device error and raises; the reference's fault
harness, which counts and routes such failures, is a later slice.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

log = logging.getLogger("siddhi_tpu_torch")


def fetch_coalesced(arrays: Sequence) -> List[np.ndarray]:
    """One device-to-host copy per group of tensors.

    Tensors are grouped by (device, dtype, trailing shape); each group is
    concatenated on the device (0-d tensors are stacked), copied with
    one ``.cpu()``, and split back in input order.  Host values pass
    through ``np.asarray``.
    """
    out: List[np.ndarray] = [None] * len(arrays)
    groups: Dict[Tuple, List[int]] = {}
    for i, a in enumerate(arrays):
        if not isinstance(a, torch.Tensor):
            out[i] = np.asarray(a)
            continue
        groups.setdefault((a.device, a.dtype, tuple(a.shape[1:]), a.dim() == 0),
                          []).append(i)
    for (_dev, _dtype, _trail, scalar), idxs in groups.items():
        members = [arrays[i] for i in idxs]
        joined = torch.stack(members) if scalar else torch.cat(members)
        host = joined.cpu().numpy()
        if scalar:
            for k, i in enumerate(idxs):
                out[i] = host[k]
            continue
        start = 0
        for i in idxs:
            n = arrays[i].shape[0]
            out[i] = host[start:start + n]
            start += n
    return out


class EmitStats:
    """Transfer counters of one device runtime (host ints)."""

    __slots__ = ("emit_transfers", "deferred_batches", "zero_match_skips",
                 "max_pending_depth")

    def __init__(self):
        self.emit_transfers = 0
        self.deferred_batches = 0
        self.zero_match_skips = 0
        self.max_pending_depth = 0


class PendingEmit:
    """One deferred batch: device tensors plus ``materialize(host)``,
    which receives them fetched, in the same order, and emits."""

    __slots__ = ("arrays", "materialize")

    def __init__(self, arrays: Sequence, materialize: Callable):
        self.arrays = list(arrays)
        self.materialize = materialize


class EmitQueue:
    """Bounded FIFO of pending emits, drained with one coalesced fetch."""

    def __init__(self, depth: int = 1, stats: EmitStats = None):
        if isinstance(depth, str):
            raise ValueError(
                f"emit queue depth {depth!r}: the port takes a positive "
                "integer; emit.depth='auto' is a later slice of the port")
        self.depth = max(1, int(depth))
        self.stats = stats or EmitStats()
        self._entries: List[PendingEmit] = []

    def __len__(self) -> int:
        return len(self._entries)

    def push(self, entry: PendingEmit):
        self._entries.append(entry)
        self.stats.max_pending_depth = max(self.stats.max_pending_depth,
                                           len(self._entries))
        if len(self._entries) >= self.depth:
            self.drain()
        else:
            self.stats.deferred_batches += 1

    def skip(self):
        """Record a zero-match batch that transferred nothing."""
        self.stats.zero_match_skips += 1

    def drain(self):
        """Flush barrier: materialize every pending entry in FIFO order
        after one coalesced fetch.  Pushes made by a materializer land in
        a fresh list and drain after the current entries, the order the
        synchronous path gives."""
        while self._entries:
            entries, self._entries = self._entries, []
            arrays: List = []
            for e in entries:
                arrays.extend(e.arrays)
            host = fetch_coalesced(arrays)
            if any(isinstance(a, torch.Tensor) for a in arrays):
                self.stats.emit_transfers += 1
            off = 0
            for e in entries:
                n = len(e.arrays)
                seg = host[off:off + n]
                off += n
                try:
                    e.materialize(seg)
                except Exception as err:
                    log.error("emit materialize failed; dropping one "
                              "pending batch: %s", err, exc_info=err)
