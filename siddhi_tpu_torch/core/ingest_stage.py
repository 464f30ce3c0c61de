"""Ingest-side staging: host-to-device puts and the count-gate window.

Port of the JAX package's ``core/ingest_stage.py``:

- ``staged_put``: the one ingest-path transfer.  It puts a pytree of
  numpy arrays (tuples, lists and dicts of them) onto a device as torch
  tensors, and counts one put into ``stats`` when given.
- ``IngestStats``: per-runtime staging counters.
- ``IngestStage``: a window of a fixed integer depth.  ``submit(finish)``
  records one dispatched batch whose count gate has not been
  fetched yet; the oldest entry's ``finish`` (fetch the count, enqueue or
  skip the emit) runs once the window holds ``depth`` entries.  Depth 1
  (the default) finishes inline.  The reference's ``ingest.depth='auto'``
  controller is a later slice of the port.

State advances at receive time; only the count fetch and the emit
enqueue defer.  Runtimes flush the stage before they drain their emit
queue, so callback content and order do not depend on the depth.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch


class IngestStats:
    """Staging counters of one device runtime (host ints)."""

    __slots__ = ("staged_batches", "device_puts", "flush_syncs",
                 "max_staging_depth")

    def __init__(self):
        self.staged_batches = 0
        self.device_puts = 0
        self.flush_syncs = 0
        self.max_staging_depth = 0


def staged_put(x, device, stats: Optional[IngestStats] = None):
    """Numpy leaves of ``x`` → tensors on ``device`` (structure kept);
    one ``device_puts`` into ``stats`` per call."""
    if stats is not None:
        stats.device_puts += 1
    return _put(x, device)


def _put(x, device):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if isinstance(x, dict):
        return {k: _put(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_put(v, device) for v in x)
    raise TypeError(f"staged_put: unsupported leaf {type(x).__name__}")


class IngestStage:
    """Bounded FIFO of dispatched batches whose count gate is pending."""

    def __init__(self, depth: int = 1, stats: IngestStats = None):
        if isinstance(depth, str):
            raise ValueError(
                f"ingest stage depth {depth!r}: the port takes a positive "
                "integer; ingest.depth='auto' is a later slice of the port")
        self.depth = max(1, int(depth))
        self.stats = stats or IngestStats()
        self._entries: List[Callable] = []

    def __len__(self) -> int:
        return len(self._entries)

    def submit(self, finish: Callable):
        """Stage one dispatched batch; finish the oldest entries past the
        window.  (The reference also takes a device scalar to count
        overlapped batches; the port keeps no such counter.)"""
        self.stats.staged_batches += 1
        self._entries.append(finish)
        self.stats.max_staging_depth = max(self.stats.max_staging_depth,
                                           len(self._entries))
        while len(self._entries) >= self.depth:
            self._entries.pop(0)()

    def flush(self):
        """Barrier: finish every staged batch in submit order."""
        while self._entries:
            self.stats.flush_syncs += 1
            self._entries.pop(0)()
