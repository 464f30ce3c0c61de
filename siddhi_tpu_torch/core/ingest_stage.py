"""Ingest-side staging: host-to-device puts and the count-gate window.

Port of the JAX package's ``core/ingest_stage.py``:

- ``staged_put``: the one ingest-path transfer.  It puts a pytree of
  numpy arrays (tuples, lists and dicts of them) onto a device as torch
  tensors, and counts one put into ``stats`` when given.  Under
  ``@app:faults`` the ``ingest.put`` site is checked before the copy
  starts, with the emit drain's bounded retry, so a retried put never
  shares a buffer with a copy in flight.
- ``IngestStats``: per-runtime staging counters.
- ``step_probe``: the readiness probe of a dispatched step, a
  ``torch.cuda.Event`` recorded after it on the current stream (on the
  CPU, where every op has finished when it returns, always ready).
- ``IngestStage``: a window of ``depth`` entries.  ``submit(probe,
  finish)`` records one dispatched batch whose count gate has not been
  fetched yet; the oldest entry's ``finish`` (fetch the count, enqueue or
  skip the emit) runs once the window holds ``depth`` entries.  Depth 1
  (the default) finishes inline; ``'auto'`` re-derives the depth at
  every submit with the emit queue's ``EmitDepthController``.

State advances at receive time; only the count fetch and the emit
enqueue defer.  Runtimes flush the stage before they drain their emit
queue, so callback content and order do not depend on the depth.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.core.emit_queue import EmitDepthController

log = logging.getLogger("siddhi_tpu_torch")


class IngestStats:
    """Staging counters of one device runtime (host ints)."""

    __slots__ = ("staged_batches", "device_puts", "ingest_stalls",
                 "overlapped_batches", "flush_syncs", "max_staging_depth",
                 "auto_depth")

    def __init__(self):
        self.staged_batches = 0
        self.device_puts = 0
        # non-barrier finishes whose step had (not) finished by then
        self.ingest_stalls = 0
        self.overlapped_batches = 0
        self.flush_syncs = 0
        self.max_staging_depth = 0
        # the window the 'auto' controller runs at (0: a fixed depth)
        self.auto_depth = 0

    def as_dict(self) -> dict:
        """The counters under the reference's statistics names."""
        return {
            "stagedBatches": self.staged_batches,
            "devicePuts": self.device_puts,
            "ingestStalls": self.ingest_stalls,
            "overlappedBatches": self.overlapped_batches,
            "flushSyncs": self.flush_syncs,
            "maxStagingDepth": self.max_staging_depth,
            "autoIngestDepth": self.auto_depth,
        }


def staged_put(x, device, stats: Optional[IngestStats] = None,
               faults=None):
    """Numpy leaves of ``x`` → tensors on ``device`` (structure kept);
    one ``device_puts`` into ``stats`` per call; ``faults``: the
    injector whose ``ingest.put`` site guards the copy."""
    if stats is not None:
        stats.device_puts += 1
    if faults is not None:
        from siddhi_tpu_torch.util.faults import retry_site

        retry_site(faults, "ingest.put", "ingest put")
    return _put(x, device)


def _put(x, device):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if isinstance(x, dict):
        return {k: _put(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_put(v, device) for v in x)
    raise TypeError(f"staged_put: unsupported leaf {type(x).__name__}")


class _Ready:
    """The CPU's probe: a CPU op has finished when it returns."""

    @staticmethod
    def is_ready() -> bool:
        return True


class _EventProbe:
    __slots__ = ("event",)

    def __init__(self, event):
        self.event = event

    def is_ready(self) -> bool:
        return self.event.query()


def step_probe(device):
    """A probe of every op enqueued so far on ``device``: ``is_ready()``
    is True once they have finished."""
    if torch.device(device).type != "cuda":
        return _Ready
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return _EventProbe(event)


class IngestStage:
    """Bounded FIFO of dispatched batches whose count gate is pending."""

    def __init__(self, depth=1, stats: IngestStats = None,
                 on_fault: Optional[Callable] = None):
        self.controller: Optional[EmitDepthController] = None
        if depth == "auto":
            self.controller = EmitDepthController()
            depth = 1
        self.depth = max(1, int(depth))
        self.stats = stats or IngestStats()
        # the owning runtime's isolation hook: a failing finish is
        # logged and routed there (None: it raises)
        self.on_fault = on_fault
        self._entries: List[Tuple[object, Callable, object]] = []

    def __len__(self) -> int:
        return len(self._entries)

    def submit(self, probe, finish: Callable, trace=None):
        """Stage one dispatched batch; finish the oldest entries past the
        window.  ``probe`` (``step_probe``, None when the batch put no
        work on the device) tells an overlapped finish from a stall.
        ``trace``: the batch's sampled cycle token, whose ingest span
        ends here (conversion, put and step dispatch are queued)."""
        if self.controller is not None:
            self.controller.note_push()
            self.depth = self.controller.effective_depth
            self.stats.auto_depth = self.depth
        self.stats.staged_batches += 1
        if trace is not None:
            trace.dispatched()
        self._entries.append((probe, finish, trace))
        self.stats.max_staging_depth = max(self.stats.max_staging_depth,
                                           len(self._entries))
        while len(self._entries) >= self.depth:
            self._finish_oldest(barrier=False)

    def flush(self):
        """Barrier: finish every staged batch in submit order."""
        while self._entries:
            self.stats.flush_syncs += 1
            self._finish_oldest(barrier=True)

    def _finish_oldest(self, barrier: bool):
        probe, finish, trace = self._entries.pop(0)
        # a step already done when its count is fetched overlapped the
        # host's staging of the next batch; else the host stalls on it.
        # A barrier's finish says nothing of the steady state.
        if probe is not None and not barrier:
            if probe.is_ready():
                self.stats.overlapped_batches += 1
            else:
                self.stats.ingest_stalls += 1
        # the controller's round-trip sample: the finish is the blocking
        # count fetch when the batch had device work
        t0 = (time.monotonic()
              if self.controller is not None and probe is not None
              else None)
        try:
            finish()
        except Exception as err:
            if self.on_fault is None:
                raise
            log.error("ingest finish failed; dropping one staged "
                      "batch's emit: %s", err)
            if trace is not None:
                trace.aborted("step")
            self.on_fault(err)
            return
        if t0 is not None:
            self.controller.note_drain(time.monotonic() - t0)
