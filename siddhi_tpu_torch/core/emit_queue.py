"""Count-gated device-to-host emits.

Port of the JAX package's ``core/emit_queue.py``:

- ``fetch_coalesced``: the port's single device-to-host path.
  ``np.asarray`` raises on a CUDA tensor, so every materializer of the
  port, and every host read of device state, goes through here.
- ``EmitStats``: per-runtime transfer counters.
- ``PendingEmit``: one junction batch whose match outputs are still on
  the device, with the materializer that turns the fetched host arrays
  into the batch's emit.
- ``EmitDepthController``: the adaptive depth of ``emit.depth='auto'``
  (and ``ingest.depth='auto'``), from decaying averages of the batch
  cadence and the drain round trip.
- ``EmitQueue``: a FIFO of pending emits; when it holds ``depth``
  entries, all of them drain with one coalesced fetch.  Depth 1 (the
  default) drains right after each batch; ``'auto'`` re-derives the
  depth at every push.

Entries drain strictly FIFO and each materializes into exactly the batch
the synchronous path would emit, so callback content and order do not
depend on the depth.  A failing materializer (a selector, limiter or
callback downstream of the emit) is isolated as in the reference: its
one pending batch is dropped and logged, and the rest of the drain goes
on.  Under ``@app:faults`` the fetch sits behind the ``emit.drain``
site with a bounded retry and backoff on transient faults
(``drains_recovered``); a fetch that still fails drops that drain's
batches (``drains_failed``) and goes to the runtime's ``on_fault``
hook, so the runtime survives.  A sampled cycle token (``trace``)
closes its emit span when its entry has materialized.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
                 "max_pending_depth", "auto_depth")

    def __init__(self):
        self.emit_transfers = 0
        self.deferred_batches = 0
        self.zero_match_skips = 0
        self.max_pending_depth = 0
        # the depth the 'auto' controller runs at (0: a fixed depth)
        self.auto_depth = 0

    def as_dict(self) -> dict:
        """The counters under the reference's statistics names."""
        return {
            "emitTransfers": self.emit_transfers,
            "deferredBatches": self.deferred_batches,
            "zeroMatchSkips": self.zero_match_skips,
            "maxPendingDepth": self.max_pending_depth,
            "autoEffectiveDepth": self.auto_depth,
        }


class PendingEmit:
    """One deferred batch: device tensors plus ``materialize(host)``,
    which receives them fetched, in the same order, and emits;
    ``trace``: the batch's sampled cycle token, or None."""

    __slots__ = ("arrays", "materialize", "trace")

    def __init__(self, arrays: Sequence, materialize: Callable, trace=None):
        self.arrays = list(arrays)
        self.materialize = materialize
        self.trace = trace


class EmitDepthController:
    """Adaptive depth for ``'auto'``: the number of batches that arrive
    during one drain round trip.  Decaying averages (newest sample's
    weight ``ALPHA``) of the gap between pushes (``note_push``) and of
    the fetch time (``note_drain``) give

        effective_depth = clamp(ceil(rtt_ema / gap_ema), 1, AUTO_DEPTH_MAX)

    after every sample; ``AUTO_DEPTH_MAX`` bounds the window as a
    written depth would."""

    AUTO_DEPTH_MAX = 32
    ALPHA = 0.2

    __slots__ = ("_gap_ema", "_rtt_ema", "_last_push", "effective_depth")

    def __init__(self):
        self._gap_ema: Optional[float] = None
        self._rtt_ema: Optional[float] = None
        self._last_push: Optional[float] = None
        self.effective_depth = 1

    def _ema(self, old: Optional[float], sample: float) -> float:
        if old is None:
            return sample
        return old + self.ALPHA * (sample - old)

    def note_push(self, t: Optional[float] = None):
        """One queued batch at ``t`` (monotonic seconds; the clock when
        None)."""
        if t is None:
            t = time.monotonic()
        if self._last_push is not None:
            self._gap_ema = self._ema(self._gap_ema, t - self._last_push)
        self._last_push = t
        self._recompute()

    def note_drain(self, seconds: float):
        """The fetch time of one drain."""
        self._rtt_ema = self._ema(self._rtt_ema, seconds)
        self._recompute()

    def _recompute(self):
        if not self._gap_ema or self._rtt_ema is None:
            return  # no cadence yet: keep the current depth
        depth = math.ceil(self._rtt_ema / self._gap_ema)
        self.effective_depth = max(1, min(depth, self.AUTO_DEPTH_MAX))


class EmitQueue:
    """Bounded FIFO of pending emits, drained with one coalesced fetch.
    ``depth`` is a positive integer or ``'auto'`` (an
    ``EmitDepthController`` sets it at every push)."""

    def __init__(self, depth=1, stats: EmitStats = None, faults=None,
                 on_fault: Optional[Callable] = None):
        self.controller: Optional[EmitDepthController] = None
        if depth == "auto":
            self.controller = EmitDepthController()
            depth = 1
        self.depth = max(1, int(depth))
        self.stats = stats or EmitStats()
        # @app:faults: the emit.drain site and the retry knobs; on_fault
        # is the owning runtime's isolation hook
        self.faults = faults
        self.on_fault = on_fault
        self._entries: List[PendingEmit] = []

    def __len__(self) -> int:
        return len(self._entries)

    def push(self, entry: PendingEmit):
        if self.controller is not None:
            self.controller.note_push()
            self.depth = self.controller.effective_depth
            self.stats.auto_depth = self.depth
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

    def _fetch(self, arrays: Sequence) -> List[np.ndarray]:
        """``fetch_coalesced`` behind the ``emit.drain`` site, transient
        faults retried with backoff (``util/faults.retry_site``)."""
        if self.faults is not None:
            from siddhi_tpu_torch.util.faults import retry_site

            retry_site(self.faults, "emit.drain", "emit drain")
        return fetch_coalesced(arrays)

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
            had_device = any(isinstance(a, torch.Tensor) for a in arrays)
            # the controller samples the fetch only when it crossed from
            # the device
            t0 = (time.monotonic()
                  if self.controller is not None and had_device else None)
            # one fetch serves every entry of the round: their emit spans
            # share its start
            t_fetch = time.perf_counter()
            try:
                host = self._fetch(arrays)
            except Exception as err:
                if self.faults is None:
                    raise
                self.faults.stats.drains_failed += 1
                log.error("emit drain failed; dropping %d pending "
                          "batch(es): %s", len(entries), err)
                for e in entries:
                    if e.trace is not None:
                        e.trace.aborted("emit")
                if self.on_fault is not None:
                    self.on_fault(err)
                continue
            if t0 is not None:
                self.controller.note_drain(time.monotonic() - t0)
            if had_device:
                self.stats.emit_transfers += 1
            off = 0
            for e in entries:
                n = len(e.arrays)
                seg = host[off:off + n]
                off += n
                try:
                    e.materialize(seg)
                except Exception as err:
                    if self.faults is not None:
                        self.faults.stats.callback_faults_isolated += 1
                    log.error("emit materialize failed; dropping one "
                              "pending batch: %s", err, exc_info=err)
                    if e.trace is not None:
                        e.trace.aborted("emit")
                    if self.on_fault is not None:
                        self.on_fault(err)
                    continue
                if e.trace is not None:
                    e.trace.emitted(t_fetch)
