"""Stream junctions, input handlers and user callbacks.

Port of the JAX package's ``core/stream.py``.  A
``StreamJunction`` hands each batch sent on a stream to its receivers
(the planned queries), then to its user callbacks (``StreamCallback``,
or a function wrapped in ``FunctionStreamCallback``) as row ``Event``s.
A ``QueryCallback`` receives a query's output as ``(timestamp,
in_events, out_events)``.  An ``InputHandler`` turns user sends into
batches: every ``send`` is one junction cycle, as in the reference,
taken under the app lock after the app scheduler has advanced to the
clock (due window, rate-limit, deadline and purge tasks fire before the
batch's events step).  An error in a receiver (a query) or a callback
is isolated, in the reference's LOG form: it is logged and handed to the
app's exception listeners, and the later receivers and callbacks still
get the batch.  Under ``@app:faults(journal=)`` the input handler
records every batch in the app's input journal under the app lock, then
gives the ``ingest`` fault site its check, and each junction hands its
callbacks the batch through the journal's output ledger, which during a
restore-and-replay suppresses the events they already received.

An ``@async(buffer.size, batch.size.max)`` junction queues each send in
a ring of ``buffer.size`` batches (a producer waits for room) and a
worker thread dispatches the oldest queued batches, coalesced up to
``batch.size.max`` events, as one cycle under the app lock; during a
journal replay a send dispatches inline.  ``stop`` never waits for room
and dispatches what is still queued (the reference drops it), oldest
first, ahead of any send made after it.  Under
``@OnError(action='STREAM')`` a junction has a fault junction ``!name``
(the stream's attributes and ``_error``): a failing receiver or callback
sends the batch there with the error and calls no listener
(``route_fault``, which a sink's publish failure takes too).

The operations layer rides along: under ``@app:limits(rate=)`` the
input handler trims each batch to its stream's token budget before it
is journaled (a replay bypasses admission); every journaled ingest and
every dispatch beats the app's ``ProgressBeat`` for the watchdog; the
``callback`` fault site guards each callback; a junction's
``throughput_tracker`` (``@app:statistics``) counts what it is sent.
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import Callable, List, Optional

import numpy as np

from siddhi_tpu_torch.core.event import (
    Event,
    EventBatch,
    batch_from_events,
    events_from_batch,
)
from siddhi_tpu_torch.core.exceptions import (
    OnErrorAction,
    SiddhiAppRuntimeError,
)

log = logging.getLogger("siddhi_tpu_torch")


class StreamCallback:
    """User subscriber on a stream (reference:
    stream/output/StreamCallback.java).  Subclass and override
    ``receive``, or wrap a plain function in ``FunctionStreamCallback``."""

    stream_id: Optional[str] = None

    def receive(self, events: List[Event]):
        raise NotImplementedError

    def receive_batch(self, batch: EventBatch):
        """Columnar entry; the default converts to row events."""
        self.receive(events_from_batch(batch))


class FunctionStreamCallback(StreamCallback):
    def __init__(self, fn: Callable[[List[Event]], None]):
        self.fn = fn

    def receive(self, events: List[Event]):
        self.fn(events)


class QueryCallback:
    """Per-query subscriber receiving ``(timestamp, current, expired)``
    (reference: query/output/callback/QueryCallback)."""

    def receive(self, timestamp: int, in_events: Optional[List[Event]],
                out_events: Optional[List[Event]]):
        raise NotImplementedError


class FunctionQueryCallback(QueryCallback):
    def __init__(self, fn):
        self.fn = fn

    def receive(self, timestamp, in_events, out_events):
        self.fn(timestamp, in_events, out_events)


def notify_listeners(app_context, e: Exception):
    """Hand a logged error to the app's exception listeners; a failing
    listener is logged and does not stop the others."""
    for listener in list(getattr(app_context, "exception_listeners", ())):
        try:
            listener(e)
        except Exception:
            log.exception("exception listener failed")


class StreamJunction:
    """Fan-out point of one stream; ``is_async``: the reference's
    ``@async`` queue and coalescing worker; ``on_error`` and
    ``fault_junction``: the ``@OnError`` action and the ``!name``
    junction of its STREAM form."""

    def __init__(self, definition, app_context=None, is_async: bool = False,
                 buffer_size: int = 1024,
                 batch_size_max: Optional[int] = None,
                 on_error: str = OnErrorAction.LOG,
                 fault_junction: Optional["StreamJunction"] = None):
        self.definition = definition
        self.on_error = on_error
        self.fault_junction = fault_junction
        self.stream_id = definition.id
        self.app_context = app_context
        self.receivers: List = []
        self.callbacks: List[StreamCallback] = []
        self.is_async = is_async
        self.buffer_size = buffer_size
        self.batch_size_max = batch_size_max or buffer_size
        self._ring: collections.deque = collections.deque()
        self._cond = (threading.Condition(app_context.process_lock)
                      if is_async else None)
        self._worker: Optional[threading.Thread] = None
        self._running = False
        # a worker killed by a BaseException (a simulated crash): what
        # the ring holds died with it, as in the reference
        self._worker_died = False
        # dispatch cycles through this junction: a fused chain keeps its
        # intermediate streams at 0
        self.dispatches = 0
        # @app:statistics: the stream's throughput tracker (None: off)
        self.throughput_tracker = None

    def subscribe(self, receiver):
        """``receiver.receive(batch)`` runs on every batch sent here."""
        self.receivers.append(receiver)

    def add_callback(self, callback: StreamCallback):
        callback.stream_id = self.stream_id
        self.callbacks.append(callback)

    # -- lifecycle (async junctions) -----------------------------------------

    def start(self):
        if not self.is_async or self._worker is not None:
            return
        self._running = True
        self._worker = threading.Thread(
            target=self._drain, name=f"junction-{self.stream_id}",
            daemon=True)
        self._worker.start()

    def pending(self) -> int:
        """Batches queued in the ring (the watchdog's pending work)."""
        return len(self._ring)

    def fill(self) -> float:
        """The ring's fill fraction in [0, 1] (the ladder's pressure)."""
        return min(len(self._ring) / self.buffer_size, 1.0) \
            if self.is_async and self.buffer_size > 0 else 0.0

    def abandon(self):
        """Stop the worker without waiting for it and drop what the ring
        holds: a live re-plan replays every batch from the input
        journal, so the old engines need not see them.  Safe under the
        app lock."""
        if self._worker is None:
            return
        with self._cond:
            self._running = False
            self._ring.clear()
            self._cond.notify_all()
        self._worker = None

    def stop(self):
        """Stop the worker after its current dispatch, then dispatch what
        is still queued; never waits for room in the ring, and must not
        be called under the app lock (the worker needs it to finish)."""
        if self._worker is None:
            return
        with self._cond:
            self._running = False
            self._cond.notify_all()
        self._worker.join(timeout=5)
        self._worker = None
        with self._cond:
            if self._worker_died:
                if self._ring:
                    log.warning(
                        "junction '%s': worker died; %d queued batch(es) "
                        "dropped", self.stream_id, len(self._ring))
                self._ring.clear()
                return
            self._flush_ring()

    # -- send paths ------------------------------------------------------------

    def send(self, batch: EventBatch):
        if len(batch) == 0:
            return
        if self.throughput_tracker is not None:
            self.throughput_tracker.add(len(batch))
        if self.is_async and self._running:
            jr = getattr(self.app_context, "input_journal", None)
            if jr is None or not jr.replaying:
                with self._cond:
                    while (self._running
                           and len(self._ring) >= self.buffer_size):
                        self._cond.wait()
                    if self._running:
                        self._ring.append(batch)
                        self._cond.notify_all()
                        return
                    # stopped while this send waited: what the ring
                    # still holds is older, so it goes first
                    self._flush_ring()
                    self._dispatch(batch)
                    return
            # a journal replay runs single-threaded under the app lock:
            # inline, so every re-delivery crosses the suppressing ledger
            # inside the replay window
        elif self._ring:
            # after stop's flag, before its flush: keep the send order
            with self._cond:
                self._flush_ring()
        self._dispatch(batch)

    def _flush_ring(self):
        """Dispatch every queued batch, oldest first, under the app lock
        (the worker is stopped or parked waiting for the lock)."""
        while self._ring:
            self._dispatch(self._ring.popleft())
            self._cond.notify_all()

    def _drain(self):
        """Worker: take the oldest queued batch and those behind it up to
        ``batch_size_max`` events, dispatch them as one cycle, all under
        the app lock."""
        try:
            self._drain_loop()
        except BaseException:
            self._worker_died = True
            raise

    def _drain_loop(self):
        while True:
            with self._cond:
                while self._running and not self._ring:
                    self._cond.wait()
                if not self._running:
                    return
                batches = [self._ring.popleft()]
                total = len(batches[0])
                while self._ring and total < self.batch_size_max:
                    batches.append(self._ring.popleft())
                    total += len(batches[-1])
                self._cond.notify_all()
                self._dispatch(EventBatch.concat(batches))

    def _dispatch(self, batch: EventBatch):
        self.dispatches += 1
        # the watchdog's liveness beat, one a dispatched batch
        progress = getattr(self.app_context, "progress", None)
        if progress is not None:
            progress.beat()
        for r in self.receivers:
            try:
                r.receive(batch)
            except Exception as e:
                self._handle_error(batch, e)
        if not self.callbacks:
            return
        # crash-recovery output ledger: the receivers always reprocess
        # during a replay (they rebuild state), but the callbacks get
        # the prefix they already received suppressed
        jr = getattr(self.app_context, "input_journal", None)
        if jr is not None:
            batch = jr.deliver(("stream", self.stream_id), batch)
            if batch is None:
                return
        fi = getattr(self.app_context, "fault_injector", None)
        for cb in self.callbacks:
            try:
                if fi is not None:
                    fi.check("callback")
                cb.receive_batch(batch)
            except Exception as e:
                self._handle_error(batch, e)

    def route_fault(self, batch: EventBatch, e: Exception) -> bool:
        """Send ``batch`` with the error in ``_error`` into this stream's
        ``!name`` fault junction (``@OnError(action='STREAM')``); False
        when the stream has no STREAM route.  Taken by a failing
        receiver or callback and by a sink's publish failure."""
        if (self.on_error != OnErrorAction.STREAM
                or self.fault_junction is None):
            return False
        fd = self.fault_junction.definition
        err = np.empty(len(batch), dtype=object)
        err[:] = e
        cols = dict(batch.columns)
        cols["_error"] = err
        self.fault_junction.send(EventBatch(
            fd.id, fd.attribute_names, cols, batch.timestamps, batch.types))
        return True

    def _handle_error(self, batch: EventBatch, e: Exception):
        """``@OnError``: the STREAM form routes the batch to the fault
        junction; the LOG form logs the error, then hands it to the
        app's exception listeners."""
        if self.route_fault(batch, e):
            return
        name = getattr(self.app_context, "name", None)
        log.error("error processing events on stream '%s' in app '%s': %s",
                  self.stream_id, name, e, exc_info=e)
        notify_listeners(self.app_context, e)


class InputHandler:
    """External event entry for one stream: single events, rows, or
    whole ``EventBatch``es; stamps timestamps from the app clock when
    absent."""

    def __init__(self, junction: StreamJunction, app_context, is_running):
        self.junction = junction
        self.app_context = app_context
        self.definition = junction.definition
        self._is_running = is_running

    def _check_running(self):
        if not self._is_running():
            raise SiddhiAppRuntimeError(
                f"Siddhi app '{self.app_context.name}' is not running, "
                "cannot send events")

    def send(self, data, timestamp: Optional[int] = None):
        """One event (``Event`` or a row of values), or a list of
        ``Event``s, as one junction cycle."""
        self._check_running()
        tsgen = self.app_context.timestamp_generator
        if isinstance(data, Event):
            events = [data]
        elif isinstance(data, list) and data and isinstance(data[0], Event):
            events = data
        else:
            ts = timestamp if timestamp is not None else tsgen.current_time()
            events = [Event(ts, list(data))]
        for e in events:
            if e.timestamp < 0:
                e.timestamp = tsgen.current_time()
            tsgen.set_event_time(e.timestamp)
        self._dispatch(batch_from_events(self.definition, events))

    def send_batch(self, batch: EventBatch):
        """A whole columnar batch as one junction cycle."""
        self._check_running()
        if len(batch):
            self.app_context.timestamp_generator.set_event_time(
                int(batch.timestamps.max()))
        self._dispatch(batch)

    def _admit(self, batch: EventBatch) -> Optional[EventBatch]:
        """``@app:limits(rate=)``: the batch trimmed to the stream's token
        budget before it is journaled, so a replay sees only what was
        admitted (and bypasses admission itself); None when all of it
        was shed."""
        ac = getattr(self.app_context, "admission", None)
        if ac is None:
            return batch
        jr = self.app_context.input_journal
        if jr is not None and jr.replaying:
            return batch
        return ac.admit(self.junction.stream_id, batch)

    def _dispatch(self, batch: EventBatch):
        """Admit, then journal the batch and give the ``ingest`` fault
        site its check, then advance the scheduler to the clock and run
        the junction cycle, all under the app lock.  A crash injected at
        ``ingest`` fires after the record: the batch is in the journal
        but never delivered, the state replay exists to repair."""
        batch = self._admit(batch)
        if batch is None:
            return
        ctx = self.app_context
        with ctx.process_lock:
            if ctx.input_journal is not None:
                ctx.input_journal.record(self.junction.stream_id, batch)
            ctx.progress.beat()
            if ctx.fault_injector is not None:
                ctx.fault_injector.check("ingest")
            ctx.scheduler.advance(ctx.timestamp_generator.current_time())
            self.junction.send(batch)

