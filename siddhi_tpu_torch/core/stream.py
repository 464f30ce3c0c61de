"""Stream junctions, input handlers and user callbacks.

Port of the synchronous part of the JAX package's ``core/stream.py``.  A
``StreamJunction`` hands each batch sent on a stream to its receivers
(the planned queries), then to its user callbacks (``StreamCallback``,
or a function wrapped in ``FunctionStreamCallback``) as row ``Event``s.
A ``QueryCallback`` receives a query's output as ``(timestamp,
in_events, out_events)``.  An ``InputHandler`` turns user sends into
batches: every ``send`` is one junction cycle, as in the reference,
taken under the app lock after the app scheduler has advanced to the
clock (due window, rate-limit, deadline and purge tasks fire before the
batch's events step).  The reference's asynchronous junctions, fault
streams, admission control and input journal are later slices of the
port; an error in a receiver or callback propagates.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from siddhi_tpu_torch.core.event import (
    Event,
    EventBatch,
    batch_from_events,
    events_from_batch,
)
from siddhi_tpu_torch.core.exceptions import SiddhiAppRuntimeError


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


class StreamJunction:
    """Fan-out point of one stream."""

    def __init__(self, definition):
        self.definition = definition
        self.stream_id = definition.id
        self.receivers: List = []
        self.callbacks: List[StreamCallback] = []

    def subscribe(self, receiver):
        """``receiver.receive(batch)`` runs on every batch sent here."""
        self.receivers.append(receiver)

    def add_callback(self, callback: StreamCallback):
        callback.stream_id = self.stream_id
        self.callbacks.append(callback)

    def send(self, batch: EventBatch):
        if len(batch) == 0:
            return
        for r in self.receivers:
            r.receive(batch)
        for cb in self.callbacks:
            cb.receive_batch(batch)


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

    def _dispatch(self, batch: EventBatch):
        """Advance the scheduler to the clock, then the junction cycle,
        both under the app lock."""
        ctx = self.app_context
        with ctx.process_lock:
            ctx.scheduler.advance(ctx.timestamp_generator.current_time())
            self.junction.send(batch)

