"""Source SPI: external-transport receivers feeding a stream.

Port of the JAX package's ``transport/source.py``.

Re-design of the reference ``stream/input/source/`` (Source.java:50 —
lifecycle init/connect-with-retry/pause/resume/disconnect,
SourceMapper.java payload -> Event mapping, InMemorySource.java): a
source owns a transport connection and pushes mapped events into its
stream's junction.  Pausing (used while a snapshot is taken) buffers
incoming payloads and replays them on resume.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List

from siddhi_tpu_torch.core.event import Event
from siddhi_tpu_torch.extension.registry import extension
from siddhi_tpu_torch.transport.broker import InMemoryBroker, Subscriber
from siddhi_tpu_torch.transport.retry import ConnectRetryMixin

log = logging.getLogger(__name__)


class SourceMapper:
    """payload -> List[Event] (reference: SourceMapper.java)."""

    def init(self, definition, options: Dict[str, str]):
        self.definition = definition
        self.options = options

    def map(self, payload) -> List[Event]:
        raise NotImplementedError


@extension("source_mapper", "passThrough")
class PassThroughSourceMapper(SourceMapper):
    """Payload already is an Event / row / list thereof
    (reference: PassThroughSourceMapper.java)."""

    def map(self, payload) -> List[Event]:
        if isinstance(payload, Event):
            return [payload]
        if isinstance(payload, (list, tuple)):
            if payload and isinstance(payload[0], Event):
                return list(payload)
            return [Event(data=list(payload))]
        raise ValueError(f"passThrough mapper: cannot map {type(payload).__name__}")


@extension("source_mapper", "json")
class JsonSourceMapper(SourceMapper):
    """JSON object / array of objects -> events by attribute name.

    A stdlib stand-in for the reference's siddhi-map-json extension; the
    optional ``enclosing.element`` option selects a nested list/object.
    """

    def map(self, payload) -> List[Event]:
        import json

        obj = json.loads(payload) if isinstance(payload, (str, bytes)) else payload
        enclosing = self.options.get("enclosing.element")
        if enclosing:
            obj = obj[enclosing]
        rows = obj if isinstance(obj, list) else [obj]
        names = self.definition.attribute_names
        return [Event(data=[r.get(nm) for nm in names]) for r in rows]


class Source(ConnectRetryMixin):
    """Transport receiver SPI (reference: Source.java:50).

    Subclasses implement connect / disconnect and call ``self.deliver``
    with raw payloads.
    """

    def init(self, definition, options: Dict[str, str], mapper: SourceMapper,
             junction, app_context):
        self.definition = definition
        self.options = options
        self.mapper = mapper
        self.junction = junction
        self.app_context = app_context
        self.connected = False
        # @app:faults harness: arms the source.connect injection site
        self._fault_injector = getattr(app_context, "fault_injector", None)
        self._fault_site_connect = "source.connect"
        self._paused = False
        self._pause_buffer: List = []
        self._lock = threading.Lock()
        self._init_retry(options)

    # -- SPI ---------------------------------------------------------------

    def connect(self):
        raise NotImplementedError

    def disconnect(self):
        pass

    # -- lifecycle ---------------------------------------------------------
    # start/_connect_with_retry/_retry_connect come from ConnectRetryMixin

    def pause(self):
        self._paused = True

    def resume(self):
        # drain the pause buffer BEFORE lifting the pause: payloads arriving
        # mid-replay keep buffering behind the older ones, preserving order
        while True:
            with self._lock:
                if not self._pause_buffer:
                    self._paused = False
                    return
                buffered, self._pause_buffer = self._pause_buffer, []
            for p in buffered:
                events = self.mapper.map(p)
                if events:
                    self._send_events(events)

    def shutdown(self):
        self._shutdown_retry()
        if self.connected:
            self.disconnect()
            # the retry thread writes `connected` under _retry_lock;
            # the main-path clear takes the same lock
            with self._retry_lock:
                self.connected = False

    # -- delivery ----------------------------------------------------------

    def deliver(self, payload):
        """Transport thread entry: map and push into the junction."""
        with self._lock:
            if self._paused:
                self._pause_buffer.append(payload)
                return
        events = self.mapper.map(payload)
        if events:
            self._send_events(events)

    def _send_events(self, events: List[Event]):
        from siddhi_tpu_torch.core.stream import InputHandler

        hook = getattr(self, "handler", None)
        if hook is not None:
            events = hook.on_events(events)
            if not events:
                return
        handler = getattr(self, "_handler", None)
        if handler is None:
            # ``is_running``: set by the app runtime (its running gate)
            handler = self._handler = InputHandler(
                self.junction, self.app_context,
                getattr(self, "is_running", lambda: True))
        handler.send(events)


@extension("source", "inMemory")
class InMemorySource(Source):
    """Subscribes its stream to an InMemoryBroker topic
    (reference: InMemorySource.java — topic validated at init, so a
    missing option fails app creation, not the retry loop)."""

    def init(self, definition, options, mapper, junction, app_context):
        super().init(definition, options, mapper, junction, app_context)
        if options.get("topic") is None:
            from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError

            raise SiddhiAppCreationError(
                f"inMemory source on '{definition.id}': 'topic' option required"
            )

    def connect(self):
        topic = self.options.get("topic")
        src = self

        class _Sub(Subscriber):
            def on_message(self, message):
                src.deliver(message)

            def get_topic(self) -> str:
                return topic

        self._subscriber = _Sub()
        InMemoryBroker.subscribe(self._subscriber)

    def disconnect(self):
        sub = getattr(self, "_subscriber", None)
        if sub is not None:
            InMemoryBroker.unsubscribe(sub)
