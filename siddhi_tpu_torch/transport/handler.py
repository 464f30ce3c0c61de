"""Source/Sink handler SPI: interception hooks on the transport path.

Port of the JAX package's ``transport/handler.py``.

Re-design of the reference HA interception points
(``stream/input/source/SourceHandler.java:35`` — events pass through the
handler between transport and junction; ``stream/output/sink/
SinkHandler.java:34`` — events pass through before mapping/publishing;
``SourceHandlerManager``/``SinkHandlerManager`` generate one handler per
source/sink and track them by element id).  Handlers see event lists at
micro-batch granularity and may filter, annotate, or buffer them.
"""

from __future__ import annotations

from typing import Dict, List

from siddhi_tpu_torch.core.event import Event


class SourceHandler:
    """Intercepts inbound events between transport and stream junction.
    Override ``on_events``; return the (possibly modified) list."""

    def init(self, app_name: str, stream_id: str):
        self.app_name = app_name
        self.stream_id = stream_id

    def on_events(self, events: List[Event]) -> List[Event]:
        return events


class SinkHandler:
    """Intercepts outbound events before the sink mapper.  Override
    ``on_events``; return the (possibly modified) list."""

    def init(self, app_name: str, stream_id: str):
        self.app_name = app_name
        self.stream_id = stream_id

    def on_events(self, events: List[Event]) -> List[Event]:
        return events


class _HandlerManager:
    def __init__(self):
        self.handlers: Dict[str, object] = {}
        self._seq = 0

    def _register(self, base_id: str, handler) -> str:
        # unique element ids: a stream may carry several @source/@sink
        # annotations, each with its own live handler (the reference
        # tracks by generated element id)
        self._seq += 1
        element_id = f"{base_id}#{self._seq}"
        self.handlers[element_id] = handler
        handler.element_id = element_id  # lets the runtime unregister it
        return element_id

    def unregister(self, element_id: str):
        self.handlers.pop(element_id, None)


class SourceHandlerManager(_HandlerManager):
    """reference: stream/input/source/SourceHandlerManager.java"""

    def generate_source_handler(self) -> SourceHandler:
        return SourceHandler()

    def generate(self, app_name: str, stream_id: str) -> SourceHandler:
        h = self.generate_source_handler()
        h.init(app_name, stream_id)
        self._register(f"{app_name}:{stream_id}", h)
        return h


class SinkHandlerManager(_HandlerManager):
    """reference: stream/output/sink/SinkHandlerManager.java"""

    def generate_sink_handler(self) -> SinkHandler:
        return SinkHandler()

    def generate(self, app_name: str, stream_id: str) -> SinkHandler:
        h = self.generate_sink_handler()
        h.init(app_name, stream_id)
        self._register(f"{app_name}:{stream_id}", h)
        return h


class RecordTableHandlerManager(_HandlerManager):
    """reference: table/record/RecordTableHandlerManager.java"""

    def generate_record_table_handler(self):
        from siddhi_tpu_torch.table.record import RecordTableHandler

        return RecordTableHandler()

    def generate(self, app_name: str, table_id: str):
        h = self.generate_record_table_handler()
        # identity so one manager's handler can route by table
        # (the reference passes elementId into RecordTableHandler)
        h.app_name = app_name
        h.table_id = table_id
        self._register(f"{app_name}:{table_id}", h)
        return h
