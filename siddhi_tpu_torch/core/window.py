"""Named windows: ``define window W (...) <fn>(...) output <type> events``.

Port of the JAX package's ``core/window.py`` (the reference's
``core/window/Window.java:65``): a shared
window processor owned by the app, fed by ``insert into W`` queries
(InsertIntoWindowCallback analog), publishing its CURRENT/EXPIRED flow to
a junction that ``from W`` queries subscribe to, and probe-able by joins
and on-demand queries (the FindableProcessor contract).
"""

from __future__ import annotations

from typing import Dict, Optional

from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.query import OutputCallback


class NamedWindowRuntime:
    def __init__(self, definition, window, junction, app_context):
        self.definition = definition
        self.window_id = definition.id
        self.window = window
        self.junction = junction
        self.app_context = app_context
        # reference default: ALL events (WindowDefinition.java:40 —
        # queries reading the window see CURRENT + EXPIRED so windowed
        # aggregates can retract on expiry)
        self.output_event_type = definition.output_event_type or "all"

    # -- ingestion (insert into W) ------------------------------------------

    def add(self, batch: EventBatch, now: int):
        wout = self.window.process(batch, now)
        self._publish(wout)

    def _publish(self, wout: Optional[EventBatch]):
        if wout is None or len(wout) == 0:
            return
        if self.output_event_type == "current":
            out = wout.only(ev.CURRENT)
        elif self.output_event_type == "expired":
            out = wout.only(ev.EXPIRED)
        else:
            out = wout.only(ev.CURRENT, ev.EXPIRED)
        if len(out) == 0:
            return
        out.stream_id = self.junction.stream_id
        self.junction.send(out)

    # -- findable contract (joins / on-demand probes) -----------------------

    def buffered(self) -> Optional[EventBatch]:
        return self.window.buffered()

    def rows_batch(self) -> Optional[EventBatch]:
        return self.window.buffered()

    # -- scheduler task contract -------------------------------------------

    def next_wakeup(self) -> Optional[int]:
        return self.window.next_wakeup()

    def fire(self, now: int):
        self._publish(self.window.on_time(now))

    # -- snapshot contract --------------------------------------------------

    def snapshot(self) -> Dict:
        return self.window.snapshot()

    def restore(self, state: Dict):
        self.window.restore(state)


class InsertIntoWindowCallback(OutputCallback):
    """Routes query output into a named window (reference:
    InsertIntoWindowCallback.java).  Output must cover the window's
    schema by name (validated at plan time, like the table path)."""

    def __init__(
        self,
        window_runtime: NamedWindowRuntime,
        event_type: str,
        output_names: Optional[list] = None,
    ):
        self.window_runtime = window_runtime
        self.event_type = event_type
        if output_names is not None:
            from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError

            missing = [
                a.name
                for a in window_runtime.definition.attributes
                if a.name not in output_names
            ]
            if missing:
                raise SiddhiAppCreationError(
                    f"insert into window '{window_runtime.window_id}': output "
                    f"is missing window attribute(s) {missing}"
                )

    def send(self, batch: EventBatch, now: int):
        if self.event_type == "current":
            out = batch.only(ev.CURRENT)
        elif self.event_type == "expired":
            out = batch.only(ev.EXPIRED)
        else:
            out = batch.only(ev.CURRENT, ev.EXPIRED)
        if len(out) == 0:
            return
        wdef = self.window_runtime.definition
        if out.attribute_names != wdef.attribute_names:
            out = EventBatch(
                self.window_runtime.window_id,
                wdef.attribute_names,
                {nm: out.columns[nm] for nm in wdef.attribute_names},
                out.timestamps,
                out.types,
            )
        out = out.with_types(ev.CURRENT)
        self.window_runtime.add(out, now)
