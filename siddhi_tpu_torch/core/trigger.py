"""Triggers: ``define trigger T at ('start' | every <t> | '<cron>')``.

Port of ``TriggerRuntime`` of the JAX package's ``core/trigger.py`` (the
reference's PeriodicTrigger, CronTrigger and StartTrigger without
Quartz): periodic and cron triggers are scheduler tasks computing their
next fire time, the cron through ``util/cron.py``; each fire posts one
event ``[triggered_time]`` into the trigger's stream junction.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.util.cron import CronSchedule

__all__ = ["CronSchedule", "TriggerRuntime"]


class TriggerRuntime:
    """Scheduler task injecting timer events into the trigger stream
    (reference: trigger/PeriodicTrigger.java, CronTrigger.java,
    StartTrigger.java)."""

    def __init__(self, definition, junction, app_context):
        self.definition = definition
        self.junction = junction
        self.app_context = app_context
        self._next: Optional[int] = None
        self._cron = CronSchedule(definition.at_cron) if definition.at_cron else None

    def on_start(self, now: int):
        if self.definition.at_start:
            self._send(now)
        if self.definition.at_every_ms is not None:
            self._next = now + self.definition.at_every_ms
        elif self._cron is not None:
            self._next = self._cron.next_fire(now)

    def next_wakeup(self) -> Optional[int]:
        return self._next

    def fire(self, now: int):
        while self._next is not None and self._next <= now:
            fire_at = self._next
            if self.definition.at_every_ms is not None:
                self._next = fire_at + self.definition.at_every_ms
            elif self._cron is not None:
                self._next = self._cron.next_fire(fire_at)
            else:
                self._next = None
            self._send(fire_at)

    def _send(self, ts: int):
        batch = EventBatch(
            self.junction.stream_id,
            ["triggered_time"],
            {"triggered_time": np.asarray([ts], dtype=np.int64)},
            np.asarray([ts], dtype=np.int64),
        )
        self.junction.send(batch)
