"""Manager-level registry of open multiplex groups.

Port of the JAX package's ``multiplex/registry.py``.

One ``MultiplexRegistry`` lives per ``SiddhiManager`` (lazily created on
``SiddhiContext.multiplex_registry`` by the planner), because grouping
is CROSS-APP: distinct SiddhiApps created under one manager contribute
tenants to the same shared engines.  Holding it on the manager context
— like ``input_journals`` — also keeps groups alive across a single
app's crash/restore cycle, so the surviving tenants keep flowing.

Groups are keyed by structural fingerprint (``fingerprint.py``).  A
fingerprint maps to a LIST of groups: when every seat of the open
groups is taken, a fresh overflow group is spun up rather than
refusing the tenant.  Seats free on tenant shutdown; a group whose
last seat frees is dropped so its device state can be collected.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple


class MultiplexRegistry:
    """fingerprint -> open groups with free tenant slots."""

    def __init__(self):
        self._lock = threading.Lock()
        self._groups: Dict[str, List[object]] = {}
        # lifetime counters, surfaced by bench / tests
        self.groups_created = 0
        self.seats_placed = 0

    def acquire(self, fingerprint: str, factory: Callable[[], object]) -> Tuple[object, int]:
        """Seat a tenant in an open group for ``fingerprint``.

        Tries each existing group's ``try_alloc_seat()``; when all are
        full (or none exist) builds a fresh group via ``factory`` and
        seats the tenant there.  Returns ``(group, slot)``.
        """
        with self._lock:
            bucket = self._groups.setdefault(fingerprint, [])
            for group in bucket:
                slot = group.try_alloc_seat()
                if slot is not None:
                    self.seats_placed += 1
                    return group, slot
            group = factory()
            group.fingerprint = fingerprint
            slot = group.try_alloc_seat()
            if slot is None:  # a factory-built group always has a seat
                raise RuntimeError("multiplex: fresh group has no free seat")
            bucket.append(group)
            self.groups_created += 1
            self.seats_placed += 1
            return group, slot

    def release(self, group, slot: int) -> None:
        """Free ``slot`` of ``group``; drop the group once empty."""
        with self._lock:
            group.free_seat(slot)
            if group.occupied_count() == 0:
                bucket = self._groups.get(getattr(group, "fingerprint", ""), [])
                if group in bucket:
                    bucket.remove(group)

    def open_groups(self) -> List[object]:
        with self._lock:
            return [g for bucket in self._groups.values() for g in bucket]


def registry_for(siddhi_context) -> MultiplexRegistry:
    """The manager context's registry, created on first use."""
    reg: Optional[MultiplexRegistry] = getattr(siddhi_context, "multiplex_registry", None)
    if reg is None:
        reg = MultiplexRegistry()
        siddhi_context.multiplex_registry = reg
    return reg
