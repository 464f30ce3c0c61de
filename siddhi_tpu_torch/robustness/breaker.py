"""Circuit breakers for sinks and sources.

Classic closed/open/half-open state machine riding on top of
``ConnectRetryMixin``'s failure signals:

- **closed**    — traffic flows; ``breaker.threshold`` consecutive
  failures open the breaker (firing the ``breaker.open`` fault site).
- **open**      — no publish/connect attempts; sink output spools to a
  BOUNDED buffer (the batches were already counted by the output
  ledger at junction dispatch, so a replay never re-delivers them and
  the flush-on-close never double-emits).  After ``breaker.cooldown``
  the next caller becomes the half-open probe.
- **half-open** — exactly one probe in flight; success closes the
  breaker (the owner flushes its spool), failure re-opens it for
  another cooldown.

The breaker itself is transport-agnostic: ``Sink`` and
``ConnectRetryMixin`` consult ``allow()`` and report
``record_success``/``record_failure``; all transitions are counted on
:class:`~siddhi_tpu_torch.robustness.RobustnessStats`.
"""

from __future__ import annotations

import threading
import time

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    def __init__(self, name: str, threshold: int, cooldown_ms: int,
                 stats=None, fault_injector=None, clock=time.monotonic):
        self.name = name
        self.threshold = int(threshold)
        self.cooldown_ms = int(cooldown_ms)
        self.stats = stats
        self.fault_injector = fault_injector
        self.clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._open_until = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def is_open(self) -> bool:
        return self.state == OPEN

    def allow(self) -> bool:
        """May the caller attempt a publish/connect right now?"""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN and self.clock() >= self._open_until:
                self._state = HALF_OPEN
                self._probing = True
                if self.stats is not None:
                    self.stats.breaker_half_opens += 1
                return True
            if self._state == HALF_OPEN and not self._probing:
                self._probing = True
                return True
            if self.stats is not None:
                self.stats.breaker_short_circuits += 1
            return False

    def record_success(self) -> bool:
        """Returns True when this success CLOSED the breaker — the
        caller should flush anything it spooled while open."""
        with self._lock:
            was = self._state
            self._state = CLOSED
            self._failures = 0
            self._probing = False
            if was != CLOSED:
                if self.stats is not None:
                    self.stats.breaker_closes += 1
                return True
            return False

    def record_failure(self):
        opened = False
        with self._lock:
            self._probing = False
            self._failures += 1
            if self._state == HALF_OPEN or \
                    self._failures >= self.threshold:
                if self._state != OPEN:
                    opened = True
                    if self.stats is not None:
                        self.stats.breaker_opens += 1
                self._state = OPEN
                self._open_until = self.clock() + self.cooldown_ms / 1000.0
                self._failures = 0
        if opened and self.fault_injector is not None:
            # choke point: chaos runs fault/crash the engine at the
            # exact open transition
            self.fault_injector.check("breaker.open")

    def describe(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "state": self._state,
                "threshold": self.threshold,
                "cooldown_ms": self.cooldown_ms,
                "consecutive_failures": self._failures,
            }
