"""Overload protection and self-healing.

The engine's defense-in-depth against sustained overload, threaded
through the existing runtime (nothing here runs unless ``@app:limits``
is present — without the annotation behavior is bit-identical):

- ``admission``  — per-stream token-bucket budgets at ``InputHandler``
  ingest with counted, policy-driven shedding (``drop``/``oldest``/
  ``block``); under ``@app:multiplex`` each tenant app carries its own
  budget, so per-app limits ARE per-tenant/seat backpressure.
- ``watchdog``   — a daemon thread that detects stalled batch cycles
  (no ingest→dispatch progress within a deadline while work is
  pending) and wedged emit drains, freezes a FlightRecorder dump, and
  self-heals by restore-and-replay over the ``runtime.replan``
  machinery — bit-identical recovery, refused loudly without a
  journal.
- ``breaker``    — closed/open/half-open circuit breakers on sinks and
  sources atop ``ConnectRetryMixin``; while open, sink output spools
  to a bounded buffer behind the output ledger so nothing double-emits
  on close.
- ``ladder``     — the unified degradation ladder: under sustained
  pressure, demote lowerings in documented order (kernels→general step,
  devtable→host, fused→junction) via counted ``replan`` passes,
  re-promoting under hysteresis.

Every decision is counted on ``RobustnessStats`` (surfaced on the
statistics feed and ``GET /siddhi-health/<app>``) and choke-pointed
through the ``util/faults.py`` sites ``admission.shed``,
``watchdog.trip`` and ``breaker.open``.
"""

from __future__ import annotations


class RobustnessStats:
    """Counters for every overload-protection decision.

    Owned by the hot paths (admission controller, breakers, watchdog,
    ladder); the statistics layer wraps this object in a thin gauge
    (``StatisticsManager.robustness_tracker``) so metric assembly reads
    the same integers the health endpoint reports — the two can never
    disagree.
    """

    __slots__ = (
        # admission
        "events_admitted",
        "events_shed",
        "shed_drop",
        "shed_oldest",
        "shed_block_timeout",
        "block_waits",
        "block_wait_ms",
        # circuit breakers
        "breaker_opens",
        "breaker_half_opens",
        "breaker_closes",
        "breaker_short_circuits",
        "breaker_spooled_batches",
        "breaker_spool_dropped",
        "breaker_flushed_batches",
        # watchdog
        "watchdog_ticks",
        "watchdog_trips",
        "watchdog_near_misses",
        "watchdog_recoveries",
        "watchdog_recovery_failures",
        # degradation ladder
        "ladder_demotions",
        "ladder_promotions",
    )

    def __init__(self):
        for name in self.__slots__:
            setattr(self, name, 0)

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name in self.__slots__}


from siddhi_tpu_torch.robustness.admission import (  # noqa: E402
    AdmissionController,
    TokenBucket,
)
from siddhi_tpu_torch.robustness.breaker import CircuitBreaker  # noqa: E402
from siddhi_tpu_torch.robustness.ladder import (  # noqa: E402
    DEMOTE_ORDER,
    DegradationLadder,
    apply_degradation,
)
from siddhi_tpu_torch.robustness.watchdog import Watchdog  # noqa: E402

__all__ = [
    "AdmissionController",
    "CircuitBreaker",
    "DEMOTE_ORDER",
    "DegradationLadder",
    "RobustnessStats",
    "TokenBucket",
    "Watchdog",
    "apply_degradation",
]
