"""Watchdog: stall detection and self-healing restore-and-replay.

A per-app daemon thread (PlanMonitor-style lifecycle) that watches the
app's progress beat — a counter every junction dispatch and journaled
ingest bumps — against the pending-work gauges (async junction queues,
staged ingest windows, pending emit drains).  Liveness contract:

- **progress**  — the beat advanced since the last tick: healthy.
- **near-miss** — work is pending and the beat is older than half the
  deadline: counted once per episode, feeds the degradation ladder.
- **stall**     — work is pending and the beat is older than the full
  deadline (a wedged batch cycle or emit drain): the watchdog fires
  the ``watchdog.trip`` fault site, freezes a FlightRecorder dump
  (``tracer.dump('watchdog-trip')``), and self-heals by forcing
  ``runtime.replan`` with the current pins — pause, rebuild the whole
  engine set (fresh junction workers replace any wedged ones), and
  replay the journal's full history through the suppressing output
  ledger.  Recovery is bit-identical by the replan contract; without a
  full-coverage journal it is REFUSED loudly (logged + counted), never
  attempted on a prayer.

The trip path acquires the process lock with a timeout first: if the
wedge HOLDS the lock, a replan would deadlock the watchdog too, so
that state is reported (counted recovery failure) instead of healed.
"""

from __future__ import annotations

import logging
import threading
import time

log = logging.getLogger("siddhi_tpu_torch")


class Watchdog:
    def __init__(self, runtime, stats, deadline_ms: int, ladder=None,
                 interval_ms: int = 0):
        self.runtime = runtime
        self.stats = stats
        self.deadline_ms = int(deadline_ms)
        self.ladder = ladder
        self.interval_s = (interval_ms or max(self.deadline_ms // 4, 10)
                           ) / 1000.0
        self._stop = threading.Event()
        self._thread = None
        self._last_beats = -1
        self._last_progress = time.monotonic()
        self._last_shed = 0
        self._in_near_miss = False
        #: health-endpoint state
        self.wedged = False
        self.last_trip_wall = 0.0

    # -- lifecycle ----------------------------------------------------

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._last_progress = time.monotonic()
        self._thread = threading.Thread(
            target=self._loop,
            name=f"watchdog-{self.runtime.app_context.name}",
            daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — daemon must survive a bad tick
                log.exception(
                    "app '%s': watchdog tick failed",
                    self.runtime.app_context.name)
            except BaseException:
                # injected crash (SimulatedCrashError) kills the daemon,
                # same contract as the scheduler/persist daemons
                break

    # -- detection ----------------------------------------------------

    def _tick(self):
        self.stats.watchdog_ticks += 1
        ctx = self.runtime.app_context
        beats = ctx.progress.beats
        now = time.monotonic()
        if beats != self._last_beats:
            self._last_beats = beats
            self._last_progress = now
            self.wedged = False
            self._in_near_miss = False
        pending = self.runtime._pending_work()
        age_ms = (now - self._last_progress) * 1000.0
        stalled = pending > 0 and age_ms >= self.deadline_ms
        near = pending > 0 and not stalled and \
            age_ms >= self.deadline_ms / 2.0
        if near and not self._in_near_miss:
            self.stats.watchdog_near_misses += 1
            self._in_near_miss = True
        if self.ladder is not None:
            shed_total = self.stats.events_shed
            shed_delta = shed_total - self._last_shed
            self._last_shed = shed_total
            pressure = max(
                self.runtime._queue_fill(),
                1.0 if shed_delta > 0 else 0.0,
                1.0 if (near or stalled) else 0.0,
            )
            self.ladder.observe(pressure)
        if stalled:
            self._trip(age_ms, pending)

    # -- recovery -----------------------------------------------------

    def _trip(self, age_ms: float, pending: int):
        ctx = self.runtime.app_context
        self.stats.watchdog_trips += 1
        self.wedged = True
        self.last_trip_wall = time.monotonic()
        # back off a full deadline before re-tripping, whatever happens
        # below — a failed heal must not spin the trip counter
        self._last_progress = time.monotonic()
        fi = getattr(ctx, "fault_injector", None)
        if fi is not None:
            # choke point: a transient here aborts THIS trip (the loop
            # catches it and the still-stalled app re-trips next
            # deadline); a crash kills the daemon like any other
            fi.check("watchdog.trip")
        tracer = getattr(ctx, "tracer", None)
        if tracer is not None:
            tracer.dump("watchdog-trip")
        log.error(
            "app '%s': watchdog tripped — no batch progress for %.0f ms "
            "with %d unit(s) of work pending", ctx.name, age_ms, pending)
        jr = getattr(ctx, "input_journal", None)
        if jr is None or not jr.covers_from_start():
            self.stats.watchdog_recovery_failures += 1
            log.error(
                "app '%s': watchdog self-heal REFUSED — %s; restart the "
                "app manually", ctx.name,
                "no input journal (@app:faults(journal='N') required)"
                if jr is None else
                "journal no longer covers the full input history")
            return
        # a wedge that HOLDS the process lock cannot be replanned away —
        # probe with a bounded acquire instead of deadlocking the daemon
        if not ctx.process_lock.acquire(
                timeout=max(self.deadline_ms / 1000.0, 0.05)):
            self.stats.watchdog_recovery_failures += 1
            log.error(
                "app '%s': watchdog self-heal REFUSED — the process lock "
                "is held by the wedged path; replan would deadlock",
                ctx.name)
            return
        ctx.process_lock.release()
        t_heal = time.perf_counter()  # Tracer.clock is this same clock
        try:
            self.runtime.replan(
                dict(ctx.plan_pins), forced=True,
                reason=(f"watchdog self-heal: stalled batch cycle "
                        f"({age_ms:.0f} ms, {pending} pending)"))
        except Exception as e:  # noqa: BLE001 — counted + logged, daemon stays live
            self.stats.watchdog_recovery_failures += 1
            log.error(
                "app '%s': watchdog self-heal failed: %s", ctx.name, e,
                exc_info=e)
            return
        # the replan adopted a REBUILT context — record the heal span on
        # the live tracer, not the discarded pre-heal one (the clock is
        # the shared perf_counter, so spans from both line up)
        ntracer = getattr(self.runtime.app_context, "tracer", None)
        if ntracer is not None:
            # recovery time as a latency distribution (STAGE_WATCHDOG_HEAL)
            ntracer.record_span("watchdog.heal", "robustness",
                                t_heal, ntracer.clock())
        self.stats.watchdog_recoveries += 1
        self.wedged = False
        self._last_beats = ctx.progress.beats
        self._last_progress = time.monotonic()
        log.warning(
            "app '%s': watchdog self-heal complete — engines rebuilt and "
            "journal history replayed", ctx.name)

    def describe(self) -> dict:
        return {
            "deadline_ms": self.deadline_ms,
            "wedged": self.wedged,
            "trips": self.stats.watchdog_trips,
            "near_misses": self.stats.watchdog_near_misses,
            "recoveries": self.stats.watchdog_recoveries,
            "recovery_failures": self.stats.watchdog_recovery_failures,
        }
