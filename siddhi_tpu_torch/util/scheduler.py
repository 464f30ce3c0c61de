"""Scheduler: the app's time-driven windows and tasks.

Port of the JAX package's ``util/scheduler.py``: the time windows of
host queries (``register_window``: the query runtime's ``on_time``
runs when the window's ``next_wakeup`` has elapsed) and tasks that
expose ``fire(now)`` and ``next_wakeup() -> int | None`` (time rate
limiters, the dense pattern runtimes of absent-deadline engines, the
partition's ``@purge``).  Every input batch advances the app watermark
under the app lock and fires the due windows, then the due tasks,
before the batch reaches its junction; a wall-clock thread covers idle
periods in processing-time mode, and under ``@app:playback`` the clock
is event time alone (the idle heartbeat of ``@app:playback(idle.time,
increment)`` is the app runtime's).
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional, Tuple

log = logging.getLogger("siddhi_tpu_torch")

# per-task fire cap within one advance(); far above any legitimate
# timer fan (a task re-arming every fire drains one wakeup per fire)
_MAX_DRAIN_FIRES = 100_000


class Scheduler:
    def __init__(self, app_context):
        self.app_context = app_context
        # (query runtime, window) pairs needing time ticks
        self._windows: List[Tuple[object, object]] = []
        self._tasks: List[object] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._last_advance = -1

    def register_window(self, query_runtime, window):
        """``query_runtime.on_time(now)`` runs once ``window.next_wakeup()``
        has elapsed."""
        self._windows.append((query_runtime, window))

    def unregister_window(self, query_runtime, window):
        try:
            self._windows.remove((query_runtime, window))
        except ValueError:
            pass

    def register_task(self, task):
        """``task`` exposes ``fire(now)`` and ``next_wakeup() -> int |
        None``, and optionally ``on_start(now)``."""
        self._tasks.append(task)

    def unregister_task(self, task):
        try:
            self._tasks.remove(task)
        except ValueError:
            pass

    # -- event-driven path (called under the app lock) -----------------------

    def advance(self, now: int):
        """Tick every window, then fire every task, whose wakeups have
        elapsed at ``now``."""
        if now <= self._last_advance:
            return
        self._last_advance = now
        # snapshots of both lists: a fire may (un)register tasks
        for qr, w in list(self._windows):
            wake = w.next_wakeup()
            if wake is not None and wake <= now:
                qr.on_time(now)
        for t in list(self._tasks):
            # drain ALL elapsed wakeups, not just one: a watermark jump
            # over several timer windows must deliver each fire.  The
            # equal-wake guard stops tasks whose fire does not advance
            # their clock; the cap stops one whose wakeups oscillate
            prev = None
            for _ in range(_MAX_DRAIN_FIRES):
                wake = t.next_wakeup()
                if wake is None or wake > now or wake == prev:
                    break
                prev = wake
                try:
                    t.fire(now)
                except Exception as e:
                    # one failing task must not stop the watermark
                    # advance for every other task
                    log.error("scheduler task %r failed on fire(%d): %s",
                              t, now, e)
                    for ln in list(getattr(self.app_context,
                                           "exception_listeners", [])):
                        try:
                            ln(e)
                        except Exception:
                            log.exception("exception listener failed")
                    break
            else:
                log.warning(
                    "scheduler task %r still has elapsed wakeups after %d "
                    "fires in one advance; deferring to the next tick",
                    t, _MAX_DRAIN_FIRES)

    # -- wall-clock fallback (processing-time mode only) ---------------------

    def start(self, tick_ms: int = 50):
        """Each task's ``on_start(now)``; then, in processing-time mode,
        a thread advancing the watermark every ``tick_ms`` under the app
        lock."""
        now = self.app_context.timestamp_generator.current_time()
        for t in self._tasks:
            if hasattr(t, "on_start"):
                t.on_start(now)
        if self.app_context.playback:
            return  # event time only
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, args=(tick_ms,),
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self, tick_ms: int):
        while not self._stop.wait(tick_ms / 1000.0):
            now = self.app_context.timestamp_generator.current_time()
            with self.app_context.process_lock:
                self.advance(now)
