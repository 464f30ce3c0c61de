"""Step debugger: breakpoints at query IN/OUT terminals.

Re-design of the reference ``debugger/SiddhiDebugger.java:36``
(acquireBreakPoint:95, checkBreakPoint:133 blocks the event thread on a
lock; next()/play() release it) for batched execution: checkpoints sit
at micro-batch boundaries — a breakpoint delivers the whole batch at the
query terminal to the debugger callback, and the event thread blocks
until ``next()`` (stop at the next checkpoint, acquired or not) or
``play()`` (run to the next acquired breakpoint).  Calling next()/play()
from inside the callback — the SiddhiDebuggerClient pattern — resumes
without blocking.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Set, Tuple

from siddhi_tpu_torch.core.event import EventBatch, events_from_batch


class QueryTerminal:
    IN = "IN"
    OUT = "OUT"


class SiddhiDebugger:
    """One per debugged app runtime (``SiddhiAppRuntime.debug()``)."""

    QueryTerminal = QueryTerminal

    def __init__(self, app_runtime):
        self.app = app_runtime
        self._acquired: Set[Tuple[str, str]] = set()
        self._step = False  # next(): break at the very next checkpoint
        self._callback: Optional[Callable] = None
        self._resume = threading.Event()
        self._resume.set()
        self._lock = threading.Lock()

    # -- breakpoint management ----------------------------------------------

    def acquire_break_point(self, query_name: str, terminal: str):
        """reference: SiddhiDebugger.acquireBreakPoint:95"""
        with self._lock:
            self._acquired.add((query_name, terminal))

    def release_break_point(self, query_name: str, terminal: str):
        with self._lock:
            self._acquired.discard((query_name, terminal))

    def release_all_break_points(self):
        with self._lock:
            self._acquired.clear()

    def set_debugger_callback(self, callback: Callable):
        """``callback(events, query_name, terminal, debugger)`` runs on
        the event thread when a breakpoint hits."""
        self._callback = callback

    # -- stepping ------------------------------------------------------------

    def next(self):
        """Resume and stop at the next checkpoint of any query."""
        self._step = True
        self._resume.set()

    def play(self):
        """Resume and run until the next acquired breakpoint."""
        self._step = False
        self._resume.set()

    # -- state inspection ----------------------------------------------------

    def get_query_state(self, query_name: str):
        qr = self.app.query_runtimes.get(query_name)
        if qr is None or not hasattr(qr, "snapshot_state"):
            return None
        return qr.snapshot_state()

    # Java-style aliases
    acquireBreakPoint = acquire_break_point
    releaseBreakPoint = release_break_point
    releaseAllBreakPoints = release_all_break_points
    setDebuggerCallback = set_debugger_callback
    getQueryState = get_query_state

    # -- engine-facing hook --------------------------------------------------

    def check_breakpoint(self, query_name: str, terminal: str, batch: EventBatch):
        """Called by QueryRuntime at each terminal; blocks the event
        thread while the breakpoint holds (reference:
        SiddhiDebugger.checkBreakPoint:133)."""
        with self._lock:
            hit = self._step or (query_name, terminal) in self._acquired
        if not hit:
            return
        self._step = False
        self._resume.clear()
        cb = self._callback
        if cb is not None:
            cb(events_from_batch(batch), query_name, terminal, self)
        # a callback that called next()/play() has already set the event
        self._resume.wait()
