"""Background checkpoint writer: single-in-flight, coalescing, retrying.

Port of the JAX package's ``durability/writer.py``.

``persist(mode='async')`` captures state under the barrier and hands the
writer a *job* (a closure that materializes blobs, writes the store, and
commits the journal mark).  The batch loop resumes immediately; the
writer thread runs the job with a bounded retry ladder on retryable
store faults (``persist.write`` choke point), mirroring the emit-queue's
transfer hardening.

Backpressure is single-in-flight with coalescing: while one checkpoint
is writing, at most ONE newer persist queues; a third supersedes the
queued one (its journal mark is dropped via ``on_abandon`` and the
coalesce is counted) — checkpoints are idempotent full states, so the
newest always wins and the writer can never build an unbounded backlog.

A :class:`~siddhi_tpu_torch.core.exceptions.SimulatedCrashError` (BaseException
— the crash-matrix kill signal) tears the writer down mid-job exactly
like a real SIGKILL: the thread records the crash and stops, journal
marks stay put, and recovery goes through
``restore_last_revision()``'s checksum walk.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from siddhi_tpu_torch.core.exceptions import (
    ConnectionUnavailableError,
    SimulatedCrashError,
    TransferFaultError,
)
from siddhi_tpu_torch.util.faults import (
    DEFAULT_TRANSFER_RETRY_ATTEMPTS,
    DEFAULT_TRANSFER_RETRY_SCALE,
)

log = logging.getLogger("siddhi_tpu_torch.durability")

#: store faults worth a backoff-retry (everything else fails the persist)
_RETRYABLE = (TransferFaultError, ConnectionUnavailableError, OSError)

#: terminal statuses a submitted revision can reach
_DONE = ("committed", "failed", "superseded", "crashed")


class DurabilityStats:
    """Checkpoint-pipeline counters (``as_dict()``; the statistics feed
    that surfaces them is ``ROADMAP.md`` item 15)."""

    __slots__ = (
        "persists_sync",
        "persists_async",
        "persists_coalesced",
        "persist_retries",
        "persist_failures",
        "persist_commits",
        "capture_fallback_elements",
        "blobs_written",
        "bytes_written",
    )

    def __init__(self) -> None:
        for name in self.__slots__:
            setattr(self, name, 0)

    def as_dict(self) -> Dict[str, int]:
        return {name: getattr(self, name) for name in self.__slots__}


class AsyncCheckpointWriter:
    """One daemon writer thread per app runtime (started lazily)."""

    def __init__(self, app_name: str, stats: Optional[DurabilityStats] = None,
                 fault_injector=None,
                 listeners: Optional[List[Any]] = None):
        self.app_name = app_name
        self.stats = stats or DurabilityStats()
        self.fault_injector = fault_injector
        self.listeners = listeners if listeners is not None else []
        # condition over the writer lock: every mutable writer field
        # below is read/written only while holding it
        self._lock = threading.Condition(threading.Lock())
        # (revision, job, on_abandon) | None — the ONE queued persist
        self._pending: Optional[Tuple[str, Callable, Optional[Callable]]] = None
        self._inflight: Optional[str] = None
        self._results: Dict[str, str] = {}
        self._stop = False
        self._crashed: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    # -- submission ---------------------------------------------------------

    def submit(self, revision: str, job: Callable[[], None],
               on_abandon: Optional[Callable[[str], None]] = None) -> str:
        """Queue a checkpoint job.  Returns the revision.  A queued (not
        yet in-flight) older persist is superseded: its ``on_abandon``
        runs (dropping its journal mark) and the coalesce is counted."""
        abandoned: Optional[Tuple[str, Optional[Callable]]] = None
        with self._lock:
            if self._crashed is not None:
                # writer is dead (simulated crash): the submit itself
                # must not hide that — callers treat it like a crashed
                # process would
                raise SimulatedCrashError(
                    f"checkpoint writer of app '{self.app_name}' crashed")
            if self._pending is not None:
                old_rev, _old_job, old_abandon = self._pending
                self._results[old_rev] = "superseded"
                self.stats.persists_coalesced += 1
                abandoned = (old_rev, old_abandon)
            self._pending = (revision, job, on_abandon)
            self.stats.persists_async += 1
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name=f"ckpt-writer-{self.app_name}",
                    daemon=True)
                self._thread.start()
            self._lock.notify_all()
        if abandoned is not None:
            rev, cb = abandoned
            log.info("durability: app '%s' persist %s coalesced into %s",
                     self.app_name, rev, revision)
            if cb is not None:
                cb(rev)
        return revision

    # -- introspection / barriers -------------------------------------------

    def status(self, revision: str) -> Optional[str]:
        with self._lock:
            if self._pending is not None and self._pending[0] == revision:
                return "pending"
            if self._inflight == revision:
                return "inflight"
            return self._results.get(revision)

    @property
    def crashed(self) -> Optional[BaseException]:
        with self._lock:
            return self._crashed

    def wait(self, revision: Optional[str] = None,
             timeout: Optional[float] = None) -> Optional[str]:
        """Block until ``revision`` reaches a terminal status (or, with
        no revision, until nothing is pending/in-flight).  Returns the
        status (None on timeout / unknown revision)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                if self._crashed is not None:
                    return self._results.get(revision, "crashed") \
                        if revision else "crashed"
                if revision is None:
                    if self._pending is None and self._inflight is None:
                        return "idle"
                else:
                    st = self._results.get(revision)
                    if st in _DONE:
                        return st
                    if (st is None and self._inflight != revision
                            and not (self._pending is not None
                                     and self._pending[0] == revision)):
                        return None  # never submitted
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                self._lock.wait(remaining)

    def shutdown(self, timeout: float = 10.0):
        """Flush outstanding work (bounded) and stop the thread."""
        self.wait(timeout=timeout)
        with self._lock:
            self._stop = True
            self._lock.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=2)

    # -- writer thread ------------------------------------------------------

    def _run(self):
        while True:
            with self._lock:
                while self._pending is None and not self._stop:
                    self._lock.wait()
                if self._stop and self._pending is None:
                    return
                revision, job, on_abandon = self._pending
                self._pending = None
                self._inflight = revision
                self._lock.notify_all()
            try:
                self._write(revision, job, on_abandon)
            except SimulatedCrashError as e:
                # crash-matrix kill: die like the process would —
                # nothing after the crash point runs
                log.warning("durability: app '%s' checkpoint writer "
                            "crashed at revision %s: %s", self.app_name,
                            revision, e)
                with self._lock:
                    self._results[revision] = "crashed"
                    self._inflight = None
                    self._crashed = e
                    self._lock.notify_all()
                return
            with self._lock:
                self._inflight = None
                self._lock.notify_all()

    def _write(self, revision: str, job: Callable[[], None],
               on_abandon: Optional[Callable[[str], None]]):
        fi = self.fault_injector
        attempts = (fi.transfer_retry_attempts if fi is not None
                    else DEFAULT_TRANSFER_RETRY_ATTEMPTS)
        scale = (fi.transfer_retry_scale if fi is not None
                 else DEFAULT_TRANSFER_RETRY_SCALE)
        last: Optional[Exception] = None
        for attempt in range(max(1, attempts)):
            try:
                if fi is not None:
                    fi.check("persist.write")
                job()
                with self._lock:
                    self._results[revision] = "committed"
                    self.stats.persist_commits += 1
                return
            except _RETRYABLE as e:
                last = e
                with self._lock:
                    self.stats.persist_retries += 1
                if fi is not None:
                    fi.notify(e)
                if attempt + 1 < max(1, attempts):
                    time.sleep(scale * (2 ** attempt))
            except SimulatedCrashError:
                raise
            except Exception as e:
                last = e
                break  # non-retryable store/serialization failure
        log.error("durability: app '%s' checkpoint %s failed after "
                  "retries: %s", self.app_name, revision, last)
        with self._lock:
            self._results[revision] = "failed"
            self.stats.persist_failures += 1
        for ln in list(self.listeners):
            try:
                ln(last)
            except Exception:  # pragma: no cover - listener bug
                log.exception("durability: exception listener failed")
        if on_abandon is not None:
            on_abandon(revision)
