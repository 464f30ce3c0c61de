"""Admission control: per-stream token-bucket budgets at ingest.

``@app:limits(rate='N/s', burst='M', shed='drop|oldest|block')``
installs one :class:`TokenBucket` per input stream, consulted by
``InputHandler.send``/``send_batch`` BEFORE the batch is journaled —
the input journal records only admitted events, so restore-and-replay
reproduces exactly the admitted set and never re-litigates an
admission decision (replay bypasses the controller via the journal's
``replaying`` flag).

Clocks: in ``@app:playback`` mode the bucket refills on EVENT time
(deterministic — the chaos soak's exact-shed-count differential rides
on this); otherwise on ``time.monotonic()``.

Shed policies over an arriving batch of ``n`` with ``k`` admitted:

- ``drop``   — keep the oldest ``k`` rows (head), shed the overflow
  tail: arrival order wins.
- ``oldest`` — keep the newest ``k`` rows (tail), shed the head:
  freshness wins.
- ``block``  — backpressure: the CALLING thread (for transports, the
  source's delivery thread — that is the propagation path) waits for
  refill on the ``transport/`` retry ladder's interval sequence, up to
  ``block.max``; whatever budget never arrives is shed and counted as
  a block timeout.  In playback mode event time cannot advance while
  the sender is parked, so ``block`` degrades to an immediate counted
  timeout shed.

A shed fires the ``admission.shed`` fault-injection site — chaos runs
can crash/fault the engine at the exact moment it drops load.
"""

from __future__ import annotations

import threading
import time

import numpy as np

SHED_POLICIES = ("drop", "oldest", "block")


class TokenBucket:
    """Classic token bucket with an injected 'now' (seconds, float)."""

    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.last = now

    def refill(self, now: float):
        if now > self.last:
            self.tokens = min(
                self.burst, self.tokens + (now - self.last) * self.rate)
            self.last = now

    def take(self, n: int, now: float) -> int:
        """Admit up to ``n`` whole events; returns the admitted count."""
        self.refill(now)
        k = int(min(n, self.tokens))
        self.tokens -= k
        return k

    def eta_s(self, now: float) -> float:
        """Seconds until at least one whole token is available."""
        self.refill(now)
        if self.tokens >= 1.0:
            return 0.0
        return (1.0 - self.tokens) / self.rate


class AdmissionController:
    """Per-stream budgets + shed accounting for one app (one tenant).

    Survives ``replan()`` — the rebuilt app context re-adopts the same
    controller so bucket levels and shed counters carry across a
    watchdog self-heal exactly like the input journal does.
    """

    #: recent-shed window for the health endpoint's "shedding" verdict
    HEALTH_WINDOW_S = 1.0

    def __init__(self, app_context, stats):
        self.app_context = app_context
        self.stats = stats
        self.rate = float(app_context.limits_rate)
        self.burst = float(app_context.limits_burst)
        self.policy = app_context.limits_shed
        self.block_max_ms = int(app_context.limits_block_max_ms)
        self._lock = threading.Lock()
        self._buckets = {}
        self._admitted = {}
        self._shed = {}
        self._last_shed_wall = 0.0

    def _now(self) -> float:
        tg = self.app_context.timestamp_generator
        if tg.playback:
            return tg.current_time() / 1000.0
        return time.monotonic()

    def _bucket(self, stream_id: str, now: float) -> TokenBucket:
        b = self._buckets.get(stream_id)
        if b is None:
            b = self._buckets[stream_id] = TokenBucket(
                self.rate, self.burst, now)
        return b

    def admit(self, stream_id: str, batch):
        """Trim ``batch`` to the admitted rows; ``None`` = fully shed."""
        n = len(batch)
        if n == 0:
            return batch
        with self._lock:
            now = self._now()
            k = self._bucket(stream_id, now).take(n, now)
        if k < n and self.policy == "block":
            k = self._block_for_budget(stream_id, n, k)
        shed = n - k
        with self._lock:
            self._admitted[stream_id] = self._admitted.get(stream_id, 0) + k
            self.stats.events_admitted += k
            if shed:
                self._shed[stream_id] = self._shed.get(stream_id, 0) + shed
                self.stats.events_shed += shed
                if self.policy == "drop":
                    self.stats.shed_drop += shed
                elif self.policy == "oldest":
                    self.stats.shed_oldest += shed
                else:
                    self.stats.shed_block_timeout += shed
                self._last_shed_wall = time.monotonic()
        if shed:
            fi = getattr(self.app_context, "fault_injector", None)
            if fi is not None:
                fi.check("admission.shed")
        if k == n:
            return batch
        if k == 0:
            return None
        if self.policy == "oldest":
            # shed the OLDEST rows: the newest k survive
            return batch.take(np.arange(n - k, n))
        return batch.take(np.arange(k))

    def _block_for_budget(self, stream_id: str, n: int, k: int) -> int:
        """``block`` policy: park the sender on the transport retry
        ladder's interval sequence until budget arrives or ``block.max``
        expires.  Returns the final admitted count."""
        tg = self.app_context.timestamp_generator
        if tg.playback:
            return k  # event time cannot advance while we park
        from siddhi_tpu_torch.transport.retry import _INTERVALS_MS

        deadline = time.monotonic() + self.block_max_ms / 1000.0
        rung = 0
        while k < n:
            with self._lock:
                now = time.monotonic()
                b = self._bucket(stream_id, now)
                eta = b.eta_s(now)
            remaining = deadline - time.monotonic()
            if remaining <= 0.0:
                break
            interval = _INTERVALS_MS[min(rung, len(_INTERVALS_MS) - 1)]
            rung += 1
            wait = min(max(eta, 0.001), interval / 1000.0, remaining)
            self.stats.block_waits += 1
            time.sleep(wait)
            self.stats.block_wait_ms += int(wait * 1000.0)
            with self._lock:
                now = time.monotonic()
                k += self._bucket(stream_id, now).take(n - k, now)
        return k

    # -- health -------------------------------------------------------

    def shedding_now(self) -> bool:
        return (time.monotonic() - self._last_shed_wall
                ) < self.HEALTH_WINDOW_S

    def snapshot(self) -> dict:
        """Per-stream admission detail for ``GET /siddhi-health``."""
        with self._lock:
            streams = {
                sid: {
                    "admitted": self._admitted.get(sid, 0),
                    "shed": self._shed.get(sid, 0),
                    "tokens": round(b.tokens, 3),
                }
                for sid, b in self._buckets.items()
            }
            for sid in set(self._admitted) | set(self._shed):
                streams.setdefault(sid, {
                    "admitted": self._admitted.get(sid, 0),
                    "shed": self._shed.get(sid, 0),
                    "tokens": self.burst,
                })
        return {
            "rate_per_s": self.rate,
            "burst": self.burst,
            "shed_policy": self.policy,
            "shedding": self.shedding_now(),
            "streams": streams,
        }
