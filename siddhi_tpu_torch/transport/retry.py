"""Exponential backoff counter for transport reconnects.

Port of the JAX package's ``transport/retry.py``.

Mirrors the reference ``util/transport/BackoffRetryCounter.java`` (interval
ladder 5s, 10s, 15s, 30s, 1min, 2min, 5min, capped), scaled by a factor so
tests can run the ladder in milliseconds.  ``ConnectRetryMixin`` keeps
the reference's circuit-breaker hooks; no planner attaches a breaker
until ``@app:limits`` is ported (``ROADMAP.md`` §1 item 15b), so they
stay inert.
"""

from __future__ import annotations

from siddhi_tpu_torch.core.exceptions import ConnectionUnavailableError

_INTERVALS_MS = [5_000, 10_000, 15_000, 30_000, 60_000, 120_000, 300_000]


class BackoffRetryCounter:
    def __init__(self, scale: float = 1.0):
        self.scale = scale
        self._idx = 0

    def reset(self):
        self._idx = 0

    def get_time_interval_ms(self) -> int:
        return int(_INTERVALS_MS[min(self._idx, len(_INTERVALS_MS) - 1)] * self.scale)

    def increment(self):
        if self._idx < len(_INTERVALS_MS) - 1:
            self._idx += 1


class ConnectRetryMixin:
    """Single-chain exponential-backoff reconnect shared by Source and
    Sink (reference: Sink.connectWithRetry:276, Source.connectWithRetry).

    Host class provides ``connect()``, ``definition``, and calls
    ``_init_retry(options)`` from its init; the mixin maintains
    ``connected`` and guarantees at most one pending retry chain.
    """

    def _init_retry(self, options):
        import threading

        self._retry = BackoffRetryCounter(scale=float(options.get("retry.scale", "1.0")))
        # retry.max.attempts: bound on consecutive failed connect
        # attempts before the transport gives up (0 = retry forever, the
        # reference's behavior and the default)
        self._retry_max_attempts = int(options.get("retry.max.attempts", "0"))
        self._retry_attempts = 0
        self.failed = False
        self._retrying = False
        self._retry_lock = threading.Lock()
        self._retry_timer = None
        self._shutdown = False
        # circuit breaker (the reference's robustness/breaker.py, item
        # 15b), attached by the planner under @app:limits(breaker='N')
        self._breaker = None

    def start(self):
        # under the retry lock: a pending Timer chain from a previous
        # start may still be mutating these from its own thread
        with self._retry_lock:
            self._shutdown = False
            self.failed = False
            self._retry_attempts = 0
        self._connect_with_retry()

    def _on_retry_exhausted(self, e: Exception):
        """Hook: the retry ladder ran out of attempts.  Subclasses route
        this through their OnError machinery; the base just logs."""
        import logging

        logging.getLogger(type(self).__module__).error(
            "%s on stream '%s' giving up after %d failed connect "
            "attempts: %s", type(self).__name__, self.definition.id,
            self._retry_attempts, e)

    def _connect_with_retry(self):
        import logging
        import threading

        log = logging.getLogger(type(self).__module__)
        # one reconnect chain at a time — a batch of publish failures must
        # not fan out into parallel perpetual timer chains
        with self._retry_lock:
            if self._retrying:
                return
            self._retrying = True
        breaker = getattr(self, "_breaker", None)
        if breaker is not None and not breaker.allow():
            # circuit open: skip the connect attempt entirely and
            # re-check after the ladder interval (by then the cooldown
            # may have elapsed and this chain becomes the half-open probe)
            interval = self._retry.get_time_interval_ms()
            self._retry.increment()
            self._arm_retry_timer(interval)
            return
        try:
            fi = getattr(self, "_fault_injector", None)
            if fi is not None:
                fi.check(getattr(self, "_fault_site_connect", "connect"))
            self.connect()
        except ConnectionUnavailableError as e:
            if breaker is not None:
                try:
                    breaker.record_failure()
                except Exception as fault:  # noqa: BLE001
                    # injected breaker.open fault: already counted by the
                    # injector; the backoff chain must survive it
                    log.warning(
                        "%s on stream '%s': breaker.open site fault: %s",
                        type(self).__name__, self.definition.id, fault)
            with self._retry_lock:
                self._retry_attempts += 1
                exhausted = (
                    self._retry_max_attempts
                    and self._retry_attempts >= self._retry_max_attempts)
                if exhausted:
                    self.failed = True
                    self._retrying = False
            if exhausted:
                fi = getattr(self, "_fault_injector", None)
                if fi is not None:
                    fi.stats.connect_retries_exhausted += 1
                self._on_retry_exhausted(e)
                return
            interval = self._retry.get_time_interval_ms()
            self._retry.increment()
            log.warning(
                "%s on stream '%s' connection failed (%s); retrying in %d ms",
                type(self).__name__, self.definition.id, e, interval,
            )
            self._arm_retry_timer(interval)
            return  # flag stays held until the timer fires
        except BaseException:
            with self._retry_lock:
                self._retrying = False
            raise
        self._retry.reset()
        with self._retry_lock:
            self.connected = True
            self._retry_attempts = 0
            self.failed = False
            self._retrying = False
        if breaker is not None and breaker.record_success():
            # this connect CLOSED the breaker — drain anything the owner
            # spooled while it was open (sinks override; default no-op)
            self._on_breaker_closed()

    def _on_breaker_closed(self):
        """Hook: the circuit breaker closed after a successful connect.
        Sinks flush their open-state spool here; sources have nothing
        buffered (their pause path already replays in order)."""

    def _arm_retry_timer(self, interval_ms: int):
        """Arm the next backoff Timer — under ``_retry_lock`` and gated
        on ``_shutdown``.  A concurrent ``shutdown()`` that already ran
        ``_shutdown_retry()`` found no timer to cancel; arming one here
        anyway would leave a zombie firing after shutdown (and, because
        ``start()`` re-clears ``_shutdown``, able to interleave with a
        NEW chain's state).  Checking under the same lock closes the
        race: either the cancel sees our timer, or we see the flag."""
        import threading

        t = threading.Timer(interval_ms / 1000.0, self._retry_connect)
        t.daemon = True
        with self._retry_lock:
            if self._shutdown:
                self._retrying = False
                return
            self._retry_timer = t
        t.start()

    def _retry_connect(self):
        with self._retry_lock:
            self._retrying = False
        if not self._shutdown:
            self._connect_with_retry()

    def _shutdown_retry(self):
        """Cancel any pending chain; leaves the mixin restartable."""
        with self._retry_lock:
            self._shutdown = True
            t, self._retry_timer = self._retry_timer, None
            self._retrying = False
        if t is not None:
            t.cancel()
