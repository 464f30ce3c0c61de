"""Sink SPI: publishing stream output to external transports.

Port of the JAX package's ``transport/sink.py``.

Re-design of the reference ``stream/output/sink/`` (Sink.java:59 —
publish :174/:243, connectWithRetry :276 with BackoffRetryCounter,
onError :354; SinkMapper event -> payload; InMemorySink, LogSink;
distributed/ multi-endpoint strategies): a sink subscribes to its
stream's junction, maps each event batch to payloads, and publishes.
Publish failures route through ``on_error`` (drop + log, or raise into
the junction's @OnError handling).
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Optional

import numpy as np

from siddhi_tpu_torch.core.event import (
    Event,
    EventBatch,
    batch_from_events,
    events_from_batch,
)
from siddhi_tpu_torch.core.exceptions import (
    ConnectionUnavailableError,
    InjectedFaultError,
    SiddhiAppRuntimeError,
)
from siddhi_tpu_torch.extension.registry import extension
from siddhi_tpu_torch.transport.broker import InMemoryBroker
from siddhi_tpu_torch.transport.retry import ConnectRetryMixin

# '{{attr}}' dynamic-option placeholders (reference: util/transport/
# Option + TemplateBuilder)
_TEMPLATE_RE = re.compile(r"\{\{(\w+)\}\}")

log = logging.getLogger(__name__)


class SinkMapper:
    """events -> transport payloads (reference: SinkMapper.java)."""

    def init(self, definition, options: Dict[str, str]):
        self.definition = definition
        self.options = options

    def map(self, events: List[Event]) -> List:
        raise NotImplementedError


@extension("sink_mapper", "passThrough")
class PassThroughSinkMapper(SinkMapper):
    def map(self, events: List[Event]) -> List:
        return list(events)


@extension("sink_mapper", "json")
class JsonSinkMapper(SinkMapper):
    """One JSON object string per event (attribute name -> value); the
    stdlib stand-in for siddhi-map-json."""

    def map(self, events: List[Event]) -> List:
        import json

        names = self.definition.attribute_names

        def clean(v):
            if isinstance(v, np.generic):
                return v.item()
            return v

        return [
            json.dumps({nm: clean(v) for nm, v in zip(names, e.data)})
            for e in events
        ]


class Sink(ConnectRetryMixin):
    """Transport publisher SPI (reference: Sink.java:59)."""

    def init(self, definition, options: Dict[str, str], mapper: SinkMapper, app_context):
        import threading

        self.definition = definition
        self.options = options
        self.mapper = mapper
        self.app_context = app_context
        self.connected = False
        # @app:faults harness: arms the sink.connect / sink.publish
        # injection sites (None when chaos testing is off)
        self._fault_injector = getattr(app_context, "fault_injector", None)
        self._fault_site_connect = "sink.connect"
        # wired by the planner: the stream's junction, consulted for
        # the @OnError publish-failure contract
        self.stream_junction = None
        # per-THREAD dynamic-option context: sync junctions deliver on
        # the caller's thread, so two senders may traverse one sink
        # concurrently — instance state would cross their topics
        self._tls = threading.local()
        self._init_retry(options)
        # open-breaker spool (the reference's robustness/breaker.py,
        # item 15b): batches held while the circuit is open, flushed
        # once it closes.  The output ledger counted them at junction
        # dispatch, so a crash-replay suppresses them and the flush
        # never double-emits.
        self._spool = None
        self._spool_cap = 0
        # REENTRANT: a flush publishing through a half-open breaker
        # closes it via record_success(), and publish_with_reconnect
        # then re-enters _flush_spool on the same thread — a plain
        # Lock self-deadlocks on that path (the nested flush drains
        # whatever remains and the outer loop exits on empty)
        self._spool_lock = threading.RLock()

    def attach_breaker(self, breaker, spool_cap: int = 1024):
        """Planner hook: install the circuit breaker and its bounded
        open-state spool (@app:limits(breaker='N'))."""
        from collections import deque

        self._breaker = breaker
        self._spool_cap = int(spool_cap)
        self._spool = deque(maxlen=self._spool_cap)

    # -- SPI ---------------------------------------------------------------

    def connect(self):
        pass

    def disconnect(self):
        pass

    def publish(self, payload):
        raise NotImplementedError

    # -- lifecycle ---------------------------------------------------------
    # start/_connect_with_retry/_retry_connect come from ConnectRetryMixin

    def shutdown(self):
        self._shutdown_retry()
        if self._spool and self.connected and (
                self._breaker is None or self._breaker.allow()):
            # final barrier flush: the transport is still up and the
            # breaker admits a delivery (closed, or open past cooldown
            # — allow() flips it to a half-open probe and the first
            # publish closes it), so the batches spooled during the
            # last open window can still go out in order — shutting
            # down without this drain strands them behind the barrier
            # (the loss warning below then fires for events that were
            # perfectly deliverable); a deny leaves the spool for the
            # warning, respecting the open circuit
            self._flush_spool()
        if self._spool:
            # ledger-counted as delivered at junction dispatch, so a
            # replay will NOT re-emit them: the exactly-once discipline
            # errs on at-most-once for the spool — make the loss loud
            log.warning(
                "sink %s on stream '%s' shutting down with %d batch(es) "
                "still spooled behind an open breaker",
                type(self).__name__, self.definition.id, len(self._spool))
        if self.connected:
            self.disconnect()
            # the retry thread writes `connected` under _retry_lock;
            # the main-path clear takes the same lock
            with self._retry_lock:
                self.connected = False

    # -- junction-facing ---------------------------------------------------

    def _intercepted_events(self, batch: EventBatch):
        """Batch -> events, passed through the optional SinkHandler."""
        events = events_from_batch(batch)
        hook = getattr(self, "handler", None)
        if hook is not None:
            events = hook.on_events(events)
        return events

    def send_batch(self, batch: EventBatch):
        b = self._breaker
        if b is not None:
            if not b.allow():
                # circuit open: hold the batch instead of burning a
                # publish attempt per event (short-circuit is counted
                # by the breaker)
                self._spool_batch(batch)
                return
            if self._spool:
                # breaker closed with spooled history: drain it FIRST
                # so external observers see the original order
                self._flush_spool()
        events = self._intercepted_events(batch)
        if not events:
            return
        payloads = self.mapper.map(events)
        if len(payloads) == len(events):
            # 1:1 mappers carry per-event context for dynamic options
            # ('{{attr}}' templates, reference: util/transport/Option +
            # TemplateBuilder — e.g. @sink(topic='{{symbol}}'))
            for e, payload in zip(events, payloads):
                self._tls.event = e
                try:
                    self.publish_with_reconnect(payload)
                finally:
                    self._tls.event = None
        else:
            for payload in payloads:
                self.publish_with_reconnect(payload)

    def resolve_option(self, name: str, default: Optional[str] = None):
        """Option value with '{{attr}}' placeholders substituted from
        the event being published (static values pass through)."""
        v = self.options.get(name, default)
        if v is None or "{{" not in v:
            return v
        e = getattr(self._tls, "event", None)
        names = self.definition.attribute_names

        def sub(m):
            attr = m.group(1)
            if e is None or attr not in names:
                raise SiddhiAppRuntimeError(
                    f"sink option '{name}': cannot resolve "
                    f"'{{{{{attr}}}}}' (no per-event context or unknown "
                    "attribute)")
            return str(e.data[names.index(attr)])

        return _TEMPLATE_RE.sub(sub, v)

    def publish_with_reconnect(self, payload):
        """Publish one payload; on connection failure route to
        ``on_error`` and kick off the single reconnect chain."""
        if not self.connected:
            if self._breaker is not None:
                # disconnected publishes count as breaker failures: once
                # the threshold trips, later batches spool in send_batch
                # instead of dropping through on_error one by one
                self._breaker.record_failure()
            self.on_error(payload, ConnectionUnavailableError("not connected"))
            return
        try:
            fi = self._fault_injector
            if fi is not None:
                fi.check("sink.publish")
            self.publish(payload)
            if self._breaker is not None and self._breaker.record_success():
                # the half-open probe just succeeded through the PUBLISH
                # path — flush whatever spooled while the circuit was open
                self._flush_spool()
        except ConnectionUnavailableError as e:
            # the retry thread writes `connected` under _retry_lock;
            # the main-path clear takes the same lock
            with self._retry_lock:
                self.connected = False
            if self._breaker is not None:
                self._breaker.record_failure()
            self.on_error(payload, e)
            self._connect_with_retry()
        except InjectedFaultError as e:
            # injected sink failure: the event routes through the same
            # @OnError contract a real publish error would use
            self.on_error(payload, e)

    # -- circuit breaker ----------------------------------------------------

    def _spool_batch(self, batch: EventBatch):
        """Hold a batch while the circuit is open.  The deque is
        bounded (attach_breaker); on overflow the OLDEST batch is
        evicted and its events counted as spool drops — under overload
        the freshest output survives, matching the junction's drop
        discipline."""
        sp = self._spool
        stats = getattr(self.app_context, "robustness", None)
        with self._spool_lock:
            if len(sp) == sp.maxlen:
                evicted = sp[0]  # appending below auto-evicts it
                if stats is not None:
                    stats.breaker_spool_dropped += len(evicted)
                log.warning(
                    "sink %s on stream '%s': open-breaker spool full "
                    "(%d batches) — dropping oldest %d event(s)",
                    type(self).__name__, self.definition.id, sp.maxlen,
                    len(evicted))
            sp.append(batch)
        if stats is not None:
            stats.breaker_spooled_batches += 1

    def _on_breaker_closed(self):
        """Mixin hook: a successful CONNECT closed the breaker."""
        self._flush_spool()

    def _flush_spool(self):
        """Publish everything spooled while the circuit was open, in
        order.  Events were already counted by the output ledger at
        junction dispatch, so this goes straight through the publish
        path — never back through ``SinkStreamCallback.receive`` —
        and a replay can never double-emit them.  If the breaker
        re-opens mid-flush the remainder stays spooled for the next
        close; the batch in flight routes its failures through
        ``on_error`` like any other publish."""
        sp = self._spool
        if not sp:
            return
        stats = getattr(self.app_context, "robustness", None)
        with self._spool_lock:
            while sp:
                if self._breaker is not None and self._breaker.is_open():
                    break
                batch = sp.popleft()
                if stats is not None:
                    stats.breaker_flushed_batches += 1
                events = self._intercepted_events(batch)
                if not events:
                    continue
                payloads = self.mapper.map(events)
                if len(payloads) == len(events):
                    for e, payload in zip(events, payloads):
                        self._tls.event = e
                        try:
                            self.publish_with_reconnect(payload)
                        finally:
                            self._tls.event = None
                else:
                    for payload in payloads:
                        self.publish_with_reconnect(payload)

    def _on_retry_exhausted(self, e: Exception):
        """retry.max.attempts ran out: the sink is marked failed
        (``self.failed``, set by the mixin) and the exhaustion surfaces
        through the OnError/exception-listener machinery instead of
        silently ending the timer chain."""
        log.error(
            "sink %s on stream '%s' marked FAILED after %d reconnect "
            "attempts: %s", type(self).__name__, self.definition.id,
            self._retry_attempts, e)
        j = self.stream_junction
        ev_ = getattr(self._tls, "event", None)
        if (j is not None and ev_ is not None
                and j.fault_junction is not None
                and j.route_fault(batch_from_events(self.definition, [ev_]),
                                  e)):
            return
        ac = getattr(self, "app_context", None)
        for ln in list(getattr(ac, "exception_listeners", None) or []):
            try:
                ln(e)
            except Exception:
                log.exception("exception listener failed")

    def on_error(self, payload, e: Exception):
        """Publish-failure hook (reference Sink.onError:354): when the
        sink's stream declares @OnError(action='STREAM'), the failing
        EVENT routes into its '!stream' fault junction with the error
        attached; otherwise log and drop."""
        j = self.stream_junction
        ev_ = getattr(self._tls, "event", None)
        if j is not None and ev_ is not None and j.fault_junction is not None:
            if j.route_fault(batch_from_events(self.definition, [ev_]), e):
                return
        log.error(
            "sink %s on stream '%s' failed to publish: %s",
            type(self).__name__, self.definition.id, e,
        )


class SinkStreamCallback:
    """Junction subscriber adapting batches into a Sink.

    ``ledger_key`` (set by the planner) identifies this sink endpoint in
    the crash-recovery output ledger: during restore-and-replay the
    journal suppresses the prefix of events the sink already published
    before the crash, so external observers see each event exactly
    once."""

    def __init__(self, sink: Sink):
        self.sink = sink
        self.ledger_key = None

    def receive(self, batch: EventBatch):
        jr = getattr(self.sink.app_context, "input_journal", None)
        if jr is not None and self.ledger_key is not None:
            batch = jr.deliver(self.ledger_key, batch)
            if batch is None:
                return
        self.sink.send_batch(batch)


@extension("sink", "inMemory")
class InMemorySink(Sink):
    """Publishes payloads to an InMemoryBroker topic
    (reference: InMemorySink.java)."""

    def publish(self, payload):
        topic = self.resolve_option("topic")
        InMemoryBroker.publish(topic, payload)


@extension("sink", "log")
class LogSink(Sink):
    """Logs each event (reference: LogSink.java).  Options: prefix,
    priority (debug|info|warn|error)."""

    def publish(self, payload):
        prefix = self.options.get("prefix", f"{self.definition.id} : ")
        level = {
            "debug": logging.DEBUG, "info": logging.INFO,
            "warn": logging.WARNING, "error": logging.ERROR,
        }.get(self.options.get("priority", "info").lower(), logging.INFO)
        log.log(level, "%s%s", prefix, payload)


# ---------------------------------------------------------------------------
# Distributed (multi-endpoint) transport
# ---------------------------------------------------------------------------


class DistributionStrategy:
    """Chooses destination indices per event among the ACTIVE
    destinations — failed endpoints leave the rotation until their
    reconnect succeeds (reference: stream/output/sink/distributed/
    DistributionStrategy.java:71 destinationFailed /
    destinationAvailable)."""

    def init(self, n_destinations: int, options: Dict[str, str], definition):
        self.n = n_destinations
        self.options = options
        self.definition = definition
        self.active: List[int] = list(range(n_destinations))

    def destination_failed(self, d: int):
        if d in self.active:
            self.active = [x for x in self.active if x != d]

    def destination_available(self, d: int):
        if d not in self.active:
            self.active = sorted(self.active + [d])

    def destinations_for(self, event: Event) -> List[int]:
        raise NotImplementedError


class RoundRobinDistributionStrategy(DistributionStrategy):
    def init(self, n_destinations, options, definition):
        super().init(n_destinations, options, definition)
        self._i = 0

    def destinations_for(self, event: Event) -> List[int]:
        if not self.active:
            return []
        d = self.active[self._i % len(self.active)]
        self._i += 1
        return [d]


class PartitionedDistributionStrategy(DistributionStrategy):
    """Hashes the ``partitionKey`` attribute onto a destination
    (reference: PartitionedDistributionStrategy.java).  Uses crc32, not
    Python's per-process-randomized hash(), so a key maps to the same
    destination across restarts."""

    def init(self, n_destinations, options, definition):
        super().init(n_destinations, options, definition)
        key = options.get("partitionKey")
        if key is None or key not in definition.attribute_names:
            raise ValueError(
                "partitioned distribution needs a 'partitionKey' option "
                "naming a stream attribute"
            )
        self._idx = definition.attribute_names.index(key)

    def destinations_for(self, event: Event) -> List[int]:
        import zlib

        if event is None:
            raise SiddhiAppRuntimeError(
                "partitioned distribution needs per-event context "
                "(a 1:1 sink mapper)")
        if not self.active:
            return []
        # sticky primary over the TOTAL destination count: keys on
        # healthy endpoints keep their affinity through another
        # endpoint's outage; only the failed endpoint's keys redirect
        h = zlib.crc32(str(event.data[self._idx]).encode())
        primary = h % self.n
        if primary in self.active:
            return [primary]
        return [self.active[h % len(self.active)]]


class BroadcastDistributionStrategy(DistributionStrategy):
    def destinations_for(self, event: Event) -> List[int]:
        return list(self.active)


_STRATEGIES = {
    "roundrobin": RoundRobinDistributionStrategy,
    "partitioned": PartitionedDistributionStrategy,
    "broadcast": BroadcastDistributionStrategy,
}


class DistributedSink(Sink):
    """One logical sink fanned out over N destination connections
    (reference: distributed/DistributedTransport.java + strategies).

    Built from ``@sink(..., @distribution(strategy='...',
    @destination(...), ...))``: each @destination's options overlay the
    parent sink options for its child connection.
    """

    def __init__(self, child_factory, destination_options: List[Dict[str, str]],
                 strategy_name: str, strategy_options: Dict[str, str]):
        cls = _STRATEGIES.get(strategy_name.lower().replace("_", ""))
        if cls is None:
            raise ValueError(f"unknown distribution strategy '{strategy_name}'")
        self._child_factory = child_factory
        self._destination_options = destination_options
        self.strategy: DistributionStrategy = cls()
        self._strategy_options = strategy_options
        self.children: List[Sink] = []

    def init(self, definition, options, mapper, app_context):
        super().init(definition, options, mapper, app_context)
        self.strategy.init(
            len(self._destination_options),
            {**options, **self._strategy_options},
            definition,
        )
        for dest in self._destination_options:
            child = self._child_factory()
            child.init(definition, {**options, **dest}, mapper, app_context)
            self.children.append(child)

    def start(self):
        for c in self.children:
            # children follow the same stream-level @OnError contract
            c.stream_junction = self.stream_junction
            c.start()

    def shutdown(self):
        for c in self.children:
            c.shutdown()

    def send_batch(self, batch: EventBatch):
        events = self._intercepted_events(batch)
        if not events:
            return
        # sync the rotation with observable endpoint health: re-admit
        # reconnected children, evict already-down ones (e.g. a failed
        # initial connect) BEFORE routing so their events go to healthy
        # endpoints instead of the drop path
        for d, c in enumerate(self.children):
            if c.connected and d not in self.strategy.active:
                self.strategy.destination_available(d)
            elif not c.connected and d in self.strategy.active:
                self.strategy.destination_failed(d)
        payloads = self.mapper.map(events)
        pairs = (zip(events, payloads) if len(payloads) == len(events)
                 else ((None, p) for p in payloads))
        for event, payload in pairs:
            dests = self.strategy.destinations_for(event)
            if not dests:
                # every destination down: the drop must stay diagnosable
                # (and fault-routable — keep the event context)
                self._tls.event = event
                try:
                    self.on_error(payload, ConnectionUnavailableError(
                        "no active destinations"))
                finally:
                    self._tls.event = None
                continue
            for d in dests:
                child = self.children[d]
                child._tls.event = event  # dynamic-option context
                try:
                    child.publish_with_reconnect(payload)
                finally:
                    child._tls.event = None
                if not child.connected:
                    # endpoint down: drop it from rotation until its
                    # reconnect chain succeeds
                    self.strategy.destination_failed(d)
