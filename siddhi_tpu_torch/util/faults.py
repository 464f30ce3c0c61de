"""Deterministic fault injection and the crash-recovery journal.

Port of the JAX package's ``util/faults.py`` (host code, copied: the
port imports nothing of that package):

* :class:`FaultInjector` — a seeded, site-addressed fault registry on
  the app context (``@app:faults(...)``), consulted at the choke points
  the port wires.  Identical seed and identical event sequence give
  identical injections.

* :class:`InputJournal` — a bounded in-memory journal of
  post-checkpoint input batches keyed to ``SnapshotService`` revisions,
  so ``restore_last_revision()`` becomes restore-and-replay, plus an
  output ledger that suppresses the callback events each endpoint
  already received, so the recovered callback sequence equals an
  uninterrupted run's.

* Host-copy and poison helpers (``host_copy`` / ``poison_state`` /
  ``state_has_poison`` / ``good_copy`` / ``restore_good``): device
  tensors reach the host through ``core/emit_queue.fetch_coalesced``
  (``np.asarray`` raises on a CUDA tensor), and every device-to-host
  read of the NaN/Inf quarantine happens here, so the device modules
  stay free of syncs.  The last good state is a device clone, not a
  host copy as in the reference: a quarantine copies it back into the
  live tensors in place, dtypes and devices kept.

Injection sites (strings, ``layer.point``) the port wires
(``WIRED_SITES``); ``step.shard`` waits for the multi-device slice
(``UNWIRED_SITES``) and an app arming it is refused at creation:

========================  ================================================
``emit.drain``            coalesced device-to-host fetch in EmitQueue
                          (bounded retry with backoff on ``transient``)
``ingest.put``            ``staged_put``, the ingest-path host-to-device
                          copy (the same retry; checked before the copy)
``ingest``                InputHandler.send/send_batch under the process
                          lock, after the journal records the batch
``step.device``           a device query engine's step, a fused chain's
``step.dense``            a dense engine's step, a fused dense tail's
``sink.publish``          Sink.publish_with_reconnect
``sink.connect``          sink (re)connect attempts
``source.connect``        source (re)connect attempts
``timer``                 scheduler advance (``stall``: a clock stall)
``timer.fire``            one scheduled task's fire
``callback``              stream-junction callback dispatch
``state.poison``          device-state poisoning (``poison``)
``persist.write``         checkpoint store write (retryable; durability/)
``persist.post_blob``     crash point: element blobs durable, no manifest
``persist.pre_manifest``  crash point: before the manifest tmp write
``persist.mid_manifest``  crash point: manifest tmp durable, rename pending
``persist.post_manifest`` crash point: revision committed, journal mark not
``journal.spill``         journal-segment store write (retryable)
``journal.spill.mid``     crash point: segment durable, journal not trimmed
``replan.reseat``         crash point: replacement engines built, old not
                          torn down
``admission.shed``        the ``@app:limits`` admission controller sheds
``watchdog.trip``         the watchdog saw a stall, before its self-heal
``breaker.open``          a transport circuit breaker opens
========================  ================================================

Fault kinds:

``transient``  raises :class:`TransferFaultError` (retryable)
``sticky``     raises :class:`DeviceLostError` forever once armed
``error``      raises :class:`InjectedFaultError`
``conn``       raises :class:`ConnectionUnavailableError`
``crash``      raises :class:`SimulatedCrashError` (a BaseException)
``stall``      consumed via :meth:`FaultInjector.stalled`
``poison``     consumed via :meth:`FaultInjector.poisoned`
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.core.exceptions import (
    ConnectionUnavailableError,
    DeviceLostError,
    InjectedFaultError,
    SimulatedCrashError,
    TransferFaultError,
)

log = logging.getLogger("siddhi_tpu_torch.faults")

_KINDS = ("transient", "sticky", "error", "conn", "crash", "stall", "poison")

# Defaults for the hardening knobs (overridable via @app:faults(...)).
DEFAULT_TRANSFER_RETRY_ATTEMPTS = 3
DEFAULT_TRANSFER_RETRY_SCALE = 0.001  # seconds multiplier on the backoff ladder
DEFAULT_JOURNAL_DEPTH = 256

# the @app:faults keys that are settings, not sites
RESERVED_OPTIONS = frozenset(("seed", "transfer.retry.attempts",
                              "transfer.retry.scale", "journal",
                              "journal.depth"))
# the reference's sites the port does not consult yet: arming one is
# refused, since it would arm silently (any other name arms, as there)
UNWIRED_SITES = frozenset(("step.shard",))
# the injection sites the port consults (see the module note)
WIRED_SITES = frozenset((
    "emit.drain", "ingest.put", "ingest", "step.device", "step.dense",
    "sink.publish", "sink.connect", "source.connect", "timer", "timer.fire",
    "callback", "state.poison", "persist.write", "persist.post_blob",
    "persist.pre_manifest", "persist.mid_manifest", "persist.post_manifest",
    "journal.spill", "journal.spill.mid", "replan.reseat", "admission.shed",
    "watchdog.trip", "breaker.open"))


class FaultStats:
    """Counters for injected faults and the recovery machinery.

    ``StatisticsManager.fault_tracker`` publishes them on the statistics
    feed (``Faults.injector.<counter>``), whatever the level."""

    __slots__ = (
        "faults_injected",
        "transfer_retries",
        "drains_recovered",
        "drains_failed",
        "callback_faults_isolated",
        "poison_quarantines",
        "timer_stalls",
        "replayed_batches",
        "suppressed_events",
        "journal_dropped",
        "connect_retries_exhausted",
        # journal spill tier (durability/spill.py): overflow segments
        # persisted instead of dropped, and how replay used them
        "journal_spills",
        "spilled_batches",
        "spill_retries",
        "replayed_spilled_batches",
    )

    def __init__(self) -> None:
        for name in self.__slots__:
            setattr(self, name, 0)

    def as_dict(self) -> Dict[str, int]:
        return {name: getattr(self, name) for name in self.__slots__}


class FaultSpec:
    """One armed fault at one site.

    ``p``          probability each check trips (seeded RNG)
    ``remaining``  how many times it may trip (``sticky`` never decrements)
    ``after``      number of checks to skip before arming
    """

    __slots__ = ("site", "kind", "p", "remaining", "after", "fired")

    def __init__(self, site: str, kind: str, p: float = 1.0,
                 count: int = 1, after: int = 0) -> None:
        if kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r}; expected one of {_KINDS}")
        self.site = site
        self.kind = kind
        self.p = float(p)
        self.remaining = int(count)
        self.after = int(after)
        self.fired = 0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"FaultSpec({self.site!r}, {self.kind!r}, p={self.p}, "
                f"remaining={self.remaining}, after={self.after})")


class FaultInjector:
    """Seeded, site-addressed fault registry.

    Installed on ``AppContext.fault_injector`` by the planner when
    ``@app:faults(...)`` is present (or programmatically in tests).  All
    hook sites are no-ops when no spec targets them, so the harness adds
    a dict lookup per choke point when idle.
    """

    def __init__(self, seed: int = 0) -> None:
        import random as _random

        self.seed = int(seed)
        self._rng = _random.Random(self.seed)
        self._specs: Dict[str, List[FaultSpec]] = {}
        self._lock = threading.Lock()
        self.stats = FaultStats()
        # Wired by the planner to app_context.exception_listeners so
        # injected faults are observable like any runtime error.
        self.listeners: List[Any] = []
        # Hardening knobs (read by EmitQueue / sharded ingest).
        self.transfer_retry_attempts = DEFAULT_TRANSFER_RETRY_ATTEMPTS
        self.transfer_retry_scale = DEFAULT_TRANSFER_RETRY_SCALE
        # the app's tracer (observability/), wired by the planner: a
        # simulated crash dumps its flight recorder on the way out
        self.tracer = None

    # -- configuration ------------------------------------------------

    def configure(self, site: str, kind: str, p: float = 1.0,
                  count: int = 1, after: int = 0) -> "FaultInjector":
        """Arm a fault at ``site``.  Returns self for chaining.  A site
        the port does not consult raises: it would arm silently."""
        if site in UNWIRED_SITES:
            raise ValueError(
                f"fault site {site!r} is not wired in the port (wired: "
                f"{sorted(WIRED_SITES)}) — ROADMAP.md §1 item 16 "
                "(multi-device), a later slice of the port")
        spec = FaultSpec(site, kind, p=p, count=count, after=after)
        with self._lock:
            self._specs.setdefault(site, []).append(spec)
        return self

    def watches(self, site: str) -> bool:
        """True when any spec (armed or exhausted) targets ``site`` —
        gates expensive host-side guards (poison scans) to chaos runs."""
        with self._lock:
            return site in self._specs

    def clear(self, site: Optional[str] = None) -> None:
        with self._lock:
            if site is None:
                self._specs.clear()
            else:
                self._specs.pop(site, None)

    def configure_from_options(
            self, options: Dict[str, str]) -> Optional[int]:
        """Apply ``@app:faults(...)`` annotation options.

        Reserved keys: ``seed``, ``transfer.retry.attempts``,
        ``transfer.retry.scale``, ``journal`` / ``journal.depth``.
        Every other key is an injection site whose value is a fault spec
        ``kind[:k=v[:k=v...]]``, e.g.::

            @app:faults(seed='7', emit.drain='transient:count=2:p=0.5')

        Returns the requested journal depth (``None`` if journaling was
        not requested).
        """
        import random as _random

        journal_depth: Optional[int] = None
        for key, value in options.items():
            k = key.strip().lower()
            v = str(value).strip()
            if k == "seed":
                self.seed = int(v)
                self._rng = _random.Random(self.seed)
            elif k == "transfer.retry.attempts":
                self.transfer_retry_attempts = int(v)
            elif k == "transfer.retry.scale":
                self.transfer_retry_scale = float(v)
            elif k in ("journal", "journal.depth"):
                if v.lower() in ("true", "enable", "enabled"):
                    journal_depth = DEFAULT_JOURNAL_DEPTH
                elif v.lower() in ("false", "disable", "disabled"):
                    journal_depth = None
                else:
                    journal_depth = int(v)
            else:
                self._configure_spec(k, v)
        return journal_depth

    def _configure_spec(self, site: str, value: str) -> None:
        parts = [p.strip() for p in value.split(":") if p.strip()]
        if not parts:
            raise ValueError(f"empty fault spec for site {site!r}")
        kind = parts[0].lower()
        kwargs: Dict[str, float] = {}
        for part in parts[1:]:
            if "=" not in part:
                raise ValueError(
                    f"bad fault spec fragment {part!r} for site {site!r}")
            pk, pv = part.split("=", 1)
            pk = pk.strip().lower()
            if pk == "p":
                kwargs["p"] = float(pv)
            elif pk == "count":
                kwargs["count"] = int(pv)
            elif pk == "after":
                kwargs["after"] = int(pv)
            else:
                raise ValueError(
                    f"unknown fault spec key {pk!r} for site {site!r}")
        self.configure(site, kind, **kwargs)

    # -- runtime hooks ------------------------------------------------

    def _trip(self, site: str, kinds: Tuple[str, ...]) -> Optional[FaultSpec]:
        """Return the first armed spec at ``site`` among ``kinds`` that
        trips this check, decrementing its budget (sticky never does)."""
        with self._lock:
            specs = self._specs.get(site)
            if not specs:
                return None
            for spec in specs:
                if spec.kind not in kinds:
                    continue
                if spec.after > 0:
                    spec.after -= 1
                    continue
                if spec.kind != "sticky" and spec.remaining <= 0:
                    continue
                if spec.p < 1.0 and self._rng.random() >= spec.p:
                    continue
                if spec.kind != "sticky":
                    spec.remaining -= 1
                spec.fired += 1
                self.stats.faults_injected += 1
                return spec
        return None

    def check(self, site: str) -> None:
        """Raise the armed fault for ``site``, if any.

        Called at every raising choke point; no-op when nothing is armed.
        """
        spec = self._trip(site, ("transient", "sticky", "error", "conn",
                                 "crash"))
        if spec is None:
            return
        if spec.kind == "crash":
            log.warning("fault-injection: simulated crash at %s", site)
            if self.tracer is not None:
                try:
                    self.tracer.dump(f"fault-injector-crash:{site}")
                except Exception:  # noqa: BLE001 — the kill must win
                    log.exception("fault-injection: flight-recorder dump "
                                  "failed on simulated crash")
            raise SimulatedCrashError(f"injected crash at {site}")
        if spec.kind == "transient":
            e: Exception = TransferFaultError(
                f"injected transient transfer fault at {site}")
        elif spec.kind == "sticky":
            e = DeviceLostError(f"injected device loss at {site}")
        elif spec.kind == "conn":
            e = ConnectionUnavailableError(
                f"injected connection fault at {site}")
        else:
            e = InjectedFaultError(f"injected fault at {site}")
        log.debug("fault-injection: raising %s at %s", type(e).__name__, site)
        raise e

    def stalled(self, site: str) -> bool:
        """True when a ``stall`` fault trips at ``site`` (clock stall:
        the scheduler skips this advance instead of raising)."""
        spec = self._trip(site, ("stall",))
        if spec is not None:
            self.stats.timer_stalls += 1
            log.debug("fault-injection: clock stall at %s", site)
            return True
        return False

    def poisoned(self, site: str) -> bool:
        """True when a ``poison`` fault trips at ``site`` (the device
        runtime then corrupts its state with NaN to exercise the
        quarantine path)."""
        spec = self._trip(site, ("poison",))
        return spec is not None

    def notify(self, e: BaseException) -> None:
        """Feed an injected/handled fault to the runtime's exception
        listeners (best effort)."""
        for ln in list(self.listeners):
            try:
                ln(e)
            except Exception:  # pragma: no cover - listener bug
                log.exception("fault-injection: exception listener failed")


def isolate(tracer, fi, e: BaseException) -> None:
    """A batch died in isolation (a failed drain or finish): freeze
    ``tracer``'s span ring for the post-mortem and tell ``fi``'s
    exception listeners (either may be None)."""
    if tracer is not None:
        tracer.dump(f"onerror-isolation:{type(e).__name__}")
    if fi is not None:
        fi.notify(e)


def retry_site(fi, site: str, what: str) -> None:
    """Check ``site`` on ``fi`` (None: nothing armed), retrying a
    transient transfer fault with bounded backoff
    (``transfer.retry.attempts``, ``transfer.retry.scale``); a retry
    that succeeds counts ``drains_recovered``, each retry
    ``transfer_retries``.  Exhaustion, a sticky loss and any other fault
    raise.  ``what`` names the path in the WARNING."""
    if fi is None:
        return
    attempts = fi.transfer_retry_attempts
    attempt = 0
    backoff = None
    while True:
        try:
            fi.check(site)
            if attempt:
                fi.stats.drains_recovered += 1
            return
        except TransferFaultError:
            if attempt >= attempts:
                raise
            attempt += 1
            fi.stats.transfer_retries += 1
            if backoff is None:
                from siddhi_tpu_torch.transport.retry import (
                    BackoffRetryCounter,
                )

                backoff = BackoffRetryCounter(scale=fi.transfer_retry_scale)
            wait_s = backoff.get_time_interval_ms() / 1000.0
            backoff.increment()
            log.warning("%s: transient fault at %s (attempt %d/%d), "
                        "retrying in %.3fs", what, site, attempt, attempts,
                        wait_s)
            if wait_s > 0:
                time.sleep(wait_s)


# -- host copies and poison helpers ------------------------------------

def host_copy(state: Any) -> Any:
    """A state tree (dicts, lists, tuples, deques) with every tensor leaf
    fetched to numpy, all of them in one ``fetch_coalesced`` call (one
    device-to-host copy per group of tensors).  Other leaves are kept as
    they are; the tree's containers are new."""
    from siddhi_tpu_torch.core.emit_queue import fetch_coalesced

    tensors: List[Any] = []

    def collect(node: Any) -> None:
        if isinstance(node, torch.Tensor):
            tensors.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                collect(v)
        elif isinstance(node, (list, tuple, deque)):
            for v in node:
                collect(v)

    collect(state)
    fetched = iter(fetch_coalesced(tensors))

    def build(node: Any) -> Any:
        if isinstance(node, torch.Tensor):
            return next(fetched)
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        if isinstance(node, tuple):
            return tuple(build(v) for v in node)
        if isinstance(node, deque):
            return deque((build(v) for v in node), maxlen=node.maxlen)
        return node

    return build(state)


def _leaves(state: Any) -> List[Any]:
    if isinstance(state, dict):
        out: List[Any] = []
        for v in state.values():
            out.extend(_leaves(v))
        return out
    if isinstance(state, (tuple, list)):
        out = []
        for v in state:
            out.extend(_leaves(v))
        return out
    return [state]


def state_has_poison(state: Any) -> bool:
    """True when any float leaf of ``state`` contains NaN/Inf.

    Each tensor leaf reduces to one finite flag on its device and the
    flags cross to the host in one ``fetch_coalesced`` call; callers
    gate this behind an armed injector, so the hot path stays
    transfer-free."""
    from siddhi_tpu_torch.core.emit_queue import fetch_coalesced

    flags = []
    for leaf in _leaves(state):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and leaf.numel():
                flags.append(torch.isfinite(leaf).all())
        elif (isinstance(leaf, np.ndarray) and leaf.dtype.kind == "f"
              and leaf.size and not np.isfinite(leaf).all()):
            return True
    return bool(flags) and not all(bool(f) for f in fetch_coalesced(flags))


def good_copy(state: Any) -> Any:
    """The quarantine's last good state: tensor leaves cloned on their
    device, numpy leaves copied, other leaves kept."""

    def walk(node: Any) -> Any:
        if isinstance(node, torch.Tensor):
            return node.clone()
        if isinstance(node, np.ndarray):
            return node.copy()
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            seq = [walk(v) for v in node]
            return tuple(seq) if isinstance(node, tuple) else seq
        return node

    return walk(state)


def restore_good(state: Any, good: Any) -> Any:
    """``state`` with every leaf set back to ``good``'s (a
    ``good_copy``): a tensor of the same shape and dtype is written in
    place, so a holder of the live tensor sees the restore; any other
    leaf is replaced by a copy of the good one."""

    def walk(node: Any, g: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(node[k], g[k]) if k in g else node[k]
                    for k in node}
        if isinstance(node, (tuple, list)):
            seq = [walk(a, b) for a, b in zip(node, g)]
            return tuple(seq) if isinstance(node, tuple) else seq
        if (isinstance(node, torch.Tensor) and isinstance(g, torch.Tensor)
                and node.shape == g.shape and node.dtype == g.dtype):
            return node.copy_(g)
        if isinstance(g, (torch.Tensor, np.ndarray)):
            return g.clone() if isinstance(g, torch.Tensor) else g.copy()
        return g

    return walk(state, good)


def poison_guard(fi, state: Any, last_good: Any, init_state):
    """The device runtimes' NaN/Inf quarantine, active only while a
    ``state.poison`` fault is armed on ``fi``: poisons ``state`` when
    the fault trips, then checks it.  Returns ``(state, last_good,
    quarantined)``: a clean state becomes the new restore point; a
    poisoned one is set back to ``last_good`` (``init_state()`` when
    there is none) and counted, and the caller drops the batch's
    outputs."""
    if fi is None or not fi.watches("state.poison"):
        return state, last_good, False
    if fi.poisoned("state.poison"):
        state = poison_state(state)
    if not state_has_poison(state):
        return state, good_copy(state), False
    fi.stats.poison_quarantines += 1
    if last_good is not None:
        log.error("device state poisoned (NaN/Inf); quarantining batch "
                  "and re-materializing last clean state")
        state = restore_good(state, last_good)
    else:
        log.error("device state poisoned (NaN/Inf) with no clean copy; "
                  "quarantining batch and re-initializing")
        state = init_state()
    return state, last_good, True


def poison_state(state: Any) -> Any:
    """Return ``state`` with the first float leaf multiplied by NaN
    (structure and dtypes preserved).  Used by the ``poison`` fault."""

    done = {"v": False}

    def is_float(node: Any) -> bool:
        if isinstance(node, torch.Tensor):
            return node.is_floating_point() and node.numel() > 0
        return (isinstance(node, np.ndarray) and node.dtype.kind == "f"
                and node.size > 0)

    def _walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: _walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            seq = [_walk(v) for v in node]
            return tuple(seq) if isinstance(node, tuple) else seq
        if not done["v"] and is_float(node):
            done["v"] = True
            return node * float("nan")
        return node

    return _walk(state)


# -- input journal + output ledger ------------------------------------

class InputJournal:
    """Bounded in-memory journal of input batches for restore-and-replay.

    ``record`` captures every batch entering an ``InputHandler`` (under
    the app's process lock, so ordering matches delivery order).
    ``mark_revision`` pins the journal to a ``SnapshotService`` revision
    at persist time and snapshots the per-endpoint output counts; after
    a crash, ``entries_after(revision)`` yields exactly the batches the
    checkpoint has not seen, and ``deliver`` suppresses the prefix of
    re-emitted output events each callback/sink already received, so the
    observable sequence is bit-identical to an uninterrupted run.

    The journal is bounded (``depth`` batches).  On overflow it first
    tries to SPILL the coldest ``spill_chunk`` entries to the
    persistence store through ``spill_sink``
    (durability/spill.py JournalSpillSink, attached by the planner);
    replay then stitches spilled + in-memory segments.  Without a
    spill-capable store the old behavior stands: the oldest entry is
    dropped and replay across the gap is refused (``entries_after``
    returns ``None``) because a gapped replay would silently diverge.

    Async persistence splits the old ``mark_revision`` into
    ``note_capture`` (at capture time, under the barrier: records the
    sequence watermark + output-ledger counts, prunes NOTHING) and
    ``commit_revision`` (after the store committed the revision: prunes
    entries and spilled segments at or below the watermark).  A crash
    between the two leaves both the previous and the new revision
    replayable; ``drop_mark`` abandons the mark of a failed/coalesced
    persist.  ``mark_revision`` (= note + commit) remains the
    synchronous-path entry point.
    """

    def __init__(self, depth: int = DEFAULT_JOURNAL_DEPTH,
                 spill_chunk: Optional[int] = None) -> None:
        self.depth = int(depth)
        # how many cold entries move per spill (amortizes store writes)
        self.spill_chunk = int(spill_chunk) if spill_chunk else max(
            1, self.depth // 2)
        self._lock = threading.RLock()
        self._entries: deque = deque()  # (seq, stream_id, batch)
        self._seq = 0
        self._revision: Optional[str] = None  # newest COMMITTED revision
        self._rev_seq = -1
        self._gap = False
        # seqs <= _gap_seq were dropped without spill (unrecoverable)
        self._gap_seq = 0
        # revision -> (seq watermark, output-ledger counts at capture)
        self._marks: Dict[str, Tuple[int, Dict[Any, int]]] = {}
        # spilled segment seq ranges [(seq0, seq1)], oldest first
        self._segments: List[Tuple[int, int]] = []
        # durability/spill.py JournalSpillSink (None = no spill tier)
        self.spill_sink: Optional[Any] = None
        # Output ledger: per-endpoint delivered-event counts.
        self._counts: Dict[Any, int] = {}
        self._marked_counts: Dict[Any, int] = {}
        self._remaining: Dict[Any, int] = {}
        self.replaying = False
        # replaced with the app's FaultInjector.stats by the planner so
        # journal counters ride the same statistics feed
        self.stats: FaultStats = FaultStats()

    # -- recording ----------------------------------------------------

    def record(self, stream_id: str, batch: Any) -> None:
        with self._lock:
            if self.replaying:
                return
            self._seq += 1
            self._entries.append((self._seq, stream_id, batch))
            if len(self._entries) > self.depth:
                self._overflow_locked()

    def _overflow_locked(self) -> None:
        while len(self._entries) > self.depth:
            sink = self.spill_sink
            if sink is not None:
                n = min(self.spill_chunk, len(self._entries))
                chunk = [self._entries[i] for i in range(n)]
                seq0, seq1 = chunk[0][0], chunk[-1][0]
                ok = False
                try:
                    # a `crash` fault (BaseException) propagates out of
                    # here by design — mid-spill kill of the matrix
                    ok = sink.spill(seq0, seq1, chunk, stats=self.stats)
                except Exception:
                    log.exception("journal: spill sink failed; falling "
                                  "back to dropping")
                if ok:
                    for _ in range(n):
                        self._entries.popleft()
                    self._segments.append((seq0, seq1))
                    if self.stats is not None:
                        self.stats.journal_spills += 1
                        self.stats.spilled_batches += n
                    continue
            seq, _sid, _b = self._entries.popleft()
            self._gap_seq = max(self._gap_seq, seq)
            self._gap = True
            if self.stats is not None:
                self.stats.journal_dropped += 1

    def note_capture(self, revision: str) -> None:
        """Record the checkpoint watermark of ``revision`` at CAPTURE
        time (under the barrier).  Prunes nothing — the revision is not
        durable yet."""
        with self._lock:
            self._marks[revision] = (self._seq, dict(self._counts))

    def drop_mark(self, revision: str) -> None:
        """Abandon the mark of a failed or coalesced persist."""
        with self._lock:
            self._marks.pop(revision, None)

    def commit_revision(self, revision: str) -> None:
        """The store committed ``revision``: prune entries and spilled
        segments its checkpoint covers.  No-op on an unknown/superseded
        mark (a commit arriving after a newer one already pruned)."""
        with self._lock:
            mark = self._marks.get(revision)
            if mark is None:
                return
            watermark, counts = mark
            while self._entries and self._entries[0][0] <= watermark:
                self._entries.popleft()
            prune_upto = 0
            keep = []
            for (s0, s1) in self._segments:
                if s1 <= watermark:
                    prune_upto = max(prune_upto, s1)
                else:
                    keep.append((s0, s1))
            self._segments = keep
            if prune_upto and self.spill_sink is not None:
                try:
                    self.spill_sink.prune(prune_upto)
                except Exception:
                    log.exception("journal: spilled-segment prune failed")
            # marks with older watermarks are superseded by this commit
            self._marks = {r: m for r, m in self._marks.items()
                           if m[0] >= watermark}
            self._revision = revision
            self._rev_seq = watermark
            self._marked_counts = counts
            if self._gap_seq <= watermark:
                self._gap = False

    def mark_revision(self, revision: str) -> None:
        """Synchronous-path pin: capture mark + immediate commit."""
        self.note_capture(revision)
        self.commit_revision(revision)

    def entries_after(self, revision: str) -> Optional[List[Tuple[str, Any]]]:
        """Batches recorded after ``revision``'s capture, oldest first —
        stitched from spilled segments + the in-memory tail, deduped by
        sequence number (mid-spill crashes leave an overlap).

        ``None`` when replay is impossible: unknown/unmarked revision,
        an unspilled overflow gap past the watermark, or unreadable
        spilled segments."""
        with self._lock:
            mark = self._marks.get(revision)
            if mark is None:
                return None
            watermark = mark[0]
            if self._gap_seq > watermark:
                return None
            if self._seq <= watermark:
                return []
            collected: Dict[int, Tuple[str, Any]] = {}
            spilled_needed = [s for s in self._segments if s[1] > watermark]
            if spilled_needed:
                sink = self.spill_sink
                loaded = sink.load_segments() if sink is not None else None
                if loaded is None:
                    return None
                for _s0, s1, seg_entries in loaded:
                    if s1 <= watermark:
                        continue
                    for seq, sid, b in seg_entries:
                        if seq > watermark:
                            collected[seq] = (sid, b)
            mem_seqs = set()
            for seq, sid, b in self._entries:
                if seq > watermark:
                    collected[seq] = (sid, b)
                    mem_seqs.add(seq)
            needed = range(watermark + 1, self._seq + 1)
            if any(s not in collected for s in needed):
                return None
            if self.stats is not None:
                self.stats.replayed_spilled_batches += sum(
                    1 for s in needed if s not in mem_seqs)
            return [collected[s] for s in needed]

    # -- replay + output dedup ---------------------------------------

    def begin_replay(self, revision: Optional[str] = None) -> None:
        with self._lock:
            base = self._marked_counts
            if revision is not None:
                mark = self._marks.get(revision)
                if mark is not None:
                    base = mark[1]
            self.replaying = True
            # Suppress exactly the delta each endpoint saw between the
            # checkpoint and the crash; counts restart from the mark.
            self._remaining = {
                k: self._counts.get(k, 0) - base.get(k, 0)
                for k in self._counts
            }
            self._counts = dict(base)

    def end_replay(self) -> None:
        with self._lock:
            self.replaying = False
            self._remaining = {}

    def deliver(self, key: Any, batch: Any):
        """Ledger gate for an output endpoint (callback / sink).

        Counts delivered events; during replay, suppresses the prefix
        the endpoint already received before the crash.  Returns the
        batch to actually deliver (possibly trimmed) or ``None`` when
        fully suppressed."""
        try:
            n = len(batch)
        except TypeError:
            n = 1
        if n == 0:
            return batch
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n
            if not self.replaying:
                return batch
            rem = self._remaining.get(key, 0)
            if rem <= 0:
                return batch
            k = min(rem, n)
            self._remaining[key] = rem - k
            if self.stats is not None:
                self.stats.suppressed_events += k
            if k == n:
                return None
            take = getattr(batch, "take", None)
            if take is None:  # pragma: no cover - non-batch payloads
                return batch
            return take(np.arange(k, n))

    # -- live re-plan ---------------------------------------------------
    #
    # A live re-plan (core/app_runtime.py replan) rebuilds the engines
    # empty: no revision to restore, so the journal replays the WHOLE
    # history into them and the output ledger suppresses every event
    # each endpoint already received.

    def covers_from_start(self) -> bool:
        """True while the in-memory journal holds every batch since the
        app started: no overflow, nothing spilled, nothing pruned."""
        with self._lock:
            if self._gap or self._segments:
                return False
            if self._seq == 0:
                return True
            return (bool(self._entries) and self._entries[0][0] == 1
                    and len(self._entries) == self._seq)

    def all_entries(self) -> List[Tuple[str, Any]]:
        """Every recorded batch, oldest first (the caller checked
        :meth:`covers_from_start`)."""
        with self._lock:
            return [(sid, b) for _seq, sid, b in self._entries]

    def begin_replay_from_start(self) -> None:
        """Arm the ledger for a full-history replay: each endpoint's
        whole delivered count is its suppression budget, and the counts
        rebuild from zero as the replay re-delivers."""
        with self._lock:
            self.replaying = True
            self._remaining = dict(self._counts)
            self._counts = {}

    def reset(self) -> None:
        """Forget everything (restore from raw bytes / fresh start)."""
        with self._lock:
            self._entries.clear()
            self._seq = 0
            self._revision = None
            self._rev_seq = -1
            self._gap = False
            self._gap_seq = 0
            self._marks = {}
            self._segments = []
            if self.spill_sink is not None:
                try:
                    self.spill_sink.clear()
                except Exception:
                    log.exception("journal: spilled-segment clear failed")
            self._counts = {}
            self._marked_counts = {}
            self._remaining = {}
            self.replaying = False
