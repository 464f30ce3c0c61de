"""App-level annotations: the subset the port's product path reads.

Port of the annotation half of the JAX package's
``planner/app_planner.py``, with the reference's error messages:

- ``@app:name`` and ``@app:playback(idle.time=, increment=)`` (event
  time drives the clock; ``increment`` is added to it, and with
  ``idle.time`` the app runtime's heartbeat advances it by
  ``increment`` when no event arrives for that long);
- ``@app:execution('tpu', partitions=, instances=, devices=,
  emit.depth=, ingest.depth=, agg.device.min.batch=)``: ``devices='N'``
  shards the partition axis over an N-shard mesh (``parallel/``), and
  ``partitions`` must divide by it;
- ``@app:plan(auto=, hysteresis=, interval=)``: the cost model's own
  choice of each query's lowering (``planner/costmodel.py``), the plan
  monitor's re-plan margin and its sweep interval
  (``planner/monitor.py``);
- ``@app:hotkeys(k=, promote=, demote=)``;
- ``@app:kernels`` / ``@app:kernels('nfa,scan,bank')``;
- ``@app:persist(interval=, mode=)`` (the default ``persist()`` mode and
  the periodic-checkpoint daemon's interval);
- ``@app:faults(seed=, journal=, transfer.retry.*=, <site>=...)``: the
  fault injector and the input journal, which lives on the manager
  context, keyed by app name, so a runtime built after a crash replays
  it;
- ``@app:multiplex(slots=)``: this app's eligible queries take seats
  in the manager's shared device engines (``multiplex/``);
- ``@app:fuse`` / ``@app:fuse('false')``: stream-graph fusion of
  ``insert into`` chains of device queries (``planner/fusion.py``); a
  query it fuses under ``@app:multiplex`` records the precedence
  conflict (fuse wins) in ``AppContext.planner_conflicts``;
- ``@app:devtables(capacity=)``: device-resident tables
  (``devtable/``);
- ``@app:enforceOrder``: a flag, as in the reference (the synchronous
  dispatch is ordered by construction).

The transport half of the reference's planner is here too
(``attach_transports``): each ``@source``/``@sink`` on a stream
definition, its options merged from the config manager's ``ref=``
(``resolve_ref``), its mapper from a nested ``@map``, a ``@distribution``
with its ``@destination``s, and the source and sink handlers of the
manager's handler managers.

- ``@app:statistics('true'|'basic'|'detail', interval=)``: the
  statistics manager's level (every app has a manager; the fault,
  durability and robustness counters register on it whatever the
  level);
- ``@app:trace(sample='1/N', cycles=, dir=)``: the span tracer and its
  flight recorder (every app has one, at 1 in 64 by default);
- ``@app:limits(rate=, burst=, shed=, block.max=, watchdog=, breaker=,
  breaker.cooldown=, ladder=)``: admission control, the watchdog, the
  transport circuit breakers and the degradation ladder
  (``robustness/``).

The port runs its kernels on the card whenever it runs on a card: it
has no XLA formulation to keep, so ``@app:kernels`` is parsed and
validated as the reference does and switches nothing, and the
degradation ladder has no ``kernels`` rung (``robustness/ladder.py``).
An ``@app:`` name the reference does not know is ignored, as there.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, List

from siddhi_tpu_torch.compiler.parser import parse_time_string
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.durability.spill import JournalSpillSink
from siddhi_tpu_torch.query_api.annotation import find_annotation
from siddhi_tpu_torch.util.faults import FaultInjector, InputJournal
from siddhi_tpu_torch.util.scheduler import Scheduler
from siddhi_tpu_torch.util.statistics import Level, StatisticsManager

class TimestampGenerator:
    """Event/wall time source: under ``@app:playback`` the current time
    is the latest event time plus ``increment_ms`` (0 before the first
    event), else the wall clock (ms)."""

    def __init__(self, playback: bool = False, increment_ms: int = 0):
        self.playback = playback
        self.increment_ms = increment_ms
        self._event_time = -1
        self.last_update_wall = time.monotonic()

    def current_time(self) -> int:
        if self.playback:
            return (self._event_time + self.increment_ms
                    if self._event_time >= 0 else 0)
        return int(time.time() * 1000)

    def set_event_time(self, ts: int):
        self.last_update_wall = time.monotonic()
        if ts > self._event_time:
            self._event_time = ts

    def advance_idle(self) -> int:
        """Idle heartbeat: push event time forward by the increment when
        no events arrive; returns the new current time."""
        self.last_update_wall = time.monotonic()
        if self._event_time >= 0:
            self._event_time += self.increment_ms
        return self.current_time()


class ProgressBeat:
    """The watchdog's liveness counter (``robustness/watchdog.py``):
    one increment a journaled ingest and a junction dispatch, so a
    batch, not an event, pays for it."""

    __slots__ = ("beats",)

    def __init__(self):
        self.beats = 0

    def beat(self):
        self.beats += 1


class AppContext:
    """Per-app settings the planner and the runtimes read."""

    def __init__(self, name: str, device):
        self.name = name
        self.device = device
        self.playback = False
        # @app:playback(idle.time=): the heartbeat period, 0 = none
        self.playback_idle_ms = 0
        self.timestamp_generator = TimestampGenerator()
        # input sends, scheduler ticks and the heartbeat run under it
        self.process_lock = threading.RLock()
        self.scheduler = Scheduler(self)
        self.execution_mode = "host"
        # dense pattern state: partition rows and instance lanes per
        # (partition, node), as in the reference
        self.tpu_partitions = 65536
        self.tpu_instances = 4
        # a positive int or "auto"
        self.tpu_emit_depth = 1
        self.tpu_ingest_depth = 1
        # smallest batch whose transient per-segment aggregation reduce
        # rides the device (the bucket bank itself takes every size)
        self.tpu_agg_min_batch = 512
        self.hotkeys = False
        self.hotkey_k = 8
        self.hotkey_promote = 0.25
        self.hotkey_demote = 0.10
        self.kernels = False
        self.kernel_kinds = ("nfa", "bank", "scan")
        # query name -> why @app:hotkeys left it on the dense path
        self.hotkey_fallbacks: Dict[str, str] = {}
        # @app:multiplex: seats in the manager's shared device engines
        self.multiplex = False
        self.multiplex_slots = 8
        # query name -> why it kept a dedicated engine
        self.multiplex_fallbacks: Dict[str, str] = {}
        # query name -> the annotation precedence resolved against it
        self.planner_conflicts: Dict[str, str] = {}
        # @app:fuse: chains of device queries lowered to one engine
        self.fuse = False
        # query name -> why its chain fell back to junction dispatch
        self.fused_fallbacks: Dict[str, str] = {}
        # @app:devtables: device-resident tables of at most this many
        # slots each
        self.devtables = False
        self.devtable_capacity = 1024
        # table or query -> why it stayed on the host
        self.devtable_fallbacks: Dict[str, str] = {}
        # @app:enforceOrder: kept for parity; the dispatch is ordered
        self.enforce_order = False
        # runtime exception listeners: every error the app logs instead
        # of raising (a failing receiver, callback, emit or timer task)
        self.exception_listeners: List = []
        # @app:persist: persist()'s default mode ('sync' or 'async') and
        # the periodic-checkpoint daemon's interval (0 = no daemon)
        self.persist_mode = "sync"
        self.persist_interval_ms = 0
        # @app:faults: the fault injector (None = every hook site a
        # no-op) and the input journal (None = no journaling)
        self.fault_injector = None
        self.input_journal = None
        # @app:statistics: the manager (every app has one) and its level
        self.root_metrics_level = Level.OFF
        self.statistics_manager = None
        # the span tracer and its flight recorder (@app:trace)
        self.tracer = None
        # @app:limits: overload protection (robustness/); without the
        # annotation every hook is None
        self.limits_rate = 0.0
        self.limits_burst = 0.0
        self.limits_shed = "drop"
        self.limits_block_max_ms = 1000
        self.watchdog_deadline_ms = 0
        self.breaker_threshold = 0
        self.breaker_cooldown_ms = 1000
        self.ladder = False
        self.robustness = None
        self.admission = None
        # the ladder's rung and the features it turned off (a rebuilt
        # context's flags no longer show them)
        self.degrade_level = 0
        self.degraded_features = ()
        # watchdog liveness: one beat a journaled ingest and a dispatch
        self.progress = ProgressBeat()
        # a replan's per-query path pins ('device', 'fuse',
        # 'dense+hotkey', 'device+shard', 'host')
        self.plan_pins: Dict[str, str] = {}
        # @app:plan: the cost model picks each unpinned query's lowering;
        # the plan monitor's re-plan margin and sweep interval (0: no
        # sweep, decide() on demand only)
        self.plan_auto = False
        self.plan_hysteresis = 0.3
        self.plan_interval_ms = 0
        # @app:execution(devices='N'): the mesh's shard count (None: one
        # device)
        self.tpu_devices = None
        # the app's running gate (set by start and shutdown)
        self.app_running = False


def _positive_int(ann, key: str, what: str) -> int:
    raw = ann.element(key)
    try:
        n = int(raw)
    except ValueError:
        n = -1
    if n < 1:
        raise SiddhiAppCreationError(
            f"@app:execution: {key}='{raw}' must be {what}")
    return n


def _time_ms(v) -> int:
    """An ``@app:playback`` time element: ms as an integer or a time
    string (``'2 sec'``); absent is 0.  Anything else raises
    ``SiddhiParserError``, as the reference does."""
    if v is None:
        return 0
    try:
        return int(v)
    except ValueError:
        return parse_time_string(v)


def plan_app_context(siddhi_app, device, siddhi_context,
                     app_name: str = None) -> AppContext:
    """Read the app annotations into an ``AppContext``; the input
    journal is the manager context's (``siddhi_context``).
    ``app_name``: a live re-plan's, which keeps the app's (an unnamed
    app's too)."""
    anns = siddhi_app.annotations
    name_ann = find_annotation(anns, "app:name")
    ctx = AppContext(app_name or (name_ann.element() if name_ann else None)
                     or f"app_{uuid.uuid4().hex[:8]}", device)
    playback = find_annotation(anns, "app:playback")
    if playback is not None:
        ctx.playback = True
        ctx.timestamp_generator = TimestampGenerator(
            playback=True,
            increment_ms=_time_ms(playback.element("increment")))
        ctx.playback_idle_ms = _time_ms(playback.element("idle.time"))

    exec_ann = find_annotation(anns, "app:execution")
    if exec_ann is not None:
        mode = (exec_ann.element() or "host").lower()
        if mode not in ("host", "tpu"):
            raise SiddhiAppCreationError(
                f"@app:execution('{mode}'): mode must be 'host' or 'tpu'")
        ctx.execution_mode = mode
        if exec_ann.element("partitions"):
            ctx.tpu_partitions = _positive_int(
                exec_ann, "partitions", "a positive integer")
        if exec_ann.element("instances"):
            ctx.tpu_instances = _positive_int(
                exec_ann, "instances", "a positive integer")
        devs = exec_ann.element("devices")
        if devs:
            try:
                nd = int(devs)
            except ValueError:
                nd = -1
            if nd < 1:
                raise SiddhiAppCreationError(
                    f"@app:execution: devices='{devs}' must be a "
                    "positive integer")
            ctx.tpu_devices = nd
            if ctx.tpu_partitions % nd:
                raise SiddhiAppCreationError(
                    f"@app:execution: partitions={ctx.tpu_partitions} "
                    f"must be divisible by devices={nd}")
        for key, attr in (("emit.depth", "tpu_emit_depth"),
                          ("ingest.depth", "tpu_ingest_depth")):
            raw = exec_ann.element(key)
            if not raw:
                continue
            # 'auto': the adaptive depth (core/emit_queue.py
            # EmitDepthController) from the drain round trip over the
            # batch cadence
            setattr(ctx, attr, "auto" if raw.lower() == "auto" else
                    _positive_int(exec_ann, key,
                                  "a positive integer or 'auto'"))

        amb = exec_ann.element("agg.device.min.batch")
        if amb:
            try:
                nab = int(amb)
            except ValueError:
                nab = -1
            if nab < 1:
                raise SiddhiAppCreationError(
                    f"@app:execution: agg.device.min.batch='{amb}' must "
                    "be a positive integer")
            ctx.tpu_agg_min_batch = nab

    hk_ann = find_annotation(anns, "app:hotkeys")
    if hk_ann is not None:
        if ctx.execution_mode != "tpu":
            raise SiddhiAppCreationError(
                "@app:hotkeys needs @app:execution('tpu')")
        ctx.hotkeys = True
        k = hk_ann.element("k") or hk_ann.element()
        if k:
            try:
                nk = int(k)
            except ValueError:
                nk = -1
            if nk < 1 or nk > 256:
                raise SiddhiAppCreationError(
                    f"@app:hotkeys: k='{k}' must be an integer in "
                    "1..256 (scan slots per query)")
            ctx.hotkey_k = nk
        pr = hk_ann.element("promote")
        dm = hk_ann.element("demote")
        try:
            promote = float(pr) if pr else ctx.hotkey_promote
            demote = float(dm) if dm else ctx.hotkey_demote
        except ValueError:
            raise SiddhiAppCreationError(
                f"@app:hotkeys: promote='{pr}'/demote='{dm}' must be "
                "fractions of total traffic")
        if not (0.0 < promote <= 1.0) or not (0.0 <= demote < promote):
            raise SiddhiAppCreationError(
                f"@app:hotkeys: need 0 <= demote < promote <= 1 "
                f"(got promote={promote}, demote={demote}) — the "
                "hysteresis band prevents promote/demote thrash")
        ctx.hotkey_promote = promote
        ctx.hotkey_demote = demote

    # parsed and validated only: the port's steps are always its kernels
    kn_ann = find_annotation(anns, "app:kernels")
    if kn_ann is not None:
        if ctx.execution_mode != "tpu":
            raise SiddhiAppCreationError(
                "@app:kernels needs @app:execution('tpu')")
        v = (kn_ann.element() or "true").strip().lower()
        if v == "true":
            ctx.kernels = True
        elif v != "false":
            kinds = tuple(k.strip() for k in v.split(",") if k.strip())
            bad = [k for k in kinds if k not in ("nfa", "bank", "scan")]
            if bad or not kinds:
                raise SiddhiAppCreationError(
                    f"@app:kernels: unknown kernel kind(s) "
                    f"{bad or [v]} — valid kinds are 'nfa', 'bank', "
                    "'scan'")
            ctx.kernels = True
            ctx.kernel_kinds = kinds
    if find_annotation(anns, "app:enforceOrder") is not None:
        ctx.enforce_order = True
    _plan_multiplex(ctx, find_annotation(anns, "app:multiplex"))
    _plan_fuse(ctx, find_annotation(anns, "app:fuse"))
    _plan_devtables(ctx, find_annotation(anns, "app:devtables"))
    _plan_plan(ctx, find_annotation(anns, "app:plan"))
    _plan_statistics(ctx, find_annotation(anns, "app:statistics"))
    _plan_trace(ctx, find_annotation(anns, "app:trace"))
    _plan_faults(ctx, find_annotation(anns, "app:faults"), siddhi_context)
    _plan_persist(ctx, find_annotation(anns, "app:persist"))
    _plan_limits(ctx, find_annotation(anns, "app:limits"))
    return ctx


def _plan_plan(ctx: AppContext, ann):
    """``@app:plan(auto='true', hysteresis='0.3', interval='5 sec')``:
    with ``auto`` the cost model (``planner/costmodel.py``) scores every
    eligible lowering of each query without a pin and picks the
    cheapest (the fast-path annotations stay pins that override it);
    ``hysteresis`` is the plan monitor's re-plan margin and
    ``interval`` paces its sweep (0 = ``decide()`` on demand only)."""
    if ann is None:
        return
    if ctx.execution_mode != "tpu":
        raise SiddhiAppCreationError(
            "@app:plan needs @app:execution('tpu')")
    v = (ann.element("auto") or ann.element() or "true").strip().lower()
    if v not in ("true", "false"):
        raise SiddhiAppCreationError(
            f"@app:plan: auto='{v}' must be 'true' or 'false'")
    ctx.plan_auto = v == "true"
    hy = ann.element("hysteresis")
    if hy:
        try:
            h = float(hy)
        except ValueError:
            h = -1.0
        if not (0.0 <= h <= 10.0):
            raise SiddhiAppCreationError(
                f"@app:plan: hysteresis='{hy}' must be a fraction "
                "in 0..10 (margin before a live re-plan)")
        ctx.plan_hysteresis = h
    iv = ann.element("interval")
    if iv:
        try:
            ims = int(iv)
        except ValueError:
            ims = parse_time_string(iv)
        if ims <= 0:
            raise SiddhiAppCreationError(
                f"@app:plan: interval {iv!r} must be > 0")
        ctx.plan_interval_ms = ims


def _plan_statistics(ctx: AppContext, ann):
    """``@app:statistics('true'|'false'|'basic'|'detail',
    interval='S')``: the manager every app has, at the annotation's
    level (off without it), as the reference plans it."""
    level = Level.OFF
    interval_s = 60.0
    if ann is not None:
        v = (ann.element() or "true").lower()
        level = {"true": Level.BASIC, "false": Level.OFF,
                 "basic": Level.BASIC, "detail": Level.DETAIL,
                 }.get(v, Level.BASIC)
        iv = ann.element("interval")
        if iv:
            interval_s = float(iv)
    ctx.root_metrics_level = level
    ctx.statistics_manager = StatisticsManager(ctx.name, interval_s)


def _parse_trace_sample(value: str) -> int:
    """``@app:trace`` sample grammar: 'off' (no spans), '1' (every
    cycle), '1/N' or a bare 'N' (every Nth cycle)."""
    v = value.lower()
    if v in ("off", "false", "none"):
        return 0
    num, sep, den = v.partition("/")
    try:
        n = int(den) if sep else int(num)
        if sep and int(num) != 1:
            raise ValueError(num)
    except ValueError:
        raise SiddhiAppCreationError(
            f"@app:trace: sample='{value}' must be 'off', '1', 'N' or "
            "'1/N' (record every Nth batch cycle)")
    if n < 1 or n > 1_000_000:
        raise SiddhiAppCreationError(
            f"@app:trace: sample='{value}' out of range — the sampling "
            "stride must be in 1..1000000")
    return n


def _plan_trace(ctx: AppContext, ann):
    """``@app:trace(sample='1/64', cycles='64', dir='/path')``: the
    cycle tracer and its flight recorder, on by default at 1 in 64 (the
    recorder is what every fault dump reads); ``sample='off'`` records
    no span."""
    from siddhi_tpu_torch.observability import Tracer

    sample, cycles, dump_dir = Tracer.DEFAULT_SAMPLE, Tracer.DEFAULT_CYCLES, None
    if ann is not None:
        sv = ann.element("sample") or ann.element() or ""
        if sv.strip():
            sample = _parse_trace_sample(sv.strip())
        cv = ann.element("cycles")
        if cv:
            try:
                nc = int(cv)
            except ValueError:
                nc = -1
            if nc < 1 or nc > 4096:
                raise SiddhiAppCreationError(
                    f"@app:trace: cycles='{cv}' must be an integer in "
                    "1..4096 (flight-recorder depth in batch cycles)")
            cycles = nc
        dump_dir = ann.element("dir") or None
    ctx.tracer = Tracer(ctx.name, sample=sample, cycles=cycles,
                        dump_dir=dump_dir)
    ctx.statistics_manager.register_tracer(ctx.tracer)


def _limits_time_ms(ann, key: str):
    v = ann.element(key)
    if v is None:
        return None
    try:
        ms = int(v)
    except ValueError:
        ms = parse_time_string(v)
    if ms <= 0:
        raise SiddhiAppCreationError(f"@app:limits: {key}={v!r} must be > 0")
    return ms


def _plan_limits(ctx: AppContext, ann):
    """``@app:limits(rate='N/s', burst='M', shed='drop|oldest|block',
    block.max='1 sec', watchdog='2 sec', breaker='3',
    breaker.cooldown='1 sec', ladder='true')``, validated with the
    reference's texts.  Without it every hook stays None."""
    if ann is None:
        return
    from siddhi_tpu_torch.robustness import (
        AdmissionController,
        RobustnessStats,
    )
    from siddhi_tpu_torch.robustness.admission import SHED_POLICIES

    rate = ann.element("rate") or ann.element()
    if rate:
        r = rate.strip().lower()
        for suffix in ("/sec", "/s"):
            if r.endswith(suffix):
                r = r[: -len(suffix)]
                break
        try:
            ctx.limits_rate = float(r)
        except ValueError:
            ctx.limits_rate = -1.0
        if ctx.limits_rate <= 0:
            raise SiddhiAppCreationError(
                f"@app:limits: rate='{rate}' must be a positive "
                "events-per-second figure ('1000' or '1000/s')")
    burst = ann.element("burst")
    if burst:
        try:
            ctx.limits_burst = float(burst)
        except ValueError:
            ctx.limits_burst = -1.0
        if ctx.limits_burst < 1:
            raise SiddhiAppCreationError(
                f"@app:limits: burst='{burst}' must be >= 1 "
                "(token-bucket depth in events)")
        if not ctx.limits_rate:
            raise SiddhiAppCreationError("@app:limits: burst needs rate")
    elif ctx.limits_rate:
        ctx.limits_burst = max(ctx.limits_rate, 1.0)
    shed = ann.element("shed")
    if shed:
        if shed not in SHED_POLICIES:
            raise SiddhiAppCreationError(
                f"@app:limits: shed='{shed}' must be one of "
                f"{', '.join(SHED_POLICIES)}")
        if not ctx.limits_rate:
            raise SiddhiAppCreationError("@app:limits: shed needs rate")
        ctx.limits_shed = shed
    bm = _limits_time_ms(ann, "block.max")
    if bm is not None:
        ctx.limits_block_max_ms = bm
    wd = _limits_time_ms(ann, "watchdog")
    if wd is not None:
        ctx.watchdog_deadline_ms = wd
    br = ann.element("breaker")
    if br:
        try:
            nb = int(br)
        except ValueError:
            nb = -1
        if nb < 1:
            raise SiddhiAppCreationError(
                f"@app:limits: breaker='{br}' must be a positive "
                "integer (consecutive failures before opening)")
        ctx.breaker_threshold = nb
    bc = _limits_time_ms(ann, "breaker.cooldown")
    if bc is not None:
        ctx.breaker_cooldown_ms = bc
    lv = (ann.element("ladder") or "false").strip().lower()
    if lv not in ("true", "false"):
        raise SiddhiAppCreationError(
            f"@app:limits: ladder='{lv}' must be 'true' or 'false'")
    ctx.ladder = lv == "true"
    if ctx.ladder and not ctx.watchdog_deadline_ms:
        raise SiddhiAppCreationError(
            "@app:limits: ladder='true' needs watchdog='<deadline>'"
            " — the watchdog tick is what drives the ladder")
    if not (ctx.limits_rate or ctx.watchdog_deadline_ms
            or ctx.breaker_threshold):
        raise SiddhiAppCreationError(
            "@app:limits: needs at least one of rate, watchdog, breaker")
    ctx.robustness = RobustnessStats()
    if ctx.limits_rate:
        ctx.admission = AdmissionController(ctx, ctx.robustness)


def make_breaker(ctx: AppContext, name: str):
    """``@app:limits(breaker='N')``: one circuit breaker a transport
    endpoint, counting on the app's ``RobustnessStats``."""
    from siddhi_tpu_torch.robustness import CircuitBreaker

    return CircuitBreaker(name, threshold=ctx.breaker_threshold,
                          cooldown_ms=ctx.breaker_cooldown_ms,
                          stats=ctx.robustness,
                          fault_injector=ctx.fault_injector)


def _plan_multiplex(ctx: AppContext, ann):
    """``@app:multiplex`` / ``@app:multiplex(slots='N')``, with the
    reference's texts: it needs ``@app:execution('tpu')``, and ``slots``
    (a group's tenant capacity) is an integer in 2..64."""
    if ann is None:
        return
    if ctx.execution_mode != "tpu":
        raise SiddhiAppCreationError(
            "@app:multiplex needs @app:execution('tpu')")
    ctx.multiplex = True
    slots = ann.element("slots") or ann.element()
    if slots:
        try:
            ns = int(slots)
        except ValueError:
            ns = -1
        if ns < 2 or ns > 64:
            raise SiddhiAppCreationError(
                f"@app:multiplex: slots='{slots}' must be an integer in "
                "2..64")
        ctx.multiplex_slots = ns


def note_fallback(ctx: AppContext, family: str, name: str, reason: str):
    """A query, table or partition kept a slower path than its
    annotation asked for: the reason goes to ``ctx.<family>_fallbacks``
    and is counted on the statistics feed (``<family>Fallbacks``,
    ``<family>FallbackReason``), as the reference records it."""
    getattr(ctx, f"{family}_fallbacks")[name] = reason
    sm = ctx.statistics_manager
    if sm is not None:
        getattr(sm, f"record_{family}_fallback")(name, reason)


def note_fused_conflicts(ctx: AppContext, qname: str):
    """A query the fusion pre-pass claimed while ``@app:multiplex`` was
    also on the app: the precedence (fuse > multiplex) resolved it, and
    the losing pin is recorded, as the reference counts it."""
    if ctx.multiplex:
        ctx.planner_conflicts[qname] = (
            "@app:multiplex pinned but the query fused (precedence: fuse "
            "> multiplex)")
        if ctx.statistics_manager is not None:
            ctx.statistics_manager.record_planner_conflict(
                qname, ctx.planner_conflicts[qname])


def _plan_fuse(ctx: AppContext, ann):
    """``@app:fuse`` / ``@app:fuse('false')``, with the reference's
    texts."""
    if ann is None:
        return
    if ctx.execution_mode != "tpu":
        raise SiddhiAppCreationError("@app:fuse needs @app:execution('tpu')")
    v = (ann.element() or "true").lower()
    if v not in ("true", "false"):
        raise SiddhiAppCreationError(
            f"@app:fuse('{v}'): expected 'true' or 'false'")
    ctx.fuse = v == "true"


def _plan_devtables(ctx: AppContext, ann):
    """``@app:devtables`` / ``@app:devtables(capacity='N')``, with the
    reference's texts."""
    if ann is None:
        return
    if ctx.execution_mode != "tpu":
        raise SiddhiAppCreationError(
            "@app:devtables needs @app:execution('tpu')")
    v = (ann.element() or "true").strip().lower()
    if v != "false":
        ctx.devtables = True
    cap = ann.element("capacity")
    if cap:
        try:
            ncap = int(cap)
        except ValueError:
            ncap = -1
        if ncap < 1 or ncap > 1 << 24:
            raise SiddhiAppCreationError(
                f"@app:devtables: capacity='{cap}' must be an integer in "
                "1..16777216 (device slots per table)")
        ctx.devtable_capacity = ncap


def _plan_faults(ctx: AppContext, ann, siddhi_context):
    """``@app:faults(...)``: the fault injector and the input journal.
    The journal is keyed by app name on the manager context, so a
    replacement runtime built after a simulated crash inherits the
    pre-crash input history."""
    if ann is None:
        return
    opts = {k: v for k, v in ann.elements
            if k is not None and k.lower() != "type"}
    fi = FaultInjector()
    journal_depth = fi.configure_from_options(opts)
    fi.listeners = ctx.exception_listeners
    # a simulated crash dumps the flight recorder on its way out
    fi.tracer = ctx.tracer
    ctx.fault_injector = fi
    if not journal_depth:
        return
    jr = siddhi_context.input_journals.get(ctx.name)
    if jr is None or jr.depth != journal_depth:
        jr = InputJournal(depth=journal_depth)
        siddhi_context.input_journals[ctx.name] = jr
    else:
        # a reused (post-crash) journal carries its counter history
        for k, v in jr.stats.as_dict().items():
            setattr(fi.stats, k, getattr(fi.stats, k) + v)
    jr.stats = fi.stats
    ctx.input_journal = jr
    # journal overflow spills cold segments to the app's persistence
    # store instead of dropping them (durability/spill.py)
    jr.spill_sink = JournalSpillSink(siddhi_context, ctx.name, ctx)


def _plan_persist(ctx: AppContext, ann):
    """``@app:persist(interval='30 sec', mode='async')``: the default
    persist mode and the optional periodic-checkpoint daemon."""
    if ann is None:
        return
    mode = (ann.element("mode") or ann.element() or "async").lower()
    if mode not in ("sync", "async"):
        raise SiddhiAppCreationError(
            f"@app:persist: mode {mode!r} must be 'sync' or 'async'")
    ctx.persist_mode = mode
    iv = ann.element("interval")
    if iv:
        try:
            interval_ms = int(iv)
        except ValueError:
            interval_ms = parse_time_string(iv)
        if interval_ms <= 0:
            raise SiddhiAppCreationError(
                f"@app:persist: interval {iv!r} must be > 0")
        ctx.persist_interval_ms = interval_ms


# -- @source / @sink ---------------------------------------------------------


def ann_options(ann) -> Dict[str, str]:
    """An annotation's keyed elements but ``type``."""
    return {k: v for k, v in ann.elements
            if k is not None and k.lower() != "type"}


def resolve_ref(ann, config_manager) -> Dict[str, str]:
    """Options of a ``@source``/``@sink``/``@store`` with ``ref=`` merged
    from the config manager's refs (reference:
    ConfigManager.extractSystemConfigs); inline options win over the
    ref's properties."""
    opts = ann_options(ann)
    ref = opts.pop("ref", None)
    if ref is not None:
        ref_configs = dict(config_manager.extract_system_configs(ref))
        if not ref_configs:
            raise SiddhiAppCreationError(f"undefined ref '{ref}'")
        ref_configs.update(opts)
        opts = ref_configs
    return opts


def transport_config(ann, what: str, config_manager):
    """``(type, init options)`` with ``ref=`` resolved once."""
    opts = resolve_ref(ann, config_manager)
    stype = ann.element("type") or opts.get("type")
    if stype is None:
        raise SiddhiAppCreationError(
            f"@{what} on a definition: 'type' is required (inline or via "
            "ref)")
    opts.pop("type", None)
    return stype, opts


def _mapper(app, ann, kind: str):
    """The source or sink mapper of a nested ``@map`` (passThrough when
    there is none), and its options."""
    map_ann = ann.nested("map")
    map_type = (map_ann.element("type") if map_ann else None) or "passThrough"
    factory = app.extensions.lookup(f"{kind}_mapper", map_type)
    if factory is None:
        raise SiddhiAppCreationError(
            f"unknown @map(type='{map_type}') for {kind}")
    return factory(), ann_options(map_ann) if map_ann else {}


def attach_transports(app, definition, junction):
    """Build the ``@source``s and ``@sink``s of a stream definition:
    sources into ``app.sources`` (started and stopped with the runtime),
    sinks into ``app.sinks``, each subscribed to the junction through a
    ``SinkStreamCallback`` (with its output-ledger key under the input
    journal) and routing its publish failures by the stream's
    ``@OnError``."""
    from siddhi_tpu_torch.transport.sink import (
        DistributedSink,
        SinkStreamCallback,
    )

    sctx = app.siddhi_context
    cm = sctx.config_manager
    for ann in definition.annotations:
        nm = ann.name.lower()
        if nm == "source":
            stype, opts = transport_config(ann, "source", cm)
            factory = app.extensions.lookup("source", stype)
            if factory is None:
                raise SiddhiAppCreationError(
                    f"unknown @source(type='{stype}')")
            mapper, map_opts = _mapper(app, ann, "source")
            mapper.init(definition, map_opts)
            src = factory()
            src.config_reader = cm.generate_config_reader("source", stype)
            shm = sctx.source_handler_manager
            if shm is not None:
                src.handler = shm.generate(app.name, definition.id)
                app._handler_registrations.append(
                    (shm, src.handler.element_id))
            src.init(definition, opts, mapper, junction, app.app_context)
            src.is_running = lambda: app._running
            if app.app_context.breaker_threshold:
                # a source spools nothing (its transport holds the data):
                # the breaker spaces out doomed connect attempts
                src._breaker = make_breaker(app.app_context,
                                            f"source:{definition.id}")
            app.sources.append(src)
        elif nm == "sink":
            stype, opts = transport_config(ann, "sink", cm)
            factory = app.extensions.lookup("sink", stype)
            if factory is None:
                raise SiddhiAppCreationError(
                    f"unknown @sink(type='{stype}')")
            mapper, map_opts = _mapper(app, ann, "sink")
            mapper.init(definition, map_opts)
            dist = ann.nested("distribution")
            if dist is not None:
                dests = [ann_options(d) for d in dist.annotations
                         if d.name.lower() == "destination"]
                if not dests:
                    raise SiddhiAppCreationError(
                        "@distribution needs at least one @destination")
                sink = DistributedSink(
                    factory, dests, dist.element("strategy") or "roundRobin",
                    ann_options(dist))
            else:
                sink = factory()
            sink.config_reader = cm.generate_config_reader("sink", stype)
            khm = sctx.sink_handler_manager
            if khm is not None:
                sink.handler = khm.generate(app.name, definition.id)
                app._handler_registrations.append(
                    (khm, sink.handler.element_id))
            sink.init(definition, opts, mapper, app.app_context)
            if app.app_context.breaker_threshold:
                # one breaker an endpoint: a distributed sink breaks each
                # destination, never the fan-out
                targets = (sink.children if isinstance(sink, DistributedSink)
                           else [sink])
                for di, child in enumerate(targets):
                    suffix = f"#{di}" if child is not sink else ""
                    child.attach_breaker(make_breaker(
                        app.app_context,
                        f"sink:{definition.id}:{len(app.sinks)}{suffix}"))
            # publish failures follow the stream's @OnError contract
            # (reference: Sink.onError:354 routing into '!stream')
            sink.stream_junction = junction
            cb = SinkStreamCallback(sink)
            if app.app_context.input_journal is not None:
                # output-ledger identity for the replay's suppression:
                # stream id and ordinal keep several sinks apart
                cb.ledger_key = ("sink", definition.id, len(app.sinks))
            junction.subscribe(cb)
            app.sinks.append(sink)
