"""App-level annotations: the subset the port's product path reads.

Port of the annotation half of the JAX package's
``planner/app_planner.py``, with the reference's error messages:

- ``@app:name`` and ``@app:playback(idle.time=, increment=)`` (event
  time drives the clock; ``increment`` is added to it, and with
  ``idle.time`` the app runtime's heartbeat advances it by
  ``increment`` when no event arrives for that long);
- ``@app:execution('tpu', partitions=, instances=, emit.depth=,
  ingest.depth=, agg.device.min.batch=)``;
- ``@app:hotkeys(k=, promote=, demote=)``;
- ``@app:kernels`` / ``@app:kernels('nfa,scan,bank')``;
- ``@app:persist(interval=, mode=)`` (the default ``persist()`` mode and
  the periodic-checkpoint daemon's interval);
- ``@app:faults(seed=, journal=, transfer.retry.*=, <site>=...)``: the
  fault injector and the input journal, which lives on the manager
  context, keyed by app name, so a runtime built after a crash replays
  it.  Only the sites the port wires (``util/faults.WIRED_SITES``) may
  be armed; any other site is refused, naming ``ROADMAP.md`` item 15;
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

The port runs its kernels on the card whenever it runs on a card: it
has no XLA formulation to keep, so ``@app:kernels`` is parsed and
validated as the reference does and switches nothing.  The reference's
other ``@app:`` annotations belong to a later slice of the port and are
refused, naming the ``ROADMAP.md`` item that ports them (``LATER``); an
``@app:`` name the reference does not know is ignored, as there.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, List

from siddhi_tpu_torch.compiler.parser import parse_time_string
from siddhi_tpu_torch.core.exceptions import (
    SiddhiAppCreationError,
    later_slice,
)
from siddhi_tpu_torch.durability.spill import JournalSpillSink
from siddhi_tpu_torch.query_api.annotation import find_annotation
from siddhi_tpu_torch.util.faults import (
    RESERVED_OPTIONS,
    WIRED_SITES,
    FaultInjector,
    InputJournal,
)
from siddhi_tpu_torch.util.scheduler import Scheduler

# the reference's app annotations the port does not read yet: the
# ROADMAP.md §1 item that ports each, and what it is
LATER = {
    "app:limits": (15, "the operations layer"),
    "app:plan": (15, "the operations layer"),
    "app:statistics": (15, "the operations layer"),
    "app:trace": (15, "the operations layer"),
}


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


def plan_app_context(siddhi_app, device, siddhi_context) -> AppContext:
    """Read the app annotations into an ``AppContext``; the input
    journal is the manager context's (``siddhi_context``)."""
    anns = siddhi_app.annotations
    for a in anns:
        name = a.name.lower()
        if name in LATER:
            raise SiddhiAppCreationError(
                f"@{a.name}" + later_slice(*LATER[name]))
    name_ann = find_annotation(anns, "app:name")
    ctx = AppContext((name_ann.element() if name_ann else None)
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
        if exec_ann.element("devices"):
            raise SiddhiAppCreationError(
                "@app:execution: devices= shards the partition axis over a "
                "mesh" + later_slice(16, "multi-device"))
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
    _plan_faults(ctx, find_annotation(anns, "app:faults"), siddhi_context)
    _plan_persist(ctx, find_annotation(anns, "app:persist"))
    return ctx


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


def note_fused_conflicts(ctx: AppContext, qname: str):
    """A query the fusion pre-pass claimed while ``@app:multiplex`` was
    also on the app: the precedence (fuse > multiplex) resolved it, and
    the losing pin is recorded, as the reference counts it."""
    if ctx.multiplex:
        ctx.planner_conflicts[qname] = (
            "@app:multiplex pinned but the query fused (precedence: fuse "
            "> multiplex)")


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
    unwired = sorted(k for k in opts
                     if k.strip().lower() not in RESERVED_OPTIONS
                     and k.strip().lower() not in WIRED_SITES)
    if unwired:
        raise SiddhiAppCreationError(
            f"@app:faults: fault site(s) {unwired} are not wired in the port"
            + later_slice(15, "the operations layer"))
    fi = FaultInjector()
    journal_depth = fi.configure_from_options(opts)
    fi.listeners = ctx.exception_listeners
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
