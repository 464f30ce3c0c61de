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
- ``@app:kernels`` / ``@app:kernels('nfa,scan,bank')``.

The port runs its kernels on the card whenever it runs on a card: it
has no XLA formulation to keep, so ``@app:kernels`` is parsed and
validated as the reference does and switches nothing.  Any other
``@app:`` annotation belongs to a later slice of the port and is
refused.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Dict

from siddhi_tpu_torch.compiler.parser import parse_time_string
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.query_api.annotation import find_annotation
from siddhi_tpu_torch.util.scheduler import Scheduler

_READ = ("app:name", "app:description", "app:playback", "app:execution",
         "app:hotkeys", "app:kernels")


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


def plan_app_context(siddhi_app, device) -> AppContext:
    """Read the app annotations into an ``AppContext``."""
    anns = siddhi_app.annotations
    for a in anns:
        if a.name.lower().startswith("app:") and a.name.lower() not in _READ:
            raise SiddhiAppCreationError(
                f"@{a.name} is not in the port yet — a later slice of the "
                "port")
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
                "mesh — a later slice of the port")
        for key, attr in (("emit.depth", "tpu_emit_depth"),
                          ("ingest.depth", "tpu_ingest_depth")):
            raw = exec_ann.element(key)
            if not raw:
                continue
            if raw.lower() == "auto":
                raise SiddhiAppCreationError(
                    f"@app:execution: {key}='auto' (the adaptive depth "
                    "controller) — a later slice of the port")
            setattr(ctx, attr, _positive_int(
                exec_ann, key, "a positive integer or 'auto'"))

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
    return ctx
