"""Black-box flight recorder: the last N cycle traces, dumped on death.

The recorder owns the span ring the tracer appends into.  Spans are
fixed-size tuples ``(cycle, stage, engine, t_start, t_end, n_events)``
held in a ``collections.deque(maxlen=...)`` — appends are GIL-atomic,
so the emit-drain, ingest and checkpoint-writer threads all record
without a lock, and the ring self-evicts to the newest N cycles' worth
of spans.

On a terminal event (poison quarantine, @OnError isolation, crash
restore, fault-injector kill) ``dump(reason)`` freezes the ring into a
JSON payload: kept in memory as ``last_dump`` (served by
``GET /siddhi-trace/<app>``) and written best-effort to the dump
directory so a post-mortem survives the process.  ``chrome_trace()``
renders the same spans as Chrome ``chrome://tracing`` complete events.

A second ring, ``detail``, holds the dense path's detail spans
(interning, the put, each collision round, the step's device time, the
emit's fetch and delivery) in the same tuple layout, so the batch ring
keeps its whole ``ingest -> step -> emit`` cycles.  The dump carries it
under ``detail``, and the Chrome export draws it on tracks of its own
beside the batch stages, with the device anchors (host clock readings
that ``step.device`` spans are converted through) in ``otherData``.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import re
import tempfile
import time
from typing import Dict, List, Optional, Tuple

log = logging.getLogger("siddhi_tpu_torch.observability")

#: span tuple layout — index names for readers of the raw ring
CYCLE, STAGE, ENGINE, T_START, T_END, N_EVENTS = range(6)

Span = Tuple[int, str, str, float, float, int]


def default_dump_dir() -> str:
    """``$SIDDHI_TPU_TRACE_DIR`` or ``<tmp>/siddhi_tpu_traces``."""
    return os.environ.get("SIDDHI_TPU_TRACE_DIR") or os.path.join(
        tempfile.gettempdir(), "siddhi_tpu_traces")


class FlightRecorder:
    """Span ring + dump machinery for one app runtime."""

    #: ring capacity per kept cycle: ingest + step + emit leaves head
    #: room for persist spans interleaving with batch cycles
    SPANS_PER_CYCLE = 4

    #: detail ring capacity per kept cycle: interning, the put, the
    #: step's device span, the emit's fetch and delivery (5), and up to
    #: 11 collision rounds.  A batch of B = 131,072 on 100,000 keys
    #: takes 8-9 rounds (the most transactions one key has in it), 13-14
    #: detail spans; a batch of distinct keys takes one round, 6.
    DETAIL_SPANS_PER_CYCLE = 16

    #: file-write cap per recorder — a chaos run triggering hundreds of
    #: isolation dumps must not litter the dump dir unboundedly (the
    #: in-memory ``last_dump`` keeps updating past the cap)
    MAX_DUMP_FILES = 32

    def __init__(self, app_name: str, cycles: int = 64,
                 dump_dir: Optional[str] = None):
        self.app_name = app_name
        self.cycles = max(1, int(cycles))
        self.ring: collections.deque = collections.deque(
            maxlen=self.cycles * self.SPANS_PER_CYCLE)
        self.detail: collections.deque = collections.deque(
            maxlen=self.cycles * self.DETAIL_SPANS_PER_CYCLE)
        # device name -> the host reading of its newest anchor
        self.anchors: Dict[str, float] = {}
        self.dump_dir = dump_dir if dump_dir is not None else default_dump_dir()
        self.last_dump: Optional[dict] = None
        self.dumps = 0
        self.dump_files_written = 0

    # -- recording -----------------------------------------------------------

    def record(self, span: Span) -> None:
        self.ring.append(span)

    def spans(self) -> List[Span]:
        return list(self.ring)

    def record_detail(self, span: Span) -> None:
        self.detail.append(span)

    def detail_spans(self) -> List[Span]:
        return list(self.detail)

    def cycle_groups(self) -> "collections.OrderedDict":
        """cycle id -> [span, ...] in ring (append) order, cycles in
        first-seen order — ring order IS chronological per cycle."""
        groups: "collections.OrderedDict" = collections.OrderedDict()
        for span in list(self.ring):
            groups.setdefault(span[CYCLE], []).append(span)
        return groups

    # -- dumping -------------------------------------------------------------

    @staticmethod
    def _span_dict(span: Span) -> dict:
        return {
            "cycle": span[CYCLE],
            "stage": span[STAGE],
            "engine": span[ENGINE],
            "t_start": span[T_START],
            "t_end": span[T_END],
            "n_events": span[N_EVENTS],
        }

    def payload(self, reason: str) -> dict:
        return {
            "app": self.app_name,
            "reason": reason,
            "unix_time": time.time(),
            "spans": [self._span_dict(s) for s in self.spans()],
            "detail": [self._span_dict(s) for s in self.detail_spans()],
            "anchors": dict(self.anchors),
        }

    def dump(self, reason: str) -> dict:
        """Freeze the ring: keep it in memory, write it best-effort.

        The dump path must never add a failure mode to the fault paths
        that call it — an unwritable dump dir logs and moves on."""
        payload = self.payload(reason)
        self.last_dump = payload
        self.dumps += 1
        if self.dump_files_written >= self.MAX_DUMP_FILES:
            return payload
        slug = re.sub(r"[^A-Za-z0-9_.-]+", "-", reason)[:64]
        fname = f"{self.app_name}-{self.dumps:04d}-{slug}.json"
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(self.dump_dir, fname)
            with open(path, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            self.dump_files_written += 1
            log.warning("flight recorder: app '%s' dumped %d span(s) to "
                        "%s (reason: %s)", self.app_name,
                        len(payload["spans"]), path, reason)
        except OSError as e:
            log.error("flight recorder: app '%s' could not write dump "
                      "(%s); trace kept in memory only", self.app_name, e)
        return payload

    # -- chrome://tracing export ---------------------------------------------

    def chrome_trace(self) -> dict:
        """Complete ("X") events, one per span; ts/dur in microseconds.

        Stages map to tids so chrome renders the pipeline as stacked
        tracks, the batch stages first, then the detail stages; the
        cycle id and engine kind ride in ``args`` for the flow
        inspector."""
        tids: Dict[str, int] = {}
        events = []
        for span in self.spans() + self.detail_spans():
            stage = span[STAGE]
            tid = tids.setdefault(stage, len(tids) + 1)
            events.append({
                "name": f"{stage} c{span[CYCLE]}",
                "cat": span[ENGINE],
                "ph": "X",
                "ts": span[T_START] * 1e6,
                "dur": max(0.0, (span[T_END] - span[T_START]) * 1e6),
                "pid": 1,
                "tid": tid,
                "args": {"cycle": span[CYCLE], "engine": span[ENGINE],
                         "n_events": span[N_EVENTS]},
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"app": self.app_name,
                          "deviceAnchors": dict(self.anchors)},
            "metadata": {"thread_names": {v: k for k, v in tids.items()}},
        }
