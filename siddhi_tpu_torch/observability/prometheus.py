"""Prometheus text-exposition rendering of the statistics feed.

``GET /metrics`` renders every deployed app's StatisticsManager
counters/gauges plus the histogram families (per-query latency, per
pipeline stage) in text exposition format 0.0.4.  The dotted reference
metric names

    io.siddhi.SiddhiApps.<app>.Siddhi.<kind>.<name>.<metric>

map to ``siddhi_<kind>_<metric>{app="...",name="..."}`` — the app and
element move into labels so one family aggregates across apps and
queries, which is what makes the exposition scrapable (a family's
``# TYPE`` header must appear exactly once, with all its samples
grouped under it).  String-valued feed entries (engine placement,
fallback reasons) become ``*_info`` gauges with the text in a
``value`` label, the textfile-collector idiom for non-numeric facts.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_CAMEL = re.compile(r"([a-z0-9])([A-Z])")
_BAD_METRIC = re.compile(r"[^a-zA-Z0-9_]")


def _snake(name: str) -> str:
    return _BAD_METRIC.sub("_", _CAMEL.sub(r"\1_\2", name).lower())


def _escape(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _labels(pairs: Dict[str, str]) -> str:
    return ",".join(f'{k}="{_escape(v)}"' for k, v in pairs.items())


def _num(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return format(f, "g")


def _parse_key(app: str, key: str) -> Optional[Tuple[str, str, str]]:
    """Dotted feed key -> (kind, element name, metric); None for a key
    outside the reference convention (rendered under a catch-all)."""
    prefix = f"io.siddhi.SiddhiApps.{app}.Siddhi."
    if not key.startswith(prefix):
        return None
    parts = key[len(prefix):].split(".")
    if len(parts) < 2:
        return None
    return parts[0], ".".join(parts[1:-1]), parts[-1]


def render_prometheus(apps: Iterable[Tuple[str, Dict[str, object], list]]) -> str:
    """Render the exposition for ``apps`` — an iterable of
    ``(app_name, flat_stats_dict, histogram_entries)`` where each
    histogram entry is ``(family, labels_dict, LatencyHistogram)``.

    Scalar samples and histograms are grouped per family across apps
    so every ``# TYPE`` appears once."""
    gauges: Dict[str, List[Tuple[str, str]]] = {}
    hists: Dict[str, List[Tuple[str, object]]] = {}
    for app, stats, histogram_entries in apps:
        for key, value in sorted(stats.items()):
            parsed = _parse_key(app, key)
            if parsed is None:
                family = "siddhi_metric"
                labels = {"app": app, "key": key}
            else:
                kind, name, metric = parsed
                family = f"siddhi_{_snake(kind)}_{_snake(metric)}"
                labels = {"app": app, "name": name}
            if isinstance(value, str):
                labels["value"] = value
                gauges.setdefault(family + "_info", []).append(
                    (_labels(labels), "1"))
            else:
                gauges.setdefault(family, []).append(
                    (_labels(labels), _num(value)))
        for family, labels, hist in histogram_entries:
            hists.setdefault(family, []).append((_labels(labels), hist))

    lines: List[str] = []
    for family in sorted(gauges):
        lines.append(f"# TYPE {family} gauge")
        for labels, value in gauges[family]:
            lines.append(f"{family}{{{labels}}} {value}")
    for family in sorted(hists):
        lines.append(f"# TYPE {family} histogram")
        for labels, hist in hists[family]:
            bounds, counts, sum_ms, count = hist.snapshot()
            cum = 0
            for bound, c in zip(bounds, counts):
                cum += c
                lines.append(
                    f'{family}_bucket{{{labels},le="{format(bound, "g")}"}}'
                    f" {cum}")
            lines.append(f'{family}_bucket{{{labels},le="+Inf"}} {count}')
            lines.append(f"{family}_sum{{{labels}}} {_num(sum_ms)}")
            lines.append(f"{family}_count{{{labels}}} {count}")
    return "\n".join(lines) + "\n" if lines else "\n"


def app_histogram_entries(app: str, statistics_manager) -> list:
    """Histogram families of one app: per-query latency ladders from
    the LatencyTrackers plus per-stage span ladders from a registered
    tracer."""
    entries = []
    for tracker in list(statistics_manager.latency.values()):
        hist = getattr(tracker, "hist", None)
        if hist is not None and hist.count:
            entries.append(("siddhi_query_latency_ms",
                            {"app": app, "name": tracker.name}, hist))
    tracer = getattr(statistics_manager, "tracer", None)
    if tracer is not None:
        for stage, hist in tracer.histograms():
            entries.append(("siddhi_stage_duration_ms",
                            {"app": app, "stage": stage}, hist))
    return entries
