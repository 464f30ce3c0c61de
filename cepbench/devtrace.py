"""Reduction of a ``torch.profiler`` trace of the card to the run's
device numbers: busy time (the union of device activity), the device
operations that took most time, and the idle gaps between them, each
labelled by what the host was doing through most of it: the innermost
open host span of ``emit``, ``ingest`` or ``send`` (the port's step
span marks device work in flight, not host work, and labels nothing),
or ``client`` outside every send (the harness making the next batch).

The profiler records device activity only (``ProfilerActivity.CUDA``),
which keeps its cost on the host's side of the window small.  Its clock
is tied to the host's ``time.perf_counter`` by a marker: the window
starts with the device idle, the host reads its clock and enqueues one
small operation, and the first device activity of the trace is that
operation.  The tie is good to the launch latency, some microseconds.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


def device_events(prof) -> List[Tuple[str, float, float]]:
    """``(name, start_s, end_s)`` of every device activity (kernels,
    copies and fills) in the profiler's own clock, sorted by start."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tr = e.time_range
            out.append((e.name, tr.start / 1e6, tr.end / 1e6))
    out.sort(key=lambda x: x[1])
    return out


def union(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    """Merged ``[start, end]`` segments of ``intervals`` sorted by start."""
    merged: List[List[float]] = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(events: List[Tuple[str, float, float]], t_mark: float,
           t_stop: float, host_spans: Sequence[Tuple[str, float, float]],
           top: int = 10) -> Optional[Dict]:
    """The window ``[t_mark, t_stop]`` of host time, given the device
    ``events`` (the marker first) and the host spans ``(label, start,
    end)`` in host time.  None when the trace holds no device activity
    past the marker."""
    if len(events) < 2:
        return None
    shift = t_mark - events[0][1]  # device clock -> host clock
    evs = [(n, a + shift, b + shift) for n, a, b in events[1:]]
    evs = [(n, max(a, t_mark), min(b, t_stop)) for n, a, b in evs
           if b > t_mark and a < t_stop]
    if not evs:
        return None
    segments = union([(a, b) for _n, a, b in evs])
    busy = sum(b - a for a, b in segments)
    by_name: Dict[str, float] = {}
    for n, a, b in evs:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    edges = [t_mark] + [x for seg in segments for x in seg] + [t_stop]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = [[label_of(a, b, host_spans), b - a] for a, b in gaps[:top]]
    counts: Dict[str, int] = {}
    for n, _a, _b in evs:
        counts[n] = counts.get(n, 0) + 1
    return {"busy_s": busy, "window_s": t_stop - t_mark,
            "by_name": {n: (s, counts[n]) for n, s in by_name.items()},
            "device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": labelled, "n_events": len(evs)}


LABELS = ("emit", "ingest", "send")  # innermost first
SAMPLES = 64


def label_of(a: float, b: float,
             host_spans: Sequence[Tuple[str, float, float]]) -> str:
    """What the host did through most of ``[a, b]``: at each of
    ``SAMPLES`` points the innermost open span of ``LABELS``, else
    ``client``; the most frequent wins."""
    spans = [s for s in host_spans if s[0] in LABELS and s[2] >= a
             and s[1] <= b]
    votes: Dict[str, int] = {}
    for k in range(SAMPLES):
        t = a + (b - a) * (k + 0.5) / SAMPLES
        open_ = {lab for lab, x, y in spans if x <= t <= y}
        lab = next((x for x in LABELS if x in open_), "client")
        votes[lab] = votes.get(lab, 0) + 1
    return max(votes.items(), key=lambda kv: kv[1])[0]
