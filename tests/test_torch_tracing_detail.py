"""The dense path's detail spans (``observability/trace.py``): interning,
the put, each collision round, the step's device time on the host clock,
and the emit's fetch split from its delivery.

Held to the program alone: a small partitioned dense app on the CPU,
an injected tracer clock for the order of the spans, an independent
count of collision rounds from the generated keys, stub timing events
for the anchor conversion, and the flight recorder's two rings.  The
card test (marker ``cuda``) runs each benchmark cell's app at full size
and holds every ``step.device`` span to its cycle's host spans and the
profiler's step kernels to the ``step.device`` spans:

    python -m pytest --noconftest -m cuda -s tests/test_torch_tracing_detail.py
"""

import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.stream import StreamCallback
from siddhi_tpu_torch.observability import FlightRecorder, Tracer
from siddhi_tpu_torch.observability.trace import to_host

ROOT = Path(__file__).resolve().parent.parent

DETAIL = ("intern", "ingest.put", "step.round", "step.device", "emit.fetch",
          "emit.deliver")
BATCH = 64
KEYS = 16


def app(trace: str) -> str:
    return (f"@app:trace({trace}) @app:playback "
            "@app:execution('tpu', partitions='64', instances='8', "
            "ingest.depth='2', emit.depth='auto') "
            "define stream Txn (key long, v double); "
            "partition with (key of Txn) begin @info(name='q') "
            "from every e1=Txn[v > 0.0] -> e2=Txn[v > 1.0 and v > e1.v] "
            "within 10 min select e1.key as key, e1.v as v1, e2.v as v2 "
            "insert into Alerts; end;")


def batches(n: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        keys = rng.integers(0, KEYS, BATCH)
        out.append(EventBatch(
            "Txn", ["key", "v"],
            {"key": keys, "v": rng.uniform(0.0, 20.0, BATCH)},
            np.full(BATCH, 1_000 + 64 * i, dtype=np.int64)))
    return out


class Keep(StreamCallback):
    def __init__(self):
        self.rows = 0

    def receive_batch(self, batch):
        self.rows += len(batch)


def run(trace: str, n: int = 6, clock=None):
    """The app on the CPU over ``n`` batches, drained; returns its tracer
    and the batches sent."""
    m = SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(app(trace))
    rt.add_callback("Alerts", Keep())
    tracer = rt.app_context.tracer
    if clock is not None:
        tracer.clock = clock
    rt.start()
    h = rt.get_input_handler("Txn")
    sent = batches(n)
    for b in sent:
        h.send_batch(b)
    rt.drain()
    rt.shutdown()
    m.shutdown()
    return tracer, sent


def by_cycle(spans):
    out = {}
    for s in spans:
        out.setdefault(s[0], []).append(s)
    return out


def test_every_detail_stage_records_on_a_sampled_cycle():
    tracer, _ = run("sample='1/1'")
    counts = {st: tracer.stage_hist[st].count for st in DETAIL}
    assert all(counts[st] > 0 for st in DETAIL), counts
    # one interning, one put and one device span a batch
    for st in ("intern", "ingest.put", "step.device"):
        assert counts[st] == 6, (st, counts)
    assert {s[1] for s in tracer.recorder.detail_spans()} == set(DETAIL)
    assert {s[2] for s in tracer.recorder.detail_spans()} == {"dense"}


def test_no_detail_stage_records_with_tracing_off():
    tracer, _ = run("sample='off'")
    assert all(h.count == 0 for h in tracer.stage_hist.values())
    assert tracer.recorder.detail_spans() == []
    assert tracer.recorder.spans() == []
    assert tracer.anchors == {}


def test_detail_spans_nest_in_their_cycle_on_an_injected_clock():
    ticks = itertools.count(1)
    tracer, _ = run("sample='1/1'", clock=lambda: float(next(ticks)))
    batch = by_cycle(tracer.recorder.spans())
    detail = by_cycle(tracer.recorder.detail_spans())
    assert sorted(batch) == sorted(detail) == list(range(1, 7))
    for cycle, spans in detail.items():
        stages = {s[1]: s for s in batch[cycle]}
        ingest, emit = stages["ingest"], stages["emit"]
        for s in spans:
            assert s[3] <= s[4], s
            if s[1] == "intern":
                assert s[4] <= ingest[3], (s, ingest)
            elif s[1] in ("ingest.put", "step.round"):
                assert ingest[3] <= s[3] and s[4] <= ingest[4], (s, ingest)
            elif s[1] == "step.device":
                # the CPU's device span: the host from the put to the
                # last round
                assert ingest[3] <= s[3] and s[4] <= ingest[4], (s, ingest)
            else:
                assert emit[3] <= s[3] and s[4] <= emit[4], (s, emit)
        puts = [s for s in spans if s[1] == "ingest.put"]
        rounds = [s for s in spans if s[1] == "step.round"]
        assert len(puts) == 1 and rounds
        # the rounds follow the put, one after another
        assert puts[0][4] <= rounds[0][3]
        assert all(a[4] <= b[3] for a, b in zip(rounds, rounds[1:]))
        assert sum(s[5] for s in rounds) == BATCH


def _metric(name: str):
    import importlib.util

    path = ROOT / "cepbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rounds_per_batch_equals_the_largest_key_count():
    tracer, sent = run("sample='1/2'")
    # cycles 2, 4 and 6 are sampled: the second, fourth and sixth batch
    want = np.mean([np.unique(np.asarray(b.columns["key"]),
                              return_counts=True)[1].max()
                    for b in sent[1::2]])
    assert tracer.stage_hist["step"].count == 3
    got = tracer.stage_hist["step.round"].count / tracer.stage_hist[
        "step"].count
    assert got == want
    ctx = {"spans": {st: (h.count, h.sum_ms)
                     for st, h in tracer.stage_hist.items()},
           "span_engines": sorted({s[2] for s in tracer.recorder.spans()})}
    assert _metric("rounds_per_batch.dense").read(ctx) == want
    # a program without the round span reads nothing
    del ctx["spans"]["step.round"]
    assert _metric("rounds_per_batch.dense").read(ctx) is None


class StubEvent:
    """A timing event at device time ``t`` seconds."""

    def __init__(self, t: float):
        self.t = t

    def elapsed_time(self, other: "StubEvent") -> float:
        return (other.t - self.t) * 1e3


def test_anchor_maps_stub_events_to_their_host_times():
    anchor = (250.0, StubEvent(7.0))
    for host, dev in ((250.0, 7.0), (250.125, 7.125), (262.5, 19.5)):
        assert to_host(anchor, StubEvent(dev)) == pytest.approx(host,
                                                                abs=1e-12)
    start, end = Tracer.device_span((anchor, StubEvent(8.0)),
                                    (anchor, StubEvent(8.5)))
    assert start == pytest.approx(251.0) and end == pytest.approx(251.5)
    # on the CPU a mark is the host clock itself
    assert Tracer.device_span(3.0, 4.5) == (3.0, 4.5)


def test_anchor_is_taken_only_on_the_card():
    import torch

    t = Tracer("app", sample=1)
    t.take_anchor(torch.device("cpu"))
    assert t.anchors == {} and t.recorder.anchors == {}
    assert isinstance(t.device_mark(torch.device("cpu")), float)


def test_detail_ring_evicts_and_is_dumped_and_exported():
    r = FlightRecorder("app", cycles=2)
    assert r.detail.maxlen == 2 * FlightRecorder.DETAIL_SPANS_PER_CYCLE
    n = r.detail.maxlen + 7
    for i in range(n):
        r.record_detail((i // 8 + 1, "step.round", "dense", float(i),
                         i + 0.5, 1))
    spans = r.detail_spans()
    assert len(spans) == r.detail.maxlen
    assert spans[-1][3] == float(n - 1) and spans[0][3] == 7.0
    r.record((9, "ingest", "dense", 0.0, 1.0, 4))
    r.anchors["cuda:0"] = 12.5
    payload = r.payload("live")
    assert len(payload["detail"]) == r.detail.maxlen
    assert payload["detail"][-1]["stage"] == "step.round"
    assert [s["stage"] for s in payload["spans"]] == ["ingest"]
    assert payload["anchors"] == {"cuda:0": 12.5}
    ch = r.chrome_trace()
    names = ch["metadata"]["thread_names"]
    tids = {e["name"].split(" ")[0]: e["tid"] for e in ch["traceEvents"]}
    assert names[tids["ingest"]] == "ingest"
    assert names[tids["step.round"]] == "step.round"
    assert tids["ingest"] != tids["step.round"]
    assert len(ch["traceEvents"]) == 1 + r.detail.maxlen
    assert ch["otherData"]["deviceAnchors"] == {"cuda:0": 12.5}


def test_batch_ring_and_dump_keep_their_cycles():
    tracer, _ = run("sample='1/1', cycles='8'")
    rec = tracer.recorder
    assert rec.ring.maxlen == 8 * FlightRecorder.SPANS_PER_CYCLE
    groups = rec.cycle_groups()
    assert list(groups) == list(range(1, 7))
    for cycle, spans in groups.items():
        assert [s[1] for s in spans] == ["ingest", "step", "emit"], cycle
    dump = tracer.dump("unit-test")
    assert {s["stage"] for s in dump["spans"]} == {"ingest", "step", "emit"}
    assert len(dump["spans"]) == 3 * len(groups)
    assert {s["stage"] for s in dump["detail"]} == set(DETAIL)
    assert {s["cycle"] for s in dump["detail"]} <= set(range(1, 7))


# -- on the card --------------------------------------------------------------

#: batches sent under the profiler, after the warm-up and a barrier
CARD_BATCHES = 10
#: the clocks agree to this, in seconds
TOLERANCE_S = 0.5e-3


def _covered(a: float, b: float, segments) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in segments)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name",
                         ["fraud16_1m.uniform", "fraud16_1m.hot100k"])
def test_step_device_spans_share_the_host_clock_on_the_card(cell_name):
    """Each cell's app at full size under ``@app:trace(sample='1/1')``:
    every ``step.device`` span lies inside its cycle's ``[ingest start,
    step end]``, and the profiler's device operations of the step (all
    but the fetches' copies and concatenations), tied to the host clock
    by a marker as ``cepbench/devtrace.py`` ties them, fall inside the
    ``step.device`` spans.  Prints the figures as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile

    from cepbench import devtrace
    from cepbench.generator import Traffic
    from cepbench.harness import Cell

    cell = Cell(cell_name)
    traffic = Traffic(cell.mix, 2_718_281_828)
    mgr = SiddhiManager(device="cuda")
    rt = mgr.create_siddhi_app_runtime(cell.app(True))
    rt.add_callback(cell.config["output"], Keep())
    rt.start()
    h = rt.get_input_handler(cell.config["input"])

    def send(i):
        cols, ts = traffic.batch(i)
        h.send_batch(EventBatch(traffic.stream, traffic.names, cols, ts))

    for i in range(traffic.warmup):
        send(i)
    rt.drain()
    torch.cuda.synchronize()
    tracer = rt.app_context.tracer
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t_mark = time.perf_counter()
        torch.zeros(1, device="cuda")  # the clock's marker
        torch.cuda.synchronize()
        for i in range(traffic.warmup, traffic.warmup + CARD_BATCHES):
            send(i)
        rt.drain()
        torch.cuda.synchronize()
        t_stop = time.perf_counter()
    batch = by_cycle(tracer.recorder.spans())
    # the cycles of the batches sent under the profiler
    window = {c for c, spans in batch.items()
              if spans[0][1] == "ingest" and spans[0][3] >= t_mark}
    dev = [s for s in tracer.recorder.detail_spans()
           if s[1] == "step.device" and s[0] in window]
    rt.shutdown()
    mgr.shutdown()
    assert len(dev) == CARD_BATCHES, len(dev)
    worst = 0.0
    for s in dev:
        stages = {x[1]: x for x in batch[s[0]]}
        lo, hi = stages["ingest"][3], stages["step"][4]
        worst = max(worst, lo - s[3], s[4] - hi)
    events = devtrace.device_events(prof)
    shift = t_mark - events[0][1]
    ops = [(n, a + shift, b + shift) for n, a, b in events[1:]]
    step_ops = [op for op in ops if "DtoH" not in op[0]
                and "Cat" not in op[0]]
    segments = devtrace.union(sorted((s[3], s[4]) for s in dev))
    total = sum(b - a for _n, a, b in step_ops)
    outside = {}
    for n, a, b in step_ops:
        miss = (b - a) - _covered(a, b, segments)
        if miss > 0:
            outside[n[:80]] = outside.get(n[:80], 0.0) + miss
    share = sum(outside.values()) / total
    device_ms = [1e3 * (s[4] - s[3]) for s in dev]
    print(json.dumps({
        "test": "step_device_clock", "cell": cell_name,
        "card": torch.cuda.get_device_name(0), "batches": len(dev),
        "worst_outside_cycle_ms": 1e3 * worst,
        "step_ops": len(step_ops), "step_ops_s": total,
        "outside_share": share,
        "outside_by_name_ms": {k: 1e3 * v for k, v in sorted(
            outside.items(), key=lambda kv: -kv[1])[:8]},
        "step_device_ms": [min(device_ms), max(device_ms)],
        "window_s": t_stop - t_mark}), flush=True)
    assert worst <= TOLERANCE_S, worst
    assert share <= 0.01, outside
