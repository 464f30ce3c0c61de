"""The dense batch route's spans and counters: ``ingest.segments`` (the
host sort of a batch by partition), ``step.launch`` (the dispatch of the
filter matrix, the one ``batch_step`` and the output columns) and the
``batchStep*`` counters of ``IngestStats``.

Held to the program alone on the CPU: a small partitioned capture-free
chain (the batch route) beside a capturing one (the general route),
``partition_segments`` on the hand-made batch for the counters, and an
injected tracer clock for where the spans lie in their cycle.
"""

import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest

from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.stream import StreamCallback
from siddhi_tpu_torch.ops.dense_nfa import partition_segments

ROOT = Path(__file__).resolve().parent.parent
BATCH_ROUTE = ("ingest.segments", "step.launch")
N_BATCHES = 4


def app(trace: str, capturing: bool = False) -> str:
    second = "v > 2.0 and v > e1.v" if capturing else "v > 2.0"
    return (f"@app:trace({trace}) @app:playback "
            "@app:execution('tpu', partitions='64', instances='8', "
            "ingest.depth='2', emit.depth='auto') "
            "define stream Txn (key long, v double); "
            "partition with (key of Txn) begin @info(name='q') "
            f"from every e1=Txn[v > 1.0] -> e2=Txn[{second}] "
            "-> e3=Txn[v > 3.0] within 10 min "
            "select e3.key as key, e3.v as v insert into Alerts; end;")


def batch(keys, i: int) -> EventBatch:
    keys = np.asarray(keys, dtype=np.int64)
    v = np.random.default_rng(i).uniform(0.0, 5.0, len(keys))
    return EventBatch("Txn", ["key", "v"], {"key": keys, "v": v},
                      np.full(len(keys), 1_000 + 64 * i, dtype=np.int64))


def hand_made(i: int):
    """Keys with repeats: 7 four times, 3 twice, the rest once."""
    return [7, 3, 7, 11, 7, 3, 20 + i, 7, 5]


class Keep(StreamCallback):
    def receive_batch(self, b):
        pass


def run(trace: str, capturing: bool = False, clock=None):
    """``N_BATCHES`` hand-made batches through the app on the CPU,
    drained: ``(tracer, the dense runtime, the batches' keys)``."""
    m = SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(app(trace, capturing))
    rt.add_callback("Alerts", Keep())
    tracer = rt.app_context.tracer
    if clock is not None:
        tracer.clock = clock
    rt.start()
    h = rt.get_input_handler("Txn")
    sent = [hand_made(i) for i in range(N_BATCHES)]
    for i, keys in enumerate(sent):
        h.send_batch(batch(keys, i))
    rt.drain()
    (runtime,) = rt.pattern_runtimes().values()
    rt.shutdown()
    m.shutdown()
    return tracer, runtime, sent


def test_batch_route_records_its_spans_once_a_sampled_batch():
    tracer, runtime, _ = run("sample='1/1'")
    assert runtime.engine.step_kind == "batch"
    for st in BATCH_ROUTE:
        assert tracer.stage_hist[st].count == N_BATCHES, st
    assert "step.round" not in {s[1] for s in
                                tracer.recorder.detail_spans()}


def test_general_route_never_records_them():
    tracer, runtime, _ = run("sample='1/1'", capturing=True)
    assert runtime.engine.step_kind == "general"
    assert tracer.stage_hist["step.round"].count >= N_BATCHES
    for st in BATCH_ROUTE:
        assert tracer.stage_hist[st].count == 0, st
    counters = runtime.ingest_stats.as_dict()
    assert counters["batchStepLaunches"] == 0
    assert counters["batchStepEvents"] == 0


@pytest.mark.parametrize("trace", ["sample='off'", "sample='1/2'"])
def test_unsampled_batches_record_nothing(trace):
    tracer, runtime, _ = run(trace)
    sampled = 0 if trace == "sample='off'" else N_BATCHES // 2
    for st in BATCH_ROUTE:
        assert tracer.stage_hist[st].count == sampled, st
    assert len([s for s in tracer.recorder.detail_spans()
                if s[1] in BATCH_ROUTE]) == 2 * sampled
    # the counters count every batch, sampled or not
    assert runtime.ingest_stats.batch_step_launches == N_BATCHES


def test_counters_equal_partition_segments_of_the_batches():
    _tracer, runtime, sent = run("sample='off'")
    want_events = want_segments = want_longest = 0
    for keys in sent:
        # the runtime's rows are its interned keys: one segment a key
        _order, seg_start, seg_part = partition_segments(
            np.unique(keys, return_inverse=True)[1].astype(np.int32))
        want_events += int(seg_start[-1])
        want_segments += len(seg_part)
        want_longest = max(want_longest, int(np.diff(seg_start).max()))
    assert (want_events, want_segments, want_longest) == (36, 20, 4)
    assert {k: v for k, v in runtime.ingest_stats.as_dict().items()
            if k.startswith("batchStep")} == {
        "batchStepLaunches": N_BATCHES, "batchStepEvents": want_events,
        "batchStepSegments": want_segments,
        "batchStepLongestSegment": want_longest}


def test_spans_lie_in_the_ingest_span_around_the_put():
    ticks = itertools.count(1)
    tracer, _runtime, _ = run("sample='1/1'",
                              clock=lambda: float(next(ticks)))
    ingest = {s[0]: s for s in tracer.recorder.spans() if s[1] == "ingest"}
    detail = {}
    for s in tracer.recorder.detail_spans():
        detail.setdefault(s[0], {})[s[1]] = s
    assert sorted(ingest) == sorted(detail)
    for cycle, spans in detail.items():
        seg, put, launch = (spans["ingest.segments"], spans["ingest.put"],
                            spans["step.launch"])
        assert ingest[cycle][3] <= seg[3] < seg[4] <= put[3]
        assert put[4] <= launch[3] < launch[4] <= ingest[cycle][4]
        assert seg[5] == launch[5] == len(hand_made(0))


def _metric(name: str):
    path = ROOT / "cepbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,stage", [
    ("segments_ms.dense_batch", "ingest.segments"),
    ("launch_dispatch_ms.dense_batch", "step.launch")])
def test_span_readers_read_the_mean_or_nothing(name, stage):
    tracer, _runtime, _ = run("sample='1/1'")
    ctx = {"spans": {st: (h.count, h.sum_ms)
                     for st, h in tracer.stage_hist.items()},
           "span_engines": sorted({s[2] for s in tracer.recorder.spans()})}
    h = tracer.stage_hist[stage]
    assert _metric(name).read(ctx) == pytest.approx(h.sum_ms / h.count)
    # a program without the span (the parent of this route's spans)
    # reads nothing
    del ctx["spans"][stage]
    assert _metric(name).read(ctx) is None
