"""The port's multi-tenant multiplexing held against the JAX package's.

``tests/test_multiplex.py`` replayed through both packages by
``test_torch_persistence.py``'s twin runs: N tenants multiplexed into
shared engines deliver the same events in each package, and each test's
own assertions hold there (multiplexed == N dedicated runtimes, one
shared step a cycle, flush skips, a tenant's crash and journal replay,
a tenant's persist and restore, the sharded empty-pane skip under
``devices=``).  For every query of every app a case builds, the port's
structural fingerprint is the reference's digest.  The transient-fault
and poison cases of ``TestMultiplexFaults`` and the statistics reads of
``TestMultiplexFallback`` run; ``test_fallback_reason_as_the_reference``
holds the reason once more, in ``AppContext.multiplex_fallbacks`` and
on both statistics feeds.

Then the pieces, on seeded inputs: the fingerprints of the benchmark's
apps, ``DensePatternEngine.shift_row_ts`` against the reference's, and
the tumbling group's combined accumulate step against the JAX group's
(state, counters and outputs after every cycle).
"""

from __future__ import annotations

import logging

import numpy as np
import pytest

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.compiler import SiddhiCompiler as JaxCompiler
from siddhi_tpu.multiplex.fingerprint import (
    query_fingerprint as jax_fingerprint,
)
from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.compiler import SiddhiCompiler
from siddhi_tpu_torch.multiplex.fingerprint import query_fingerprint
from test_torch_device_query import one_torch_thread  # noqa: F401
from test_torch_persistence import Record, _ev_row, _Runtime, cases, check_twin

pytestmark = pytest.mark.faults

LEFT_OUT = {}
CASES = cases("test_multiplex", LEFT_OUT)


def test_the_corpus_was_read():
    assert len(CASES) == 13


def digests(app: str):
    """Each query's fingerprint in both packages, with the knobs the
    planner gives it: ``[(port, reference)]``."""
    out = []
    for compiler, fingerprint in ((SiddhiCompiler, query_fingerprint),
                                  (JaxCompiler, jax_fingerprint)):
        parsed = compiler.parse(app)
        defs = parsed.stream_definitions
        got = []
        for q in parsed.execution_elements:
            s = q.input_stream
            if not hasattr(s, "stream_ids"):  # either package's single
                family, ds = "tumbling", [defs[s.stream_id]]
            else:
                family, ds = "dense", [defs[sid] for sid in
                                       sorted(set(s.stream_ids()))]
            got.append(fingerprint(q, ds, {"family": family, "slots": 8}))
        out.append(got)
    return list(zip(*out))


class _TenantRuntime(_Runtime):
    """A runtime whose stream callbacks are recorded per runtime: a
    tenant's events arrive in its own order, while how two tenants'
    deliveries interleave follows the wall-clock scheduler of an app
    without ``@app:playback``."""

    def __init__(self, rt, rec):
        super().__init__(rt, rec)
        rec.runtimes = getattr(rec, "runtimes", 0) + 1
        self._tag = rec.runtimes

    def add_callback(self, target, cb):
        self._rt.add_callback(target, cb)
        got = self._rec.got.setdefault(f"{target}@{self._tag}", [])
        self._rt.add_callback(target, lambda evs: got.extend(
            _ev_row(e) for e in evs))


class TenantRecord(Record):
    runtime_class = _TenantRuntime


@pytest.mark.parametrize("corpus,cname,mname,k", CASES)
def test_multiplex_corpus_as_the_reference(corpus, cname, mname, k,
                                           tmp_path, request):
    jax, port = check_twin(corpus, cname, mname, k, tmp_path, request,
                           record=TenantRecord)
    for app in jax.apps:
        for p, j in digests(app):
            assert p == j, app


MUX_BENCH = ("@app:name('muxbench{i}') @app:playback @app:execution('tpu') "
             "@app:multiplex(slots='8') "
             "define stream Mkt (k long, v double); "
             "@info(name='w') from Mkt#window.lengthBatch(65536) "
             "select k, sum(v) as s, count() as c group by k "
             "insert into Panes;")
KERNEL_CHAIN = ("define stream Txn (key long, v double); "
                "@info(name='bench') from every e1=Txn[v > 1.0] -> "
                + " -> ".join(f"e{i}=Txn[v > {float(i)}]"
                              for i in range(2, 17))
                + " within 10 min select e16.v as v insert into Alerts;")
CAPTURE_CHAIN = ("define stream S (v double); @info(name='q') from every "
                 "e1=S[v > 1.0] -> e2=S[v > e1.v] select e1.v as a, "
                 "e2.v as b insert into Out;")


@pytest.mark.parametrize("app", [MUX_BENCH.format(i=0), KERNEL_CHAIN,
                                 CAPTURE_CHAIN],
                         ids=["bench_multiplexed", "kernel_eligible",
                              "capturing"])
def test_fingerprint_digest_is_the_reference(app):
    """The benchmark's multiplexed app and the two dense chains the card
    phase multiplexes: the same sha256 hex digest in both packages."""
    pairs = digests(app)
    assert pairs and all(p == j and len(p) == 64 for p, j in pairs)


def test_fallback_reason_as_the_reference(caplog):
    """``TestMultiplexFallback``'s statistics case: a sliding window
    keeps its dedicated engine with the reference's WARNING, the reason
    the reference's statistics report sits in
    ``AppContext.multiplex_fallbacks`` and on the port's feed, and the
    tumbling query takes a seat, in both packages."""
    body = ("define stream S (k long, v double); "
            "@info(name='q1') from S#window.length(4) "
            "select k, sum(v) as s group by k insert into Out; "
            "@info(name='q2') from S#window.lengthBatch(4) "
            "select k, sum(v) as s group by k insert into Out2;")
    head = "@app:name('fb') @app:execution('tpu') @app:multiplex(slots='4') "
    jm = JaxManager()
    jrt = jm.create_siddhi_app_runtime(head + "@app:statistics('basic') "
                                       + body)
    jlow = jrt.lowering()
    reason = jrt.statistics()[
        "io.siddhi.SiddhiApps.fb.Siddhi.Queries.q1.multiplexFallbackReason"]
    jrt.shutdown()
    jm.shutdown()
    m = SiddhiManager(device="cpu")
    with caplog.at_level(logging.WARNING, logger="siddhi_tpu_torch"):
        rt = m.create_siddhi_app_runtime(head + "@app:statistics('basic') "
                                         + body)
    assert rt.lowering() == jlow == {"q1": "device", "q2": "multiplex"}
    assert rt.app_context.multiplex_fallbacks == {"q1": reason}
    assert rt.statistics()[
        "io.siddhi.SiddhiApps.fb.Siddhi.Queries.q1.multiplexFallbackReason"
    ] == reason
    assert "tumbling" in reason
    assert any(f"query 'q1': multiplex ineligible ({reason}); dedicated "
               "engine used" in r.getMessage() for r in caplog.records)
    rt.shutdown()
    m.shutdown()


# -- shift_row_ts -------------------------------------------------------------

SHIFT_APPS = {
    "within": ("define stream S (v double); @info(name='q') from every "
               "e1=S[v > 1.0] -> e2=S[v > e1.v] within 500 millisec "
               "select e1.v as a, e2.v as b insert into Out;"),
    "no_within": CAPTURE_CHAIN,
    "deadline": ("define stream S (v double); @info(name='q') from every "
                 "e1=S[v > 1.0] -> not S[v > 50.0] for 300 millisec "
                 "select e1.v as a insert into Out;"),
}


@pytest.mark.parametrize("delta", [-700, -1, 1, 300, 5_000])
@pytest.mark.parametrize("shape", sorted(SHIFT_APPS))
def test_shift_row_ts_as_the_reference(shape, delta):
    """Seeded host rows (anchors set and unset, some past the ``within``
    horizon after the shift, armed deadlines) shifted by both packages'
    ``shift_row_ts``: the same arrays, bit for bit."""
    from siddhi_tpu.ops.dense_nfa import compile_pattern as jax_compile
    from siddhi_tpu_torch import compile_pattern

    app = SHIFT_APPS[shape]
    je = jax_compile(app, "q", n_partitions=4)
    te = compile_pattern(app, "q", n_partitions=4, device="cpu")
    rng = np.random.default_rng(abs(delta) + len(shape))
    rows = {}
    for k, (shp, dt) in te.state_layout().items():
        if k in ("first_ts", "deadline"):
            v = rng.integers(1, 1_000, size=shp).astype(dt)
            rows[k] = np.where(rng.random(shp) < 0.3, 0, v).astype(dt)
        elif dt == np.dtype(bool):
            rows[k] = rng.random(shp) < 0.5
        else:
            rows[k] = rng.integers(0, 5, size=shp).astype(dt)
    got = te.shift_row_ts({k: v.copy() for k, v in rows.items()}, delta)
    want = je.shift_row_ts({k: v.copy() for k, v in rows.items()}, delta)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
    assert ("deadline" in got) == (shape == "deadline")


# -- the combined accumulate step -----------------------------------------------

class _Seat:
    """The adapter surface a group reads when it stages."""

    def __init__(self, slot, stats):
        self.slot = slot
        self.ingest_stats = stats
        self.faults = None


def _groups(window: str, slots: int):
    from siddhi_tpu.core.ingest_stage import IngestStats as JaxStats
    from siddhi_tpu.multiplex.tumbling_group import (
        TumblingMultiplexGroup as JaxGroup,
    )
    from siddhi_tpu.ops.device_query import DeviceQueryEngine as JaxEngine
    from siddhi_tpu_torch.core.ingest_stage import IngestStats
    from siddhi_tpu_torch.multiplex.tumbling_group import (
        TumblingMultiplexGroup,
    )
    from siddhi_tpu_torch.ops.device_query import DeviceQueryEngine

    app = ("define stream S (k long, g double, v double); @info(name='q') "
           f"from S[v > 10.0]#window.{window} select k, g, sum(v) as s, "
           "count() as c, min(v) as lo, max(v) as hi group by k, g "
           "insert into Out;")
    out = []
    for compiler, engine, group, stats, kw in (
            (JaxCompiler, JaxEngine, JaxGroup, JaxStats, {}),
            (SiddhiCompiler, DeviceQueryEngine, TumblingMultiplexGroup,
             IngestStats, {"device": "cpu"})):
        parsed = compiler.parse(app)
        q = parsed.execution_elements[0]
        eng = engine(q, parsed.stream_definitions["S"], n_groups=16,
                     partition_mode=False, defer_order_by=True, **kw)
        g = group(eng, slots)
        seats = []
        for _ in range(slots):
            seats.append(_Seat(g.try_alloc_seat(), stats()))
            g.bind(seats[-1].slot, seats[-1])
        out.append((g, seats))
    return out


def _host(state):
    import torch

    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in state.items()}


@pytest.mark.parametrize("window", ["lengthBatch(24)", "timeBatch(400)"])
def test_mux_acc_step_as_the_jax_group(window):
    """Four seeded tenants staged cycle by cycle into the JAX group and
    the port's: after every cycle the packed bank (every lane, bit for
    bit), the dispatch counters, each seat's pane fill and its pending
    outputs are the same; the pane-closing sub-batches take the slow
    path in both."""
    slots = 4
    (jg, jseats), (tg, tseats) = _groups(window, slots)
    rng = np.random.default_rng(5)
    t0 = 1_000
    for cycle in range(12):
        for i in range(slots):
            n = int(rng.integers(1, 9))
            cols = {"k": rng.integers(0, 3, n).astype(np.int64),
                    "g": rng.integers(0, 2, n).astype(np.float64),
                    "v": rng.integers(0, 40, n).astype(np.float64)}
            ts = (t0 + 100 * cycle + 7 * i
                  + np.sort(rng.integers(0, 90, n))).astype(np.int64)
            jg.stage(jseats[i], {k: v.copy() for k, v in cols.items()},
                     ts.copy(), None)
            tg.stage(tseats[i], cols, ts, None)
        assert (tg.dispatches, tg.combined_steps, tg.slow_steps,
                tg.flush_skips) == (jg.dispatches, jg.combined_steps,
                                    jg.slow_steps, jg.flush_skips)
        jst, tst = _host(jg.state), _host(tg.state)
        assert sorted(jst) == sorted(tst)
        for k in jst:
            assert np.array_equal(
                tst[k].view(np.uint8), np.asarray(jst[k]).view(np.uint8)), k
        for js, ts_ in zip(jg.seats, tg.seats):
            assert (ts_.pane_fill, ts_.pane_end) == (js.pane_fill,
                                                     js.pane_end)
            assert len(ts_.pending_out) == len(js.pending_out)
            while js.pending_out:
                jc, jt, jk, _ = js.pending_out.popleft()
                tc, tt, tk, _ = ts_.pending_out.popleft()
                assert np.array_equal(jt, tt) and jk == tk
                for nm in jc:
                    assert np.array_equal(jc[nm], tc[nm]), nm
    assert tg.combined_steps and tg.slow_steps
