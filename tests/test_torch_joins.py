"""The port's joins held against the JAX package's.

- the join corpora (``tests/test_joins.py``, ``test_device_join.py``,
  ``test_conformance_joins.py``, ``test_conformance_joins2.py``)
  replayed through both packages with ``test_torch_device_query.py``'s
  recorder, in the default mode and under ``@app:execution('tpu')``
  (prepended to every app without an execution annotation): the same
  events in order (timestamps, expiry flags, values and their types,
  floats bit for bit), the same pull results and tables, the same
  ``lowering()`` and the same fallback WARNINGs;
- the device probe's mask against the JAX probe's (``DeviceJoinProbe.
  mask``, the reference's jitted XLA on the CPU) on seeded lanes: int32
  extremes and wrap-around, -0.0, NaN, float32 subnormals in lanes and
  constants, bools, and the chunk edges at 2,047/2,048/2,049 rows by
  8,191/8,192/8,193 buffered rows; a null-carrying batch takes the
  numpy probe in both;
- apps through both packages in both modes where they differ: a DOUBLE
  condition over values whose float32 images are subnormal compares on
  float32 (flushed) under ``execution('tpu')`` and on float64 in the
  default mode, in both packages; the probe's batch count equals the
  reference's; an aggregation join inside a partition is refused by
  both (an instance's namespace has no aggregations).

Bounds: exact everywhere.  The corpora's joined values are copies of
inputs, and their aggregates are sums of integers in float64.
"""

from __future__ import annotations

import numpy as np
import pytest

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.compiler import SiddhiCompiler as JaxCompiler
from siddhi_tpu.core.event import EventBatch as JaxBatch
from siddhi_tpu.core.join import DeviceJoinProbe as JaxProbe
from siddhi_tpu.core.join import JoinSide as JaxSide
from siddhi_tpu.planner.expr import ExpressionCompiler as JaxExprCompiler
from siddhi_tpu.planner.expr import Scope as JaxScope
from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.compiler import SiddhiCompiler
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.join import DeviceJoinProbe, JoinSide
from siddhi_tpu_torch.planner.expr import Scope
from test_torch_device_query import (  # noqa: F401 (a fixture)
    FallbackLog,
    check_scenario,
    corpus_cases,
    one_torch_thread,
    record,
)
from test_torch_query import ev_key

CORPORA = ("test_joins", "test_device_join", "test_conformance_joins",
           "test_conformance_joins2")
# corpus tests the recorder cannot replay, with the reason: none
LEFT_OUT = {}
CASES = corpus_cases(CORPORA, LEFT_OUT)
MODES = {"default": "", "tpu": "@app:execution('tpu')"}


def test_the_corpora_were_read():
    assert len(CASES) >= 50
    assert {c[0] for c in CASES} == set(CORPORA)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize(
    "corpus,cname,mname,k", CASES,
    ids=[f"{c[0][5:]}:{c[1] or ''}.{c[2]}" + (f"-{c[3]}" if c[3] else "")
         for c in CASES])
def test_join_corpus_as_the_reference(corpus, cname, mname, k, mode):
    scenarios, _engines = record(corpus, cname, mname, k, mode=MODES[mode])
    assert scenarios, "the corpus test created no app"
    for sc in scenarios:
        check_scenario(sc)


# -- the probe's mask against the JAX probe's ------------------------------------

DEFS = ("define stream A (sym string, x double, n int, f float, b bool, "
        "l long); define stream B (sym2 string, y double, m int, g float, "
        "c bool, l2 long); ")

CONDITIONS = [
    "A.x < B.y",
    "A.x >= B.y",
    "A.n == B.m",
    "A.n != B.m and A.x <= B.y",
    "A.x + B.y > 8.0",
    "A.n + B.m > 0",  # int32 wrap-around at the extremes
    "A.n * 3 < B.m - 7",
    "A.f == B.g",  # subnormal floats read as zeros of their sign
    "A.f < B.g or A.x > 7.0",
    "A.x * 1.0E30 > B.y",
    "A.x > 1.0E-40",  # a constant whose float32 image is subnormal
    "A.x - B.y < 1.0E-39",
    "A.b and not B.c",
    "A.b == B.c",
    "A.n < 5.5",
    "A.x / B.y >= 1.0",
]
SPECIAL_F = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-40, -1e-40,
                      1.0e-45, 1.17e-38, 1.18e-38, 3.0, 7.5, 8.0, -2.0],
                     dtype=np.float64)
SPECIAL_I = np.array([0, 1, -1, 2**31 - 1, -2**31, 5, 7, 100, -100],
                     dtype=np.int32)


def _cols(rng, n, names):
    x, n_, f, b = names[1:5]
    return {
        names[0]: np.array([f"s{int(v)}" for v in rng.integers(0, 4, n)],
                           dtype=object),
        x: np.where(rng.random(n) < 0.4, rng.choice(SPECIAL_F, n),
                    np.round(rng.uniform(-10, 10, n), 2)),
        n_: np.where(rng.random(n) < 0.4, rng.choice(SPECIAL_I, n),
                     rng.integers(-20, 20, n)).astype(np.int32),
        f: np.where(rng.random(n) < 0.4, rng.choice(SPECIAL_F, n),
                    rng.uniform(-5, 5, n)).astype(np.float32),
        b: rng.random(n) < 0.5,
        names[5]: rng.integers(-2**40, 2**40, n),
    }


A_NAMES = ["sym", "x", "n", "f", "b", "l"]
B_NAMES = ["sym2", "y", "m", "g", "c", "l2"]


def _probes(cond):
    """The JAX probe and the port's for condition ``cond`` over A, B."""
    app = DEFS + f"from A join B on {cond} select A.n as n insert into O;"
    out = []
    for compiler, side_cls, scope_cls, make in (
            (JaxCompiler, JaxSide, JaxScope, "jax"),
            (SiddhiCompiler, JoinSide, Scope, "torch")):
        parsed = compiler.parse(app)
        sides = [side_cls(r, parsed.stream_definitions[r], [], None)
                 for r in ("A", "B")]
        scope = scope_cls()
        for side in sides:
            for a in side.definition.attributes:
                scope.add(side.ref, a.name, side.qualified_key(a.name),
                          a.type)
        expr = parsed.execution_elements[0].input_stream.on_condition
        if make == "jax":
            probe = JaxProbe(JaxExprCompiler(scope).compile(expr), *sides)
        else:
            probe = DeviceJoinProbe(expr, scope, *sides, "cpu")
        out.append((probe, sides))
    return out


def _batches(rng, n_a, n_b):
    ca, cb = _cols(rng, n_a, A_NAMES), _cols(rng, n_b, B_NAMES)
    ts_a = np.arange(n_a, dtype=np.int64)
    ts_b = np.arange(n_b, dtype=np.int64)
    return ((JaxBatch("A", A_NAMES, ca, ts_a), JaxBatch("B", B_NAMES, cb,
                                                         ts_b)),
            (EventBatch("A", A_NAMES, {k: v.copy() for k, v in ca.items()},
                        ts_a),
             EventBatch("B", B_NAMES, {k: v.copy() for k, v in cb.items()},
                        ts_b)))


@pytest.mark.parametrize("cond", CONDITIONS)
def test_probe_mask_as_the_reference(cond):
    (jp, (ja, jb)), (tp, (ta, tb)) = _probes(cond)
    rng = np.random.default_rng(CONDITIONS.index(cond))
    for n_a, n_b in ((37, 53), (1, 200), (120, 1)):
        (jra, jrb), (tra, trb) = _batches(rng, n_a, n_b)
        for side_j, rows_j, other_j, buf_j, side_t, rows_t, other_t, buf_t in (
                (ja, jra, jb, jrb, ta, tra, tb, trb),
                (jb, jrb, ja, jra, tb, trb, ta, tra)):
            jm = jp.mask(side_j, rows_j, other_j, buf_j)
            tm = tp.mask(side_t, rows_t, other_t, buf_t)
            assert tm.dtype == np.bool_ and tm.shape == jm.shape
            assert np.array_equal(jm, tm), cond


@pytest.mark.parametrize("n_a", [2047, 2048, 2049])
@pytest.mark.parametrize("n_b", [8191, 8192, 8193])
def test_probe_mask_at_the_chunk_edges(n_a, n_b):
    """The blocks of ``MAX_ROWS`` by ``MAX_BUF`` and their edges: the
    mask and its row-major pairs do not depend on the blocking."""
    cond = "A.x < B.y and A.n != B.m"
    (jp, (ja, jb)), (tp, (ta, tb)) = _probes(cond)
    rng = np.random.default_rng(n_a * 10007 + n_b)
    (jra, jrb), (tra, trb) = _batches(rng, n_a, n_b)
    jm = jp.mask(ja, jra, jb, jrb)
    assert np.array_equal(jm, tp.mask(ta, tra, tb, trb))
    ai, bi, any_ = tp.pairs(ta, tra, tb, trb, outer=True)
    jai, jbi = np.nonzero(jm)
    assert np.array_equal(ai, jai) and np.array_equal(bi, jbi)
    assert np.array_equal(any_, jm.any(axis=1))


def test_null_batch_takes_the_numpy_probe_in_both():
    (jp, (ja, jb)), (tp, (ta, tb)) = _probes("A.x < B.y")
    (jra, jrb), (tra, trb) = _batches(np.random.default_rng(3), 5, 7)
    for batch in (jra, tra):
        col = np.empty(5, dtype=object)
        col[:] = [1.0, None, 3.0, 4.0, None]
        batch.columns["x"] = col
    assert jp.mask(ja, jra, jb, jrb) is None
    assert tp.mask(ta, tra, tb, trb) is None
    assert tp.pairs(ta, tra, tb, trb, outer=False) is None
    # a null in a column the condition does not read keeps the probe
    (jp, (ja, jb)), (tp, (ta, tb)) = _probes("A.n == B.m")
    assert np.array_equal(jp.mask(ja, jra, jb, jrb),
                          tp.mask(ta, tra, tb, trb))


@pytest.mark.parametrize("cond,why", [
    ("A.sym == B.sym2", "'A.sym'"),
    ("A.l < B.l2", "'A.l'"),
    ("A.x < B.y and eventTimestamp() > 0", "'__ts'"),
])
def test_probe_refusals_as_the_reference(cond, why):
    """STRING, LONG and the timestamp get no lane: the plan-time check
    fails on the missing key, with the reference's message."""
    app = (DEFS + f"@info(name='j') from A#window.length(3) join "
           f"B#window.length(3) on {cond} select A.n as n insert into O;")
    msgs = []
    for mgr, logger in ((JaxManager(), "siddhi_tpu"),
                        (SiddhiManager(device="cpu"), "siddhi_tpu_torch")):
        with FallbackLog(logger) as log:
            rt = mgr.create_siddhi_app_runtime(
                "@app:playback @app:execution('tpu') " + app)
        assert rt.lowering() == {"j": "host"}
        msgs.append(log.messages)
        mgr.shutdown()
    assert msgs[0] == msgs[1]
    assert msgs[1] == [f"query 'j': join device probe unavailable (join "
                       f"condition not device-traceable: {why}); numpy "
                       f"probe used"]


# -- apps through both packages --------------------------------------------------


def both(app, sends, out="O"):
    """``[(rows, lowering, probe calls)]`` of the JAX package and the
    port for the same app and sends."""
    res = []
    for mgr in (JaxManager(), SiddhiManager(device="cpu")):
        try:
            rt = mgr.create_siddhi_app_runtime("@app:playback " + app)
            got = []
            rt.add_callback(out, lambda evs: got.extend(ev_key(e)
                                                        for e in evs))
            rt.start()
            for sid, row, ts in sends:
                rt.get_input_handler(sid).send(row, ts)
            calls = sum(qr.join_runtime.probe_invocations
                        for qr in rt.query_runtimes.values()
                        if getattr(qr, "join_runtime", None) is not None)
            res.append((got, rt.lowering(), calls))
            rt.shutdown()
        finally:
            mgr.shutdown()
    return res


SUB = [("A", ["a", 1.0e-45, 1, 0.0, True, 1], 1),
       ("B", ["b", 2.0e-45, 1, 0.0, True, 2], 2),
       ("B", ["b", -1.0e-41, 2, 0.0, True, 3], 3),
       ("A", ["a", 3.0, 2, 0.0, False, 4], 4),
       ("B", ["b", 5.0e-39, 3, 0.0, True, 5], 5),
       ("A", ["a", -0.0, 3, 0.0, True, 6], 6)]


@pytest.mark.parametrize("mode", ["", "@app:execution('tpu') "])
def test_subnormal_condition_per_mode_as_the_reference(mode):
    app = (mode + DEFS + "@info(name='j') from A#window.length(4) join "
           "B#window.length(4) on A.x < B.y select A.x as x, B.y as y "
           "insert into O;")
    (jgot, jlow, jcalls), (tgot, tlow, tcalls) = both(app, SUB)
    assert (tgot, tlow, tcalls) == (jgot, jlow, jcalls)
    assert tlow == {"j": "device_probe" if mode else "host"}
    # float64 in the default mode finds pairs that float32 flushes away
    assert (len(tgot) > 0) == (not mode)


def mk_events(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sid = "A" if rng.integers(2) else "B"
        out.append((sid, [f"s{int(rng.integers(4))}",
                          float(rng.integers(0, 10)), int(rng.integers(0, 5)),
                          float(rng.uniform(-1, 1)), bool(rng.integers(2)),
                          int(rng.integers(0, 9))],
                    1000 + i * int(rng.integers(1, 60))))
    return out


@pytest.mark.parametrize("shape", [
    "from A#window.length(3) join B#window.length(3) on A.x < B.y",
    "from A#window.time(500 ms) join B#window.time(500 ms) on A.x >= B.y",
    "from A[x > 1.0]#window.length(4) join B[y < 9.0]#window.length(4) "
    "on A.x < B.y and A.n != B.m",
    "from A#window.length(2) left outer join B#window.length(2) "
    "on A.x < B.y",
    "from A#window.length(2) full outer join B#window.length(2) "
    "on A.n == B.m",
    "from A#window.length(3) unidirectional join B#window.length(3) "
    "on A.x < B.y",
    "from A#window.length(1) join B#window.length(2) on A.x <= B.y",
])
def test_probe_calls_as_the_reference(shape):
    """The device probe runs on the batches the reference's runs on, and
    the rows are the reference's (expired pairs included)."""
    app = ("@app:execution('tpu') " + DEFS + f"@info(name='j') {shape} "
           "select A.x as x, B.y as y, A.n as n insert into O;")
    (jgot, jlow, jcalls), (tgot, tlow, tcalls) = both(app, mk_events(60, 7))
    assert tlow == jlow == {"j": "device_probe"}
    assert tcalls == jcalls > 0
    assert tgot == jgot


def test_aggregation_join_in_a_partition_as_the_reference():
    """A partition instance's namespace holds the app's tables and named
    windows but not its aggregations, in the reference's facade as in
    the port's: an aggregation join inside a partition is refused at
    creation by both, with the same error."""
    app = ("@app:name('p') @app:playback define stream S (k int, v double); "
           "define stream Q (k int); define aggregation Agg from S select k, "
           "sum(v) as total group by k aggregate every sec ... min; "
           "partition with (k of Q) begin @info(name='q') from Q as q join "
           "Agg as a on q.k == a.k within 0L, 9000000000000L per 'seconds' "
           "select q.k as k, a.total as total insert into O; end;")
    errors = []
    for mgr in (JaxManager(), SiddhiManager(device="cpu")):
        try:
            with pytest.raises(Exception) as info:
                mgr.create_siddhi_app_runtime(app)
            errors.append((type(info.value).__name__, str(info.value)))
        finally:
            mgr.shutdown()
    assert errors[0] == errors[1]
    assert errors[1][0] == "DefinitionNotExistError"
