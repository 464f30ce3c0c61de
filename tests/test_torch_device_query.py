"""The port's device query path held against the JAX package's.

Three kinds of case:

- the device corpora (``tests/test_device_query.py``,
  ``test_device_single_integration.py``, ``test_device_wide_aggs.py``)
  replayed through both packages.  Each corpus test runs against a
  private copy of its module whose ``SiddhiManager`` and
  ``compile_query`` are the JAX package's wrapped in recorders: every
  app created (its lowering, callback targets, sends and output) and
  every device engine compiled (its app, options, ``process`` calls,
  rows and state after each call) is recorded; the port's
  ``SiddhiManager(device="cpu")`` and ``compile_query(..., device=
  "cpu")`` then replay them.  An app the JAX package refuses, the port
  refuses; one outside the port's slices raises naming its
  ``ROADMAP.md`` item.  Where the JAX package falls back from a device
  path to its host engine with a WARNING, the port must log the same
  WARNING text;
- seeded engines (``compile_query`` in both packages on numpy columns)
  for the filter, running, sliding length and time, and tumbling
  lengthBatch and timeBatch kinds, outputs and whole state compared
  after every step;
- a JAX device query's snapshot restored into the port mid-stream, and
  the lowering of ``chip_smoke.py``'s device-query apps in the JAX
  package, pinned.

Bounds.  Exact (types and bits): filter outputs, passthrough columns,
int lanes, ``count``, ``min``/``max``/``minForever``/``maxForever``,
``and``/``or``, row order, timestamps, ``lowering()`` and every state
lane but the float sums.  Float32 sums (``sum``, ``avg``) come from the
reference's XLA matmul and reduction order: they are held to the
reference's own bound for its device path, ``rel=1e-4, abs=1e-3``
(``tests/test_device_query.py:62``); ``stdDev``, the square root of a
float32 difference of sums, to the reference's ``rel=2e-3, abs=5e-3``
(``tests/test_device_wide_aggs.py``, ``test_device_partitioned.py``)
on the corpora and to its cancellation floor ``sqrt(16 eps32) max|x|``
on the seeded engines.  The corpora's values are mostly integers, whose
float32 sums are exact in any order, so most of their sums match bit
for bit too.
"""

from __future__ import annotations

import importlib.util
import inspect
import itertools
import logging
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.core.event import Event as JaxEvent
from siddhi_tpu.ops.device_query import compile_query as jax_compile_query
from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.core.event import Event, EventBatch
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.ops.device_query import compile_query

TESTS = Path(__file__).resolve().parent


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the engine's small CPU ops (and the
    prefix matmuls' BLAS calls) spin-wait for a pool that parallel test
    workers oversubscribe, which can slow a test a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = TESTS.parent
CORPORA = ("test_device_query", "test_device_single_integration",
           "test_device_wide_aggs")
# corpus tests the recorders cannot replay, keyed (corpus, class,
# method), None for a whole class or a module function's class: those
# that import the JAX package inside the test, held below by the tests
# named beside them; and one of the dense runtime's intern, no device
# query.
LEFT_OUT = {
    ("test_device_query", None, "test_direct_api_rejects_order_by"):
        "test_direct_api_order_by_as_the_reference",
    ("test_device_wide_aggs", "TestRateLimitersOnDevicePath",
     "test_group_keys_aux_reaches_rate_limiter"):
        "test_group_keys_reach_the_rate_limiter_as_the_reference",
    ("test_device_single_integration", "TestReviewRegressions",
     "test_mixed_dtype_partition_keys_fall_back_to_dict_intern"):
        "the dense runtime's intern",
}
# what the port refuses in the corpora, with the ROADMAP.md item: none
# since device tables came
OUTSIDE = {}
# corpus classes built on the app's snapshot and restore, whose state
# crosses runtimes: replayed as whole tests through both packages
# (test_torch_persistence.py's twin runs), not app by app
TWINS = {("test_device_single_integration", "TestSnapshotRestore")}

SUM_KINDS = re.compile(r"\b(sum|avg)\s*\(")
STD = re.compile(r"\bstdDev\s*\(")
EPS32 = 2.0 ** -23


def bound(app):
    """``(rel, abs)`` for the floats of an app's device outputs, or None
    for exact: only the float32 sums of a device query may differ."""
    if "execution('tpu'" not in app:
        return None  # the host runtime: float64 numpy in both
    if STD.search(app):
        return 2e-3, 5e-3
    return (1e-4, 1e-3) if SUM_KINDS.search(app) else None


def same_value(a, b, tol):
    """Equal types, and equal bits unless ``tol`` bounds a float."""
    if type(a) is not type(b):
        return False
    if isinstance(a, (float, np.floating)):
        if np.isnan(a) or np.isnan(b):
            return bool(np.isnan(a) and np.isnan(b))
        if tol is None:
            return np.float64(a).tobytes() == np.float64(b).tobytes()
        return abs(a - b) <= tol[1] + tol[0] * abs(a)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def same_rows(jrows, trows, tol):
    """Row lists (tuples or dicts of values) equal under ``tol``."""
    if len(jrows) != len(trows):
        return False
    for x, y in zip(jrows, trows):
        xs = list(x.values()) if isinstance(x, dict) else list(x)
        ys = list(y.values()) if isinstance(y, dict) else list(y)
        if isinstance(x, dict) and list(x) != list(y):
            return False
        if len(xs) != len(ys) or not all(
                same_value(a, b, tol) for a, b in zip(xs, ys)):
            return False
    return True


# -- recording the corpora ---------------------------------------------------


class Scenario:
    """One app a corpus test created through ``SiddhiManager``."""

    def __init__(self, app):
        self.app = app
        self.targets = {}
        self.sends = []
        self.got = {}
        self.lowering = None
        self.dense_partitions = None
        # the WARNINGs of a fallback from a device path to the host,
        # logged while the app was created
        self.fallbacks = []
        self.error = None
        self.unsupported = None
        # the JAX runtime, and each table's rows once the test is over
        self.runtime = None
        self.tables = None


def table_rows(rt):
    """Each table's live rows, ``(timestamp, values)`` in slot order."""
    out = {}
    for name, t in rt.tables.items():
        b = t.rows_batch()
        out[name] = [(int(b.timestamps[i]),
                      tuple(b.columns[a][i] for a in b.attribute_names))
                     for i in range(len(b))]
    return out


# the one phrase of a fallback reason the port words for its own
# compiler: the reference's device query engine traces with JAX
PORT_WORDING = {"expression not evaluable on the device lanes":
                "expression not jax-traceable"}


class FallbackLog(logging.Handler):
    """Collects the device-path fallback WARNINGs of one logger while
    it is attached (``with FallbackLog("siddhi_tpu") as log:``), the
    port's in the reference's words (``PORT_WORDING``)."""

    def __init__(self, logger: str):
        super().__init__(logging.WARNING)
        self.logger = logging.getLogger(logger)
        self.messages = []

    def emit(self, record):
        msg = record.getMessage()
        for ours, theirs in PORT_WORDING.items():
            msg = msg.replace(ours, theirs)
        if "unavailable (" in msg:
            self.messages.append(msg)

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def _ev_row(e):
    return (e.timestamp, e.is_expired, tuple(e.data))


class _Handler:
    def __init__(self, h, sid, sc):
        self._h, self._sid, self._sc = h, sid, sc

    def send(self, data, timestamp=None):
        self._sc.sends.append(("send", self._sid, data, timestamp))
        return self._h.send(data, timestamp)

    def send_batch(self, batch):
        self._sc.sends.append(("batch", self._sid, batch, None))
        return self._h.send_batch(batch)

    def __getattr__(self, name):
        self._sc.unsupported = name
        return getattr(self._h, name)


class _Runtime:
    # app-runtime attributes both packages have, passed through (the
    # tables' rows are compared when the test is over)
    SHARED = ("query_runtimes", "junctions", "partitions", "lowering",
              "query_names", "tables")

    def __init__(self, rt, sc):
        self._rt, self._sc = rt, sc

    def add_callback(self, target, cb):
        kind = "stream" if target in self._rt.junctions else "query"
        # a target the JAX run refuses is not replayed
        self._rt.add_callback(target, cb)
        self._sc.targets[target] = kind
        got = self._sc.got.setdefault(target, [])
        if kind == "stream":
            self._rt.add_callback(target, lambda evs: got.extend(
                _ev_row(e) for e in evs))
        else:
            self._rt.add_callback(target, lambda ts, i, o: got.append(
                (ts, [_ev_row(e) for e in i or []],
                 [_ev_row(e) for e in o or []])))

    def get_input_handler(self, sid):
        return _Handler(self._rt.get_input_handler(sid), sid, self._sc)

    def start(self):
        self._rt.start()

    def shutdown(self):
        self._rt.shutdown()

    def query(self, q):
        """A pull query, recorded in order with the sends: its rows, or
        that it raised."""
        try:
            out = self._rt.query(q)
        except Exception:
            self._sc.sends.append(("query", None, q, None))
            raise
        self._sc.sends.append(("query", None, q, [_ev_row(e) for e in out]))
        return out

    def __getattr__(self, name):
        if name not in self.SHARED:
            self._sc.unsupported = name
        return getattr(self._rt, name)


class EngineRecord:
    """One ``compile_query`` call of a corpus test and what its engine
    did."""

    def __init__(self, args, kwargs):
        self.args, self.kwargs = args, kwargs
        self.error = None
        self.calls = []  # (cols, ts, part_keys, rows, state after)


class _Engine:
    """The JAX engine, recording each ``process``."""

    def __init__(self, eng, rec):
        self._eng, self._rec = eng, rec

    def process(self, state, cols, ts, part_keys=None):
        cols = {k: np.array(v, copy=True) for k, v in cols.items()}
        ts = np.array(ts, copy=True)
        state, rows = self._eng.process(state, cols, ts, part_keys)
        host = {k: np.array(np.asarray(v), copy=True)
                for k, v in state.items()}
        self._rec.calls.append((cols, ts, part_keys, rows, host))
        return state, rows

    def __getattr__(self, name):
        return getattr(self._eng, name)


def _load(corpus, tag):
    spec = importlib.util.spec_from_file_location(
        f"_{corpus}_{tag}", TESTS / f"{corpus}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _param_sets(fn):
    sets = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names = [n.strip() for n in (mark.args[0].split(",")
                                     if isinstance(mark.args[0], str)
                                     else mark.args[0])]
        rows = [dict(zip(names, v if len(names) > 1 else (v,)))
                for v in (getattr(v, "values", v) for v in mark.args[1])]
        sets = [{**a, **b} for a, b in itertools.product(sets, rows)]
    return sets


def corpus_cases(corpora, left_out):
    out = []
    for corpus in corpora:
        mod = _load(corpus, "names")
        for cname in sorted(vars(mod)):
            cls = getattr(mod, cname)
            if cname.startswith("Test") and isinstance(cls, type):
                if (corpus, cname, None) in left_out:
                    continue
                fns = [(cname, m) for m in sorted(vars(cls))
                       if m.startswith("test_")]
            elif cname.startswith("test_") and callable(cls):
                fns = [(None, cname)]
            else:
                continue
            for c, m in fns:
                if (corpus, c, m) in left_out:
                    continue
                fn = getattr(getattr(mod, c), m) if c else getattr(mod, m)
                for k in range(len(_param_sets(fn))):
                    out.append((corpus, c, m, k))
    return out


def record(corpus, cname, mname, k, mode=""):
    """Run one corpus test against the recorders; returns its scenarios
    and engine records.  ``mode``, an ``@app:execution`` annotation,
    goes in front of every app that has none."""
    mod = _load(corpus, "rec")
    scenarios, engines = [], []

    class RecordingManager:
        def __init__(self, *a, **kw):
            self._m = JaxManager(*a, **kw)

        def create_siddhi_app_runtime(self, app):
            if mode and "@app:execution" not in app:
                app = mode + " " + app
            if "@app:playback" not in app:
                app = "@app:playback " + app
            sc = Scenario(app)
            scenarios.append(sc)
            try:
                with FallbackLog("siddhi_tpu") as log:
                    rt = self._m.create_siddhi_app_runtime(app)
            except Exception as e:
                sc.error = e
                raise
            sc.fallbacks = log.messages
            sc.runtime = rt
            sc.lowering = rt.lowering()
            sc.dense_partitions = [p.is_dense for p in rt.partitions.values()]
            return _Runtime(rt, sc)

        def shutdown(self):
            self._m.shutdown()

        def __getattr__(self, name):
            if scenarios:
                scenarios[-1].unsupported = name
            return getattr(self._m, name)

    def recording_compile(*args, **kwargs):
        rec = EngineRecord(args, kwargs)
        engines.append(rec)
        try:
            return _Engine(jax_compile_query(*args, **kwargs), rec)
        except Exception as e:
            rec.error = e
            raise

    mod.SiddhiManager = RecordingManager
    if hasattr(mod, "compile_query"):
        mod.compile_query = recording_compile
    owner = getattr(mod, cname)() if cname else mod
    fn = getattr(owner, mname)
    kwargs = _param_sets(fn)[k]
    manager = None
    if "manager" in inspect.signature(fn).parameters:
        # the corpus's ``manager`` fixture
        manager = kwargs["manager"] = RecordingManager()
    try:
        fn(**kwargs)
    except Exception:
        # the corpus asserts its own expectations; the comparison here
        # is with the JAX run either way
        pass
    finally:
        if manager is not None:
            manager.shutdown()
    for sc in scenarios:
        if sc.runtime is not None:
            sc.tables = table_rows(sc.runtime)
            sc.runtime = None
    return scenarios, engines


# -- replaying through the port ----------------------------------------------


def _port_data(data):
    if isinstance(data, JaxEvent):
        return Event(data.timestamp, list(data.data), data.is_expired)
    if isinstance(data, list) and data and isinstance(data[0], JaxEvent):
        return [_port_data(e) for e in data]
    return data


def _port_batch(b):
    return EventBatch(b.stream_id, list(b.attribute_names),
                      {k: np.array(v, copy=True) for k, v in
                       b.columns.items()},
                      np.array(b.timestamps, copy=True),
                      np.array(b.types, copy=True))


def replay(sc, fallbacks=None, tables=None):
    """The scenario through the port: ``(output, lowering)``;
    ``fallbacks``, a list, gets the fallback WARNINGs of its creation;
    ``tables``, a dict, each table's rows before shutdown.  Each pull
    query gives the JAX run's rows (or raises where it raised)."""
    mgr = SiddhiManager(device="cpu")
    try:
        with FallbackLog("siddhi_tpu_torch") as log:
            rt = mgr.create_siddhi_app_runtime(sc.app)
        if fallbacks is not None:
            fallbacks.extend(log.messages)
        low = rt.lowering()
        got = {}
        for target, kind in sc.targets.items():
            g = got.setdefault(target, [])
            if kind == "stream":
                rt.add_callback(target, lambda evs, g=g: g.extend(
                    _ev_row(e) for e in evs))
            else:
                rt.add_callback(target, lambda ts, i, o, g=g: g.append(
                    (ts, [_ev_row(e) for e in i or []],
                     [_ev_row(e) for e in o or []])))
        rt.start()
        for how, sid, data, ts in sc.sends:
            if how == "query":
                check_pull(rt, data, ts, bound(sc.app))
                continue
            h = rt.get_input_handler(sid)
            if how == "batch":
                h.send_batch(_port_batch(data))
            else:
                h.send(_port_data(data), ts)
        if tables is not None:
            tables.update(table_rows(rt))
        rt.shutdown()
        return got, low
    finally:
        mgr.shutdown()


def check_pull(rt, q, jrows, tol):
    """The port's rows of pull query ``q`` are the JAX run's ``jrows``
    (None: the JAX run raised, and so must the port)."""
    if jrows is None:
        with pytest.raises(Exception):
            rt.query(q)
        return
    trows = [_ev_row(e) for e in rt.query(q)]
    assert [r[:2] for r in trows] == [r[:2] for r in jrows], q
    assert same_rows([r[2] for r in jrows], [r[2] for r in trows], tol), (
        q, jrows, trows)


def assert_same_output(jgot, tgot, tol):
    assert set(jgot) == set(tgot)
    for target, jrows in jgot.items():
        trows = tgot[target]
        assert len(trows) == len(jrows), target
        for jr, tr in zip(jrows, trows):
            if isinstance(jr[1], list):  # query callback: (ts, in, out)
                assert jr[0] == tr[0]
                assert same_rows([r[2] for r in jr[1]],
                                 [r[2] for r in tr[1]], tol), (jr, tr)
                assert [r[:2] for r in jr[1]] == [r[:2] for r in tr[1]]
                assert same_rows([r[2] for r in jr[2]],
                                 [r[2] for r in tr[2]], tol), (jr, tr)
            else:  # (ts, expired, data)
                assert jr[:2] == tr[:2], (jr, tr)
                assert same_rows([jr[2]], [tr[2]], tol), (jr, tr)


def check_scenario(sc, outside=OUTSIDE):
    """Replay one recorded app through the port and compare."""
    if sc.error is not None:
        with pytest.raises(Exception):
            replay(sc)
        return
    items = [i for i, pat in outside.items() if re.search(pat, sc.app)]
    if items:
        # outside the port's slices: it raises, naming the item (what
        # the corpus test did with the app after does not matter)
        with pytest.raises(SiddhiAppCreationError) as info:
            replay(sc)
        assert any(f"ROADMAP.md §1 item {i}" in str(info.value)
                   for i in items), str(info.value)
        return
    assert sc.unsupported is None, sc.unsupported
    fallbacks = []
    tables = {}
    tgot, tlow = replay(sc, fallbacks, tables)
    assert tlow == sc.lowering
    assert fallbacks == sc.fallbacks
    assert_same_output(sc.got, tgot, bound(sc.app))
    if sc.tables is not None:
        assert set(tables) == set(sc.tables)
        for name, jrows in sc.tables.items():
            assert [r[0] for r in tables[name]] == [r[0] for r in jrows]
            assert same_rows([r[1] for r in jrows],
                             [r[1] for r in tables[name]],
                             bound(sc.app)), name


def replay_engine(rec):
    """Replay one recorded ``compile_query`` through the port, comparing
    rows and state after every call."""
    if rec.error is not None:
        with pytest.raises(SiddhiAppCreationError):
            compile_query(*rec.args, **rec.kwargs, device="cpu")
        return
    eng = compile_query(*rec.args, **rec.kwargs, device="cpu")
    app = rec.args[0]
    tol = (2e-3, 5e-3) if STD.search(app) else (
        (1e-4, 1e-3) if SUM_KINDS.search(app) else None)
    state = eng.init_state()
    for cols, ts, pk, jrows, jstate in rec.calls:
        state, rows = eng.process(state, cols, ts, pk)
        assert same_rows(jrows, rows, tol), (jrows, rows)
        assert_same_state(jstate, eng.state_to_host(state), tol)


def assert_same_state(jstate, tstate, tol):
    """Every lane the same dtype and shape; the float sums within
    ``tol``, every other lane bit for bit."""
    assert set(jstate) == set(tstate)
    for k, j in jstate.items():
        t = tstate[k]
        assert (j.dtype, j.shape) == (t.dtype, t.shape), k
        if k in ("acc_sum", "acc_sumsq") and tol is not None:
            assert np.allclose(t, j, rtol=tol[0], atol=tol[1],
                               equal_nan=True), k
        else:
            assert np.array_equal(j, t, equal_nan=j.dtype.kind == "f"), k


CASES = corpus_cases(CORPORA, LEFT_OUT)


def test_the_corpora_were_read():
    assert len(CASES) >= 60
    assert {c[0] for c in CASES} == set(CORPORA)


@pytest.mark.parametrize(
    "corpus,cname,mname,k", CASES,
    ids=[f"{c[0][5:]}:{c[1] or ''}.{c[2]}" + (f"-{c[3]}" if c[3] else "")
         for c in CASES])
def test_corpus_as_the_reference(corpus, cname, mname, k, tmp_path,
                                 request):
    if (corpus, cname) in TWINS:
        from test_torch_persistence import check_twin

        check_twin(corpus, cname, mname, k, tmp_path, request)
        return
    scenarios, engines = record(corpus, cname, mname, k)
    assert scenarios or engines, "the corpus test created nothing"
    for sc in scenarios:
        check_scenario(sc)
    for rec in engines:
        replay_engine(rec)


# -- seeded engines ----------------------------------------------------------

SEED_DEFINE = ("define stream S (k long, v double, i int, f float, b bool, "
               "s string); ")
ENGINE_QUERIES = {
    "filter": "from S[v > 20.0 and i != 3] select k, s, v, v * 2.0 as d, "
              "i / 3 as q, i % 4 as r, b and f > 5.0 as bb insert into O;",
    "filter_long_pairs": "from S[k >= 3 and k != 4000000000] select k, i, "
                         "eventTimestamp() as t insert into O;",
    "running": "from S[v > 0.0] select k, sum(v) as s, count() as c, "
               "avg(f) as a, min(v) as lo, max(i) as hi, stdDev(v) as sd, "
               "minForever(f) as mf, maxForever(v) as xf, and(b) as an, "
               "or(b) as o group by k insert into O;",
    "sliding_length": "from S[v > 5.0]#window.length(7) select k, sum(v) "
                      "as s, count() as c, min(v) as lo, max(v) as hi, "
                      "stdDev(f) as sd, maxForever(i) as xf group by k "
                      "insert into O;",
    "sliding_time": "from S#window.time(300 ms) select s, sum(v) as t, "
                    "avg(f) as a, or(b) as o group by s having t > 10.0 "
                    "insert into O;",
    "tumbling_length": "from S[v > 10.0]#window.lengthBatch(9) select i, "
                       "sum(v) as t, count() as c, i * 2 as kk, "
                       "maxForever(v) as m group by i insert into O;",
    "tumbling_time": "from S#window.timeBatch(500 ms) select s, sum(f) as "
                     "t, min(i) as m group by s insert into O;",
}


def seeded_batches(seed, sizes=(13, 40, 1, 70, 25, 2100)):
    """Seeded columns with three-decimal floats (so float32 sums round
    and their order shows), 1-60 ms apart; the last batch spans two
    MAX_DEVICE_BATCH chunks."""
    rng = np.random.default_rng(seed)
    t0, out = 1000, []
    for n in sizes:
        ts = t0 + np.cumsum(rng.integers(1, 60, n)).astype(np.int64)
        t0 = int(ts[-1])
        out.append(({
            "k": rng.integers(0, 5, n).astype(np.int64) * 1_000_000_007,
            "v": np.round(rng.uniform(-10, 100, n), 3),
            "i": rng.integers(-50, 50, n).astype(np.int32),
            "f": rng.uniform(0, 10, n).astype(np.float32),
            "b": rng.random(n) < 0.5,
            "s": np.asarray([f"s{x}" for x in rng.integers(0, 3, n)],
                            dtype=object)}, ts))
    return out


def assert_rows_bounded(jrows, trows, max_abs):
    """Rows of a seeded engine: floats of the sum kinds within the
    reference's bound, stdDev within its cancellation floor, every other
    value exact."""
    assert len(jrows) == len(trows)
    for x, y in zip(jrows, trows):
        assert list(x) == list(y)
        for name in x:
            a, b = x[name], y[name]
            tol = None
            if name in ("s", "t", "a"):
                tol = (1e-4, 1e-3)
            elif name == "sd":
                tol = (0.0, 4 * np.sqrt(EPS32) * max_abs)
            assert same_value(a, b, tol), (name, a, b)


@pytest.mark.parametrize("name", list(ENGINE_QUERIES))
def test_seeded_engine_as_the_reference(name):
    """``compile_query`` in both packages on the same seeded columns:
    the rows of every call, and the whole state after it."""
    app = SEED_DEFINE + "@info(name='q') " + ENGINE_QUERIES[name]
    jeng = jax_compile_query(app, "q", n_groups=256)
    teng = compile_query(app, "q", n_groups=256, device="cpu")
    assert teng.kind == jeng.kind
    js, ts_ = jeng.init_state(), teng.init_state()
    n_rows = 0
    for cols, ts in seeded_batches(len(name)):
        js, jrows = jeng.process(js, cols, ts)
        ts_, trows = teng.process(ts_, cols, ts)
        assert_rows_bounded(jrows, trows, max_abs=100.0)
        assert_same_state({k: np.asarray(v) for k, v in js.items()},
                          teng.state_to_host(ts_), (1e-4, 1e-2))
        n_rows += len(trows)
    assert n_rows


def test_direct_api_order_by_as_the_reference():
    """``compile_query`` has no host selector downstream: order by and
    limit raise in both packages (the ``SiddhiManager`` path applies
    them on the host)."""
    app = ("define stream S (k int, v double); @info(name='q') from S "
           "select k, sum(v) as s group by k order by s desc limit 1 "
           "insert into O;")
    with pytest.raises(Exception):
        jax_compile_query(app, "q")
    with pytest.raises(SiddhiAppCreationError):
        compile_query(app, "q", device="cpu")


def test_group_keys_reach_the_rate_limiter_as_the_reference():
    """The device emit carries the group-key side channel to the rate
    limiter's position, as the host selector's does."""
    app = ("@app:playback @app:execution('tpu') define stream S (k long, "
           "v double, n long, ok bool); @info(name='q') from S select k, "
           "sum(v) as s group by k insert into O;")
    seen = {}
    for port in (False, True):
        mgr = SiddhiManager(device="cpu") if port else JaxManager()
        try:
            rt = mgr.create_siddhi_app_runtime(app)
            qr = rt.query_runtimes["q"]
            keys = seen.setdefault(port, [])
            orig = qr.rate_limiter.process

            def spy(batch, now, orig=orig, keys=keys):
                keys.append(list(batch.aux.get("group_keys") or []))
                return orig(batch, now)

            qr.rate_limiter.process = spy
            rt.start()
            h = rt.get_input_handler("S")
            h.send([7, 1.0, 0, True], timestamp=1000)
            h.send([9, 2.0, 0, True], timestamp=1001)
            rt.shutdown()
        finally:
            mgr.shutdown()
    assert seen[True] == seen[False] == [[7], [9]]


def test_re_anchor_past_int32_as_the_reference():
    """A jump of 34 days of stream time re-anchors the relative clock in
    both packages: the window state shifts and the old event expires."""
    app = ("define stream S (k int, v double); @info(name='q') from "
           "S#window.time(10 sec) select sum(v) as s, count() as c insert "
           "into O;")
    jeng = jax_compile_query(app, "q")
    teng = compile_query(app, "q", device="cpu")
    js, ts_ = jeng.init_state(), teng.init_state()
    for t, v in ((1_000, 1.0), (1_500, 2.0), (3_000_001_000, 4.0),
                 (3_000_002_000, 8.0)):
        cols = {"k": np.asarray([1], dtype=np.int32),
                "v": np.asarray([v])}
        js, jrows = jeng.process(js, cols, np.asarray([t]))
        ts_, trows = teng.process(ts_, cols, np.asarray([t]))
        assert same_rows(jrows, trows, None)
        assert teng.base_ts == jeng.base_ts
        assert_same_state({k: np.asarray(x) for k, x in js.items()},
                          teng.state_to_host(ts_), None)


def test_timer_pane_flush_as_the_reference():
    """A timeBatch pane closes on the watermark that another stream's
    event moves (the scheduler task), with no further event on S."""
    app = ("@app:playback @app:execution('tpu') define stream S (k long, "
           "v double); define stream Tick (x double); @info(name='q') from "
           "S#window.timeBatch(1 sec) select sum(v) as s insert into Out; "
           "@info(name='t') from Tick select x insert into Ignored;")
    sends = [("S", [0, 10.0], 1000), ("S", [0, 20.0], 1400),
             ("Tick", [1.0], 2500), ("S", [0, 5.0], 2600),
             ("Tick", [1.0], 4000)]

    def run(port):
        mgr = SiddhiManager(device="cpu") if port else JaxManager()
        try:
            rt = mgr.create_siddhi_app_runtime(app)
            got = []
            rt.add_callback("Out", lambda evs: got.extend(
                _ev_row(e) for e in evs))
            rt.start()
            marks = []
            for sid, row, ts in sends:
                rt.get_input_handler(sid).send(row, timestamp=ts)
                marks.append(len(got))
            low = rt.lowering()
            rt.shutdown()
            return got, marks, low
        finally:
            mgr.shutdown()

    jgot, jmarks, jlow = run(False)
    tgot, tmarks, tlow = run(True)
    assert tlow == jlow == {"q": "device", "t": "device"}
    assert tmarks == jmarks and tmarks[2] == 1
    assert same_rows([r[2] for r in jgot], [r[2] for r in tgot], None)
    assert [r[:2] for r in jgot] == [r[:2] for r in tgot]


@pytest.mark.parametrize("query", [
    "from S[s == 'IBM'] select v insert into Out;",
    "from S#window.sort(5, v) select v insert into Out;",
    "from S[k + 1 == 123456789012] select v insert into Out;",
    "from S select k, distinctCount(v) as dc group by k insert into Out;",
    "from S[i == 2200000000] select v insert into Out;",
    "from S select maximum(v, 2.0) as m insert into Out;",
    "from S#window.length(3) select k, v insert expired events into Out;",
    "from S#window.lengthBatch(4) select k, v insert into Out;",
], ids=["string_filter", "sort_window", "long_arithmetic", "distinct_count",
        "long_constant", "host_function", "expired_output",
        "tumbling_passthrough"])
def test_host_fallback_as_the_reference(query, caplog):
    """Outside the device subset both packages plan the host chain: the
    same lowering, a WARNING naming the reason, and the same rows."""
    app = ("@app:playback @app:execution('tpu') " + SEED_DEFINE
           + "@info(name='q') " + query)
    rng = np.random.default_rng(5)
    sends = [("S", [int(rng.integers(0, 3)), float(rng.integers(1, 90)),
                    int(rng.integers(-5, 5)), float(np.float32(1.5)),
                    bool(rng.random() < 0.5), ["IBM", "MSFT"][i % 2]],
              1000 + 40 * i) for i in range(30)]
    sc = Scenario(app)
    sc.targets = {"Out": "stream"}
    sc.sends = [("send", sid, row, ts) for sid, row, ts in sends]
    mgr = JaxManager()
    try:
        rt = mgr.create_siddhi_app_runtime(app)
        got = sc.got.setdefault("Out", [])
        rt.add_callback("Out", lambda evs: got.extend(
            _ev_row(e) for e in evs))
        rt.start()
        for sid, row, ts in sends:
            rt.get_input_handler(sid).send(row, timestamp=ts)
        sc.lowering = rt.lowering()
        rt.shutdown()
    finally:
        mgr.shutdown()
    assert sc.lowering == {"q": "host"}
    with caplog.at_level("WARNING", logger="siddhi_tpu_torch"):
        tgot, tlow = replay(sc)
    assert tlow == {"q": "host"}
    assert any("device query path unavailable" in r.getMessage()
               for r in caplog.records)
    assert_same_output(sc.got, tgot, None)


@pytest.mark.parametrize("query", [
    "from S[v > 2.0] select k, sum(v) as s, max(v) as m group by k "
    "insert into Out;",
    "from S#window.length(4) select k, avg(v) as a, min(v) as lo "
    "group by k insert into Out;",
    "from S#window.lengthBatch(5) select k, sum(v) as s, count() as c "
    "group by k insert into Out;",
    "partition with (k of S) begin @info(name='p') from S#window.time("
    "300 ms) select k, sum(v) as s, count() as c insert into Out; end;",
], ids=["running", "sliding", "tumbling", "keyed_sliding"])
def test_deep_emit_and_ingest_queues_as_the_reference(query):
    """At ``emit.depth='4'`` and ``ingest.depth='2'`` the outputs of a
    batch stay on the device while later steps write the state in place:
    the rows equal the JAX run's at the same depths (an output aliasing
    state would show here)."""
    app = ("@app:playback @app:execution('tpu', partitions='64', "
           "emit.depth='4', ingest.depth='2') define stream S (k long, "
           "v double); @info(name='q') " + query)
    rng = np.random.default_rng(21)
    sc = Scenario(app)
    sc.targets = {"Out": "stream"}
    sc.sends = [("send", "S", [int(rng.integers(0, 4)),
                               float(rng.integers(1, 40)) + 0.5],
                 1000 + 45 * i) for i in range(70)]
    mgr = JaxManager()
    try:
        rt = mgr.create_siddhi_app_runtime(app)
        got = sc.got.setdefault("Out", [])
        rt.add_callback("Out", lambda evs: got.extend(
            _ev_row(e) for e in evs))
        rt.start()
        for _how, sid, row, ts in sc.sends:
            rt.get_input_handler(sid).send(row, timestamp=ts)
        sc.lowering = rt.lowering()
        rt.shutdown()
    finally:
        mgr.shutdown()
    assert set(sc.lowering.values()) == {"device"}
    tgot, tlow = replay(sc)
    assert tlow == sc.lowering
    assert_same_output(sc.got, tgot, bound(app))
    assert tgot["Out"]


def test_device_runtime_error_is_not_a_fallback():
    """Only the plan-time eligibility error sends a query to the host;
    an error while the query runs on the device propagates to the
    junction, which logs it and hands it to the listeners."""
    app = ("@app:playback @app:execution('tpu', partitions='2') "
           "define stream S (k long, v double); @info(name='q') from S "
           "select k, sum(v) as s group by k insert into Out;")
    mgr = SiddhiManager(device="cpu")
    try:
        rt = mgr.create_siddhi_app_runtime(app)
        assert rt.lowering() == {"q": "device"}
        errors, got = [], []
        rt.add_exception_listener(errors.append)
        rt.add_callback("Out", lambda evs: got.extend(evs))
        rt.start()
        h = rt.get_input_handler("S")
        for i in range(3):  # the third group exceeds n_groups = 2
            h.send([i, 1.0], timestamp=1000 + i)
        rt.shutdown()
    finally:
        mgr.shutdown()
    assert len(got) == 2
    assert [type(e).__name__ for e in errors] == ["SiddhiAppRuntimeError"]
    assert "group cardinality exceeded" in str(errors[0])


def test_no_card_and_no_cpu_device_raises():
    """Without a card and without ``device="cpu"`` the entry points
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    app = ("define stream S (k long, v double); @info(name='q') from "
           "S[v > 1.0] select k insert into O;")
    with pytest.raises(SiddhiAppCreationError):
        compile_query(app, "q")
    with pytest.raises(SiddhiAppCreationError):
        SiddhiManager()


# -- state across packages ---------------------------------------------------

SNAPSHOT_APPS = {
    "running": ("define stream S (k long, v double); @info(name='q') "
                "from S[v > 2.0] select k, sum(v) as s, count() as c, "
                "max(v) as m group by k insert into Out;"),
    "sliding": ("define stream S (k long, v double); @info(name='q') "
                "from S#window.time(500 ms) select k, avg(v) as a, min(v) "
                "as lo group by k insert into Out;"),
    "tumbling": ("define stream S (k long, v double); @info(name='q') "
                 "from S#window.lengthBatch(5) select k, sum(v) as s, "
                 "count() as c group by k insert into Out;"),
    "keyed_sliding": ("define stream S (k long, v double); partition with "
                      "(k of S) begin @info(name='q') from "
                      "S#window.length(3) select k, sum(v) as s, max(v) as "
                      "m insert into Out; end;"),
}


def _device_runtime(rt):
    qrs = dict(rt.query_runtimes)
    for p in rt.partitions.values():
        qrs.update(p.dense_query_runtimes)
    return qrs["q"].device_runtime


@pytest.mark.parametrize("kind", list(SNAPSHOT_APPS))
def test_jax_snapshot_restores_into_the_port(kind):
    """The JAX package's device runtime snapshot (``device_state`` and
    ``host``) taken mid-stream restores into the port's
    ``DeviceQueryRuntime``; the rest of the stream then gives the same
    rows in both."""
    app = ("@app:playback @app:execution('tpu', partitions='64') "
           + SNAPSHOT_APPS[kind])
    rng = np.random.default_rng(len(kind))
    sends = [[int(rng.integers(0, 4)), float(rng.integers(1, 40)) + 0.25]
             for _ in range(60)]

    def start(mgr):
        rt = mgr.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback("Out", lambda evs: got.extend(
            _ev_row(e) for e in evs))
        rt.start()
        return rt, got

    jmgr, tmgr = JaxManager(), SiddhiManager(device="cpu")
    try:
        jrt, jgot = start(jmgr)
        for i, row in enumerate(sends[:30]):
            jrt.get_input_handler("S").send(row, timestamp=1000 + 37 * i)
        tree = _device_runtime(jrt).snapshot()
        trt, tgot = start(tmgr)
        _device_runtime(trt).restore(tree)
        mark = len(jgot)
        for i, row in enumerate(sends[30:], start=30):
            for rt in (jrt, trt):
                rt.get_input_handler("S").send(row, timestamp=1000 + 37 * i)
        jrt.shutdown()
        trt.shutdown()
    finally:
        jmgr.shutdown()
        tmgr.shutdown()
    assert tgot and len(tgot) == len(jgot) - mark
    assert [r[:2] for r in tgot] == [r[:2] for r in jgot[mark:]]
    assert same_rows([r[2] for r in jgot[mark:]], [r[2] for r in tgot],
                     (1e-4, 1e-3))


# -- chip_smoke.py's device-query lowerings ----------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_lowerings_are_the_references():
    """Each app the card's ``device_queries`` phase runs, created in the
    JAX package: its lowering is the pinned constant the card gate
    checks the port against."""
    cs = _chip_smoke()
    assert len(cs.DEVICE_QUERY_APPS) >= 9
    for label, (app, pinned) in cs.DEVICE_QUERY_APPS.items():
        mgr = JaxManager()
        try:
            rt = mgr.create_siddhi_app_runtime(app)
            assert rt.lowering() == pinned, label
        finally:
            mgr.shutdown()
        tmgr = SiddhiManager(device="cpu")
        try:
            assert tmgr.create_siddhi_app_runtime(app).lowering() == pinned
        finally:
            tmgr.shutdown()
