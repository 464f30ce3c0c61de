"""The port's host query runtime held against the JAX package's.

Two kinds of case, each held to equal output events in order, with
timestamps, expiry flags and value types, floats bit for bit:

- the conformance corpora's apps (``tests/test_filter_queries.py``,
  ``test_windows.py`` and ``test_conformance_{filters,filters2,
  selectors,ratelimit,orderby,windows}.py``).  Each corpus test runs
  once against a private copy of its module whose ``SiddhiManager`` is
  the JAX package's wrapped in a recorder: every app it creates (under
  ``@app:playback``, so that time is the events' time in both runs),
  every callback target and every send is recorded with the callbacks'
  output.  The port's ``SiddhiManager(device="cpu")`` then replays the
  same app and sends.  An app the JAX package refuses, the port must
  refuse; one outside the port's slices (joins, tables, named windows)
  must raise naming its ``ROADMAP.md`` item.  Apps under
  ``@app:execution('tpu')`` run on the device query path (or, outside
  its subset, on the host runtime) in both packages; patterns and
  partitions run on the host pattern engine and per-key instances (or
  the dense and device paths) as in the reference.
- seeded apps over every aggregator, the selector's group by, having,
  order by, limit and offset, every rate limiter and query callbacks.
"""

from __future__ import annotations

import importlib.util
import inspect
import itertools
import re
from pathlib import Path

import numpy as np
import pytest

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.core.event import Event as JaxEvent
from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.core.event import Event
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.core.stream import QueryCallback, StreamCallback

TESTS = Path(__file__).resolve().parent
CORPORA = ("test_filter_queries", "test_windows", "test_conformance_filters",
           "test_conformance_filters2", "test_conformance_selectors",
           "test_conformance_ratelimit", "test_conformance_orderby",
           "test_conformance_windows")
# corpus classes outside the query runtime: the manager's validate,
# sandbox and attribute APIs, which the port does not have
LEFT_OUT = {("test_filter_queries", "TestManagerApis")}
# what the port refuses in these corpora, with the ROADMAP.md item
OUTSIDE = {8: r"\bjoin\b", 9: r"define (table|window|trigger)"}


def typed(v):
    """A value with its type; floats by their bits."""
    if isinstance(v, float):
        return ("float", v.hex())
    if isinstance(v, (set, frozenset)):
        return ("set", tuple(sorted(map(repr, v))))
    return (type(v).__name__, v)


def ev_key(e):
    return (e.timestamp, e.is_expired, tuple(typed(v) for v in e.data))


def stream_recorder(got):
    return lambda evs: got.extend(ev_key(e) for e in evs)


def query_recorder(got):
    return lambda ts, i, o: got.append(
        (ts, [ev_key(e) for e in i or []], [ev_key(e) for e in o or []]))


# -- recording the corpora ---------------------------------------------------


class Scenario:
    """One app a corpus test created: the app, its callback targets
    (``'stream'`` or ``'query'``), its sends and the JAX run's output."""

    def __init__(self, app):
        self.app = app
        self.targets = {}
        self.sends = []
        self.got = {}
        self.error = None
        self.unsupported = None


class _Handler:
    def __init__(self, h, sid, sc):
        self._h, self._sid, self._sc = h, sid, sc

    def send(self, data, timestamp=None):
        self._sc.sends.append((self._sid, data, timestamp))
        return self._h.send(data, timestamp)

    def __getattr__(self, name):
        self._sc.unsupported = name
        return getattr(self._h, name)


class _Runtime:
    def __init__(self, rt, sc):
        self._rt, self._sc = rt, sc

    def add_callback(self, target, cb):
        kind = "stream" if target in self._rt.junctions else "query"
        self._sc.targets[target] = kind
        got = self._sc.got.setdefault(target, [])
        self._rt.add_callback(target, cb)
        self._rt.add_callback(target, stream_recorder(got) if kind == "stream"
                              else query_recorder(got))

    def get_input_handler(self, sid):
        return _Handler(self._rt.get_input_handler(sid), sid, self._sc)

    def start(self):
        self._rt.start()

    def shutdown(self):
        self._rt.shutdown()

    def __getattr__(self, name):
        self._sc.unsupported = name
        return getattr(self._rt, name)


def _load(corpus, tag):
    spec = importlib.util.spec_from_file_location(
        f"_{corpus}_{tag}", TESTS / f"{corpus}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _param_sets(fn):
    """The argument dicts of a (possibly parametrized) corpus test."""
    sets = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names = [n.strip() for n in (mark.args[0].split(",")
                                     if isinstance(mark.args[0], str)
                                     else mark.args[0])]
        rows = []
        for v in mark.args[1]:
            v = getattr(v, "values", v)
            rows.append(dict(zip(names, v if len(names) > 1 else (v,))))
        sets = [{**a, **b} for a, b in itertools.product(sets, rows)]
    return sets


def corpus_cases():
    out = []
    for corpus in CORPORA:
        mod = _load(corpus, "names")
        for cname in sorted(vars(mod)):
            cls = getattr(mod, cname)
            if (corpus, cname) in LEFT_OUT:
                continue
            if cname.startswith("Test") and isinstance(cls, type):
                fns = [(cname, m) for m in sorted(vars(cls))
                       if m.startswith("test_")]
            elif cname.startswith("test_") and callable(cls):
                fns = [(None, cname)]
            else:
                continue
            for c, m in fns:
                fn = getattr(getattr(mod, c), m) if c else getattr(mod, m)
                for k in range(len(_param_sets(fn))):
                    out.append((corpus, c, m, k))
    return out


def record(corpus, cname, mname, k):
    """Run one corpus test against the recording manager."""
    mod = _load(corpus, "rec")
    scenarios = []

    class RecordingManager:
        def __init__(self, *a, **kw):
            self._m = JaxManager(*a, **kw)

        def create_siddhi_app_runtime(self, app):
            if "@app:playback" not in app:
                app = "@app:playback " + app
            sc = Scenario(app)
            scenarios.append(sc)
            try:
                return _Runtime(self._m.create_siddhi_app_runtime(app), sc)
            except Exception as e:
                sc.error = e
                raise

        def shutdown(self):
            self._m.shutdown()

    mod.SiddhiManager = RecordingManager
    owner = getattr(mod, cname)() if cname else mod
    fn = getattr(owner, mname)
    kwargs = _param_sets(fn)[k]
    manager = None
    if "manager" in inspect.signature(fn).parameters:
        manager = kwargs["manager"] = RecordingManager()
    try:
        fn(**kwargs)
    except Exception:
        # the corpus asserts its own expectations; under playback time
        # some no longer hold, and the comparison below is with the
        # JAX run either way
        pass
    finally:
        if manager is not None:
            manager.shutdown()
    return scenarios


def _port_data(data):
    if isinstance(data, JaxEvent):
        return Event(data.timestamp, list(data.data), data.is_expired)
    if isinstance(data, list) and data and isinstance(data[0], JaxEvent):
        return [_port_data(e) for e in data]
    return data


def replay(sc):
    """The scenario through the port; returns its output."""
    mgr = SiddhiManager(device="cpu")
    try:
        rt = mgr.create_siddhi_app_runtime(sc.app)
        got = {}
        for target, kind in sc.targets.items():
            g = got.setdefault(target, [])
            rt.add_callback(target, stream_recorder(g) if kind == "stream"
                            else query_recorder(g))
        rt.start()
        for sid, data, ts in sc.sends:
            rt.get_input_handler(sid).send(_port_data(data), ts)
        rt.shutdown()
        return got
    finally:
        mgr.shutdown()


CASES = corpus_cases()


def test_the_corpora_were_read():
    assert len(CASES) >= 180
    assert {c[0] for c in CASES} == set(CORPORA)


@pytest.mark.parametrize(
    "corpus,cname,mname,k", CASES,
    ids=[f"{c[0][5:]}:{c[1] or ''}.{c[2]}" + (f"-{c[3]}" if c[3] else "")
         for c in CASES])
def test_corpus_app_as_the_reference(corpus, cname, mname, k):
    scenarios = record(corpus, cname, mname, k)
    assert scenarios, "the corpus test created no app"
    for sc in scenarios:
        assert sc.unsupported is None, sc.unsupported
        if sc.error is not None:
            # an app the JAX package refuses at creation
            with pytest.raises(Exception):
                replay(sc)
            continue
        outside = [item for item, pat in OUTSIDE.items()
                   if re.search(pat, sc.app)]
        if outside:
            with pytest.raises(SiddhiAppCreationError) as info:
                replay(sc)
            assert any(f"ROADMAP.md §1 item {i}" in str(info.value)
                       for i in outside), str(info.value)
            continue
        assert replay(sc) == sc.got


# -- seeded cases ------------------------------------------------------------

DEFINE = ("@app:playback define stream S (sym string, p double, q float, "
          "v long, n int, b bool); ")
SYMS = ("IBM", "WSO2", "ORCL", "MSFT")


def sends(seed, n=60, nulls=False):
    """Seeded events on ``S``, 1-300 ms apart."""
    rng = np.random.default_rng(seed)
    out, t = [], 1000
    for _ in range(n):
        t += int(rng.integers(1, 300))
        out.append(("S", [SYMS[int(rng.integers(0, len(SYMS)))],
                          float(np.round(rng.uniform(-50, 150), 3)),
                          float(np.float32(rng.uniform(0, 10))),
                          int(rng.integers(-1000, 1000)),
                          int(rng.integers(0, 5)),
                          bool(rng.random() < 0.5)], t))
    return out


def run(port, app, events, streams=("Out",), queries=()):
    mgr = SiddhiManager(device="cpu") if port else JaxManager()
    try:
        rt = mgr.create_siddhi_app_runtime(app)
        got = {}
        for s in streams:
            rt.add_callback(s, stream_recorder(got.setdefault(s, [])))
        for q in queries:
            rt.add_callback(q, query_recorder(got.setdefault(q, [])))
        rt.start()
        for sid, row, ts in events:
            rt.get_input_handler(sid).send(list(row), timestamp=ts)
        low = rt.lowering()
        rt.shutdown()
        return got, low
    finally:
        mgr.shutdown()


def assert_same(app, events, **kw):
    jgot, jlow = run(False, app, events, **kw)
    tgot, tlow = run(True, app, events, **kw)
    assert tgot == jgot
    assert set(tlow.values()) == {"host"} and set(tlow) == set(jlow)
    return tgot


AGGREGATORS = {
    "sum_double": "sum(p)", "sum_long": "sum(v)", "sum_int": "sum(n)",
    "sum_float": "sum(q)", "count": "count()", "avg": "avg(p)",
    "stdDev": "stdDev(q)", "min_double": "min(p)", "max_long": "max(v)",
    "min_int": "min(n)", "minForever": "minForever(p)",
    "maxForever": "maxForever(v)", "distinctCount": "distinctCount(sym)",
    "and": "and(b)", "or": "or(b)", "unionSet": "unionSet(n)",
}


@pytest.mark.parametrize("agg", list(AGGREGATORS.values()),
                         ids=list(AGGREGATORS))
@pytest.mark.parametrize("window", ["#window.length(4)",
                                    "#window.lengthBatch(5)", ""])
def test_aggregator_as_the_reference(agg, window):
    """Every aggregator, with expired events (a sliding window), reset
    markers (a batch window) and without a window, grouped by symbol."""
    app = (DEFINE + f"@info(name='q') from S{window} select sym, {agg} as a "
           "group by sym insert all events into Out;")
    got = assert_same(app, sends(len(agg) + len(window)), queries=("q",))
    assert got["Out"]


@pytest.mark.parametrize("clause", [
    "group by sym having a > 20.0",
    "group by sym order by a desc",
    "group by sym order by sym, a limit 2",
    "group by sym order by a offset 1",
    "group by sym, n order by n desc, sym limit 3 offset 1",
    "having a < 200.0 order by a",
], ids=["having", "order_desc", "order_limit", "offset", "two_keys",
        "ungrouped"])
def test_selector_clauses_as_the_reference(clause):
    app = (DEFINE + "@info(name='q') from S#window.lengthBatch(6) "
           f"select sym, n, sum(p) as a, count() as c {clause} "
           "insert into Out;")
    assert assert_same(app, sends(len(clause)))["Out"]


@pytest.mark.parametrize("rate", [
    "output every 3 events", "output first every 3 events",
    "output last every 4 events", "output all every 2 sec",
    "output first every 1 sec", "output last every 1500 millisec",
    "output snapshot every 1 sec",
])
@pytest.mark.parametrize("grouped", [False, True],
                         ids=["ungrouped", "grouped"])
def test_rate_limiter_as_the_reference(rate, grouped):
    """Every rate limiter (event and time, all/first/last, snapshot),
    on a grouped query (the per-group first/last limiters) and not;
    the time ones fired by the scheduler under event time."""
    group = " group by sym" if grouped else ""
    app = (DEFINE + f"@info(name='q') from S select sym, sum(p) as a{group} "
           f"{rate} insert into Out;")
    assert assert_same(app, sends(len(rate) + grouped, n=80))["Out"]


def test_query_callbacks_as_the_reference():
    """A query callback (function and ``QueryCallback``) beside a stream
    callback, over current and expired events, and on a ``return``
    query with no output stream."""
    app = (DEFINE + "@info(name='q') from S#window.length(3) "
           "select sym, p insert all events into Out; "
           "@info(name='r') from S[n > 2] select sym, n * 2 as m return;")
    events = sends(5)
    jgot, _ = run(False, app, events, queries=("q", "r"))

    class Collect(QueryCallback):
        def __init__(self):
            self.got = []

        def receive(self, ts, in_events, out_events):
            query_recorder(self.got)(ts, in_events, out_events)

    class Rows(StreamCallback):
        def __init__(self):
            self.got = []

        def receive(self, events):
            self.got.extend(ev_key(e) for e in events)

    mgr = SiddhiManager(device="cpu")
    rt = mgr.create_siddhi_app_runtime(app)
    qcb, scb, fn_got = Collect(), Rows(), []
    rt.add_callback("q", qcb)
    rt.add_callback("r", query_recorder(fn_got))
    rt.add_callback("Out", scb)
    rt.start()
    for sid, row, ts in events:
        rt.get_input_handler(sid).send(row, timestamp=ts)
    rt.shutdown()
    mgr.shutdown()
    assert qcb.got == jgot["q"] and fn_got == jgot["r"]
    assert scb.got == jgot["Out"]
    assert any(o for _ts, _i, o in qcb.got) and fn_got


def test_verify_skill_filter_query():
    """The verify skill's first query: one IBM event."""
    app = ("define stream S (symbol string, price float, volume long); "
           "@info(name='q1') from S[volume < 150] select symbol, price "
           "insert into Out;")
    events = [("S", ["IBM", 700.0, 100], 1000), ("S", ["WSO2", 60.5, 200],
                                                   1001)]
    got = assert_same(app, events)
    assert [d for _t, _e, d in got["Out"]] == [
        (("str", "IBM"), ("float", (700.0).hex()))]


@pytest.mark.parametrize("query", [
    "from S#pol2Cart(p, q) select sym, x, y insert into Out;",
    "from S#pol2Cart(p, q, n) select * insert into Out;",
    "from S#log('seen') [n > 1] select sym, n % 3 as m, v / 7 as d "
    "insert into Out;",
    "from S[sym == 'IBM' or v > 500] select sym, p / n as r, "
    "ifThenElse(b, v, -v) as w insert into Out;",
    "from S[S.n >= 2]#window.length(2) select S.sym, "
    "convert(S.q, 'int') as c insert into Out;",
], ids=["pol2cart", "pol2cart_z_star", "log_then_filter", "functions",
        "qualified"])
def test_stream_functions_and_expressions_as_the_reference(query):
    """The built-in stream functions and the expression compiler: Java
    integer division and remainder, null-safe arithmetic, functions."""
    assert assert_same(DEFINE + query, sends(len(query)))["Out"]


def test_chained_queries_as_the_reference():
    """A query reading another query's output stream."""
    app = (DEFINE + "from S[p > 0] select sym, p insert into Mid; "
           "from Mid#window.lengthBatch(4) select sym, avg(p) as a "
           "group by sym insert into Out;")
    assert assert_same(app, sends(11), streams=("Mid", "Out"))["Out"]


def test_tpu_single_stream_as_the_reference():
    """A single-stream query under ``@app:execution('tpu')`` runs on the
    device query path in both packages (float32 DOUBLE lanes): the same
    lowering and the same rows, bit for bit (a filter and passthrough
    columns)."""
    app = ("@app:execution('tpu') " + DEFINE
           + "@info(name='q') from S[p > 1.0] select sym, p, n * 2 as m "
           "insert into Out;")
    jgot, jlow = run(False, app, sends(6))
    tgot, tlow = run(True, app, sends(6))
    assert tlow == jlow == {"q": "device"}
    assert tgot == jgot and tgot["Out"]


@pytest.mark.parametrize("app,item", [
    (DEFINE + "define table T (sym string); from S join T on S.sym == T.sym "
     "select S.sym insert into Out;", 9),
    (DEFINE + "define stream U (sym string); from S#window.length(2) join "
     "U#window.length(2) on S.sym == U.sym select S.sym insert into Out;", 8),
    (DEFINE + "define function f[python] return int { return 1 }; "
     "from S select sym insert into Out;", 10),
    (DEFINE + "partition with (sym of S) begin from S#window.length(2) join "
     "S#window.length(2) on S.p > 1.0 select S.sym insert into Out; end;",
     8),
], ids=["table", "join", "function", "join_in_partition"])
def test_refusals_name_their_roadmap_item(app, item):
    """No hidden fallback: what the port does not run raises at creation,
    naming the ``ROADMAP.md`` item that ports it."""
    with pytest.raises(SiddhiAppCreationError) as info:
        SiddhiManager(device="cpu").create_siddhi_app_runtime(app)
    assert f"ROADMAP.md §1 item {item}" in str(info.value)


@pytest.mark.parametrize("app", [
    DEFINE + "@info(name='q') from every a=S[p > 1.0] -> b=S[p > a.p] "
    "select a.p as ap, b.sym as bs insert into Out;",
    DEFINE + "from S select sym, p insert into #Inner; @info(name='q') "
    "from #Inner[p > 0.0] select sym, p insert into Out;",
    DEFINE + "partition with (sym of S) begin @info(name='q') from "
    "S#window.lengthBatch(2) select sym, sum(p) as p insert into Out; end;",
], ids=["host_pattern", "inner_output", "partition"])
def test_once_refused_apps_run_as_the_reference(app):
    """A pattern in the default mode, an ``#inner`` stream outside a
    partition (the reference keeps it as the app's own stream) and a
    partition in the default mode, all refused until the host pattern
    engine and per-key instances came to the port, now give the
    reference's rows."""
    assert assert_same(app, sends(len(app)))["Out"]
