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
  refuse; one outside the port's slices (device tables) must raise
  naming its ``ROADMAP.md`` item.  Apps under
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
import time
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
# corpus tests outside the port, keyed (corpus, class, method): none
# since tables came (the sandbox case's reads are held below by
# test_sandbox_table_reads_back_as_the_reference)
LEFT_OUT = set()
# what the port refuses in these corpora, with the ROADMAP.md item: none
# since device tables came
OUTSIDE = {}


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


class ManagerCall:
    """A call a corpus test made on the manager itself (validate,
    attributes, the runtime registry) and what it gave."""

    def __init__(self, name, args):
        self.name = name
        self.args = args
        self.outcome = None


def manager_outcome(fn, args):
    """``("raises",)``, or ``("returns", value)`` with runtimes by type."""
    try:
        out = fn(*args)
    except Exception:
        return ("raises",)
    return returned(out)


def returned(out):
    if isinstance(out, dict):
        out = {k: (v if isinstance(v, (dict, list, str, int, float))
                   else type(v).__name__) for k, v in out.items()}
    elif out is not None:
        out = type(out).__name__
    return ("returns", out)


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
            if cname.startswith("Test") and isinstance(cls, type):
                fns = [(cname, m) for m in sorted(vars(cls))
                       if m.startswith("test_")]
            elif cname.startswith("test_") and callable(cls):
                fns = [(None, cname)]
            else:
                continue
            for c, m in fns:
                if (corpus, c, m) in LEFT_OUT:
                    continue
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

        def __getattr__(self, name):
            fn = getattr(self._m, name)

            def call(*args):
                mc = ManagerCall(name, args)
                scenarios.append(mc)
                try:
                    out = fn(*args)
                except Exception:
                    mc.outcome = ("raises",)
                    raise
                mc.outcome = returned(out)
                return out

            return call

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


def replay_calls(calls):
    """The manager calls, in order, on one port manager."""
    mgr = SiddhiManager(device="cpu")
    try:
        return [manager_outcome(getattr(mgr, c.name), c.args)
                for c in calls]
    finally:
        mgr.shutdown()


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
    calls = [sc for sc in scenarios if isinstance(sc, ManagerCall)]
    if calls:
        assert replay_calls(calls) == [c.outcome for c in calls]
    for sc in scenarios:
        if isinstance(sc, ManagerCall):
            continue
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


DEVTABLES = "@app:devtables @app:execution('tpu') "


@pytest.mark.parametrize("app", [
    "@app:limits(breaker='3') " + DEFINE
    + "from S select sym insert into Out;",
    "@app:execution('tpu') @app:plan(auto='true') " + DEFINE
    + "from S select sym insert into Out;",
    "@app:statistics('true') " + DEFINE
    + "from S select sym insert into Out;",
    "@app:trace(sample='1') " + DEFINE + "from S select sym insert into Out;",
    "@app:faults(seed='1', step.shard='transient') " + DEFINE
    + "from S select sym insert into Out;",
    "@app:execution('tpu', devices='2') " + DEFINE
    + "from S select sym insert into Out;",
], ids=["limits", "plan", "statistics", "trace", "faults", "devices"])
def test_refusals_name_their_roadmap_item(app):
    """No hidden fallback.  The annotations the port once refused, naming
    the ``ROADMAP.md`` item that ports each, plan and run as the
    reference's, with the same rows: the operations layer's
    (``@app:limits``, ``@app:statistics``, ``@app:trace``), the cost
    model's own choice (``@app:plan``, item 15d), the ``step.shard``
    fault site and a mesh (item 16; a stateless query keeps one device,
    as in the reference)."""
    rows = []
    for make in (JaxManager, lambda: SiddhiManager(device="cpu")):
        rt = make().create_siddhi_app_runtime(app)
        got = []
        rt.add_callback("Out", lambda evs: got.extend(
            tuple(e.data) for e in evs))
        rt.start()
        rt.get_input_handler("S").send(["IBM", 2.5, 1.5, 7, 3, True],
                                       timestamp=1000)
        rt.shutdown()
        rows.append(got)
    assert rows[0] == rows[1] == [("IBM",)]


def test_later_slice_names_the_roadmap_item():
    """The wording a refusal of an unported item carries (no refusal
    uses it while every item of the port's order is done)."""
    from siddhi_tpu_torch.core.exceptions import later_slice

    assert later_slice(17, "analysis") == (
        " — ROADMAP.md §1 item 17 (analysis), a later slice of the port")


@pytest.mark.parametrize("app,publish", [
    ("@app:playback @source(type='inMemory', topic='q-in', "
     "@map(type='json')) " + DEFINE[len("@app:playback "):]
     + "from S select sym, p insert into Out;", True),
    (DEFINE + "@sink(type='inMemory', topic='q-out') define stream Out "
     "(sym string, p double); from S select sym, p insert into Out;",
     False),
    ("@app:execution('tpu') @app:multiplex " + DEFINE
     + "@info(name='q') from S#window.lengthBatch(3) select n, sum(p) as t "
     "group by n insert into Out;", False),
], ids=["source", "sink", "multiplex"])
def test_once_refused_transports_and_multiplex_run_as_the_reference(
        app, publish):
    """The three refusals items 14 and 15a lifted: a JSON-mapped
    ``@source`` fed through the in-memory broker, an ``@sink`` publishing
    to it and an ``@app:multiplex`` app give the same rows, broker
    messages and lowering in both packages."""
    import json

    import siddhi_tpu.transport.broker as jbroker
    import siddhi_tpu_torch.transport.broker as tbroker

    outs = {}
    for port, broker in ((False, jbroker), (True, tbroker)):
        mgr = SiddhiManager(device="cpu") if port else JaxManager()
        got, pub = [], []
        sub = broker.FunctionSubscriber(
            "q-out", lambda e: pub.append(tuple(e.data)))
        broker.InMemoryBroker.subscribe(sub)
        try:
            rt = mgr.create_siddhi_app_runtime(app)
            rt.add_callback("Out", stream_recorder(got))
            rt.start()
            if publish:
                for _sid, row, ts in sends(8, n=12):
                    broker.InMemoryBroker.publish("q-in", json.dumps(
                        dict(zip(("sym", "p", "q", "v", "n", "b"), row))))
            else:
                h = rt.get_input_handler("S")
                for _sid, row, ts in sends(8, n=12):
                    h.send(list(row), timestamp=ts)
            low = rt.lowering()
            rt.shutdown()
        finally:
            broker.InMemoryBroker.unsubscribe(sub)
            mgr.shutdown()
        outs[port] = (got if not publish else [r[1:] for r in got], pub,
                      low)
    assert outs[True] == outs[False]
    assert outs[True][0]


def test_persist_annotation_plans_and_checkpoints():
    """``@app:persist(interval='1 sec')`` plans as the reference's (mode
    'async', the interval in ms) and its daemon checkpoints a running
    app within a few seconds; the revision restores to the same rows in
    both packages."""
    from siddhi_tpu.util.persistence import (
        InMemoryPersistenceStore as JaxStore,
    )
    from siddhi_tpu_torch import InMemoryPersistenceStore

    app = ("@app:name('periodic') @app:persist(interval='1 sec') " + DEFINE
           + "@info(name='q') from S#window.length(3) select sym, "
           "sum(p) as t insert into Out;")
    rows = {}
    for port in (False, True):
        mgr = SiddhiManager(device="cpu") if port else JaxManager()
        store = InMemoryPersistenceStore() if port else JaxStore()
        mgr.set_persistence_store(store)
        try:
            rt = mgr.create_siddhi_app_runtime(app)
            ctx = rt.app_context
            assert (ctx.persist_mode, ctx.persist_interval_ms) == (
                "async", 1000)
            got = []
            rt.add_callback("Out", stream_recorder(got))
            rt.start()
            h = rt.get_input_handler("S")
            for _sid, row, ts in sends(3, n=6):
                h.send(list(row), timestamp=ts)
            deadline = time.monotonic() + 10
            while not store.revisions("periodic"):
                assert time.monotonic() < deadline, "no periodic persist"
                time.sleep(0.05)
            assert rt.wait_for_persist(timeout=10) == "idle"
            for _sid, row, ts in sends(4, n=4):
                h.send(list(row), timestamp=ts)
            assert rt.restore_last_revision() is not None
            for _sid, row, ts in sends(5, n=4):
                h.send(list(row), timestamp=ts)
            rt.shutdown()
            rows[port] = got
        finally:
            mgr.shutdown()
    assert rows[True] == rows[False] and rows[True]


@pytest.mark.parametrize("app", [
    DEFINE + "@info(name='q') from every a=S[p > 1.0] -> b=S[p > a.p] "
    "select a.p as ap, b.sym as bs insert into Out;",
    DEFINE + "from S select sym, p insert into #Inner; @info(name='q') "
    "from #Inner[p > 0.0] select sym, p insert into Out;",
    DEFINE + "partition with (sym of S) begin @info(name='q') from "
    "S#window.lengthBatch(2) select sym, sum(p) as p insert into Out; end;",
    DEFINE + "define function f[python] return int { data[0] + 1 }; "
    "from S[f(n) > 2] select sym, f(n) as fn insert into Out;",
    DEFINE + "define table T (sym string); from S[p > 10.0] select sym "
    "insert into T; from S join T on S.sym == T.sym select S.sym, S.p "
    "insert into Out;",
    DEFINE + "from S#window.length(2) as a join S#window.length(3) as b "
    "on a.sym == b.sym select a.sym, b.p insert into Out;",
    DEFINE + "partition with (sym of S) begin from S#window.length(2) as a "
    "join S#window.length(2) as b on a.p > 1.0 select a.sym, b.p insert "
    "into Out; end;",
], ids=["host_pattern", "inner_output", "partition", "function", "table",
        "join", "join_in_partition"])
def test_once_refused_apps_run_as_the_reference(app):
    """A pattern in the default mode, an ``#inner`` stream outside a
    partition (the reference keeps it as the app's own stream), a
    partition in the default mode, a script function, a stream-table
    join, a windowed join and a self join inside a partition, all
    refused until the host pattern engine, per-key instances, user
    functions, joins and tables came to the port, now give the
    reference's rows."""
    assert assert_same(app, sends(len(app)))["Out"]


@pytest.mark.parametrize("app", [
    DEVTABLES + DEFINE + "define table T (sym string); from S[p > 10.0] "
    "select sym insert into T; from S join T on S.sym == T.sym select "
    "S.sym, S.p insert into Out;",
    DEVTABLES + DEFINE + "from S#window.length(2) as a join "
    "S#window.length(3) as b on a.sym == b.sym select a.sym, b.p insert "
    "into Out;",
    DEVTABLES + DEFINE + "partition with (sym of S) begin from "
    "S#window.length(2) as a join S#window.length(2) as b on a.p > 1.0 "
    "select a.sym, b.p insert into Out; end;",
    DEVTABLES + DEFINE + "@PrimaryKey('n') define table T (n int, q float); "
    "from S[n > 0] select n, q insert into T; @info(name='j') from S join "
    "T on S.n == T.n select S.sym, T.q insert into Out;",
    "@app:execution('tpu') @app:fuse " + DEFINE + "@info(name='q1') from "
    "S[n > 0] select n, q insert into Mid; @info(name='q2') from Mid[q > "
    "0.5] select n, q insert into Out;",
], ids=["table", "join", "join_in_partition", "device_table", "fuse"])
def test_once_refused_device_apps_run_as_the_reference(app):
    """The shapes the port refused under ``@app:devtables`` (a table, a
    windowed join, a self join inside a partition) and ``@app:fuse``
    until device tables and fusion came, and a join on a device table:
    the reference's rows and lowerings."""
    jgot, jlow = run(False, app, sends(len(app)))
    tgot, tlow = run(True, app, sends(len(app)))
    assert tgot == jgot and tgot["Out"]
    assert tlow == jlow
    if "PrimaryKey" in app:
        assert tlow["j"] == "devtable"
    if "@app:fuse" in app:
        assert set(tlow.values()) == {"fused"}


def test_sandbox_table_reads_back_as_the_reference():
    """The sandbox strips the transports and the ``@store`` (the corpus's
    ``TestManagerApis.test_sandbox_strips_transports``): the table is an
    in-memory one and the pull reads back what was inserted, as in the
    reference."""
    app = ("@source(type='doesNotExist', topic='x', @map(type='passThrough')) "
           "define stream S (v long); "
           "@store(type='alsoMissing') define table T (v long); "
           "from S select v insert into T;")
    out = []
    for mgr in (JaxManager(), SiddhiManager(device="cpu")):
        try:
            rt = mgr.create_sandbox_siddhi_app_runtime(app)
            rt.start()
            for i, v in enumerate((7, 8)):
                rt.get_input_handler("S").send([v], 100 + i)
            out.append([ev_key(e) for e in rt.query("from T select v")])
            rt.shutdown()
        finally:
            mgr.shutdown()
    assert out[1] == out[0] and [e[2] for e in out[1]] == [(("int", 7),),
                                                           (("int", 8),)]
