"""The port's per-key partition instances held against the JAX package's.

- the partition corpora (``tests/test_partitions.py``,
  ``test_conformance_partitions.py``, ``test_conformance_partitions2.py``)
  replayed through both packages with ``test_torch_device_query.py``'s
  recorder: same events in order (timestamps, expiry flags, values and
  their types, floats bit for bit), same ``lowering()``, same fallback
  WARNINGs; a body that joins or writes a table runs on per-key
  instances as in the reference;
- seeded bodies in the default mode: inner streams both ways (a chain of
  two, a pattern reading one), range partitions, rate limits, order by
  and limit, windows and patterns per key;
- the idle purge: ``instances`` shrinks and the purged instances'
  scheduler hooks go with them;
- the wholesale fallback under ``@app:execution('tpu')``: a body with one
  query the device paths cannot take moves to per-key instances, with
  the reference's WARNING, its ``lowering()`` and its rows, and the
  lowered siblings' scheduler tasks unregistered;
- a JAX partition snapshot (per-key query states, pattern instances in
  their plain form) restored into the port mid-stream.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.ops.nfa import Instance as JaxInstance
from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.core.dense_pattern import DensePatternRuntime
from siddhi_tpu_torch.core.partition import PartitionInstance
from test_torch_device_query import (  # noqa: F401 (a fixture)
    FallbackLog,
    check_scenario,
    corpus_cases,
    one_torch_thread,
    record,
)
from test_torch_query import ev_key

CORPORA = ("test_partitions", "test_conformance_partitions",
           "test_conformance_partitions2")
CASES = corpus_cases(CORPORA, {})


def test_the_corpora_were_read():
    assert len(CASES) >= 28
    assert {c[0] for c in CASES} == set(CORPORA)


@pytest.mark.parametrize(
    "corpus,cname,mname,k", CASES,
    ids=[f"{c[0][5:]}:{c[1] or ''}.{c[2]}" + (f"-{c[3]}" if c[3] else "")
         for c in CASES])
def test_partition_corpus_as_the_reference(corpus, cname, mname, k):
    scenarios, _engines = record(corpus, cname, mname, k)
    assert scenarios, "the corpus test created no app"
    for sc in scenarios:
        check_scenario(sc)


# -- seeded bodies ---------------------------------------------------------------

DEFINE = "define stream S (sym string, v double, n long); "
SYMS = ("IBM", "WSO2", "ORCL", "MSFT", "GOOG")


def sends(seed, n=150, dt=(1, 120)):
    rng = np.random.default_rng(seed)
    out, t = [], 1000
    for _ in range(n):
        t += int(rng.integers(*dt))
        out.append(([SYMS[int(rng.integers(0, len(SYMS)))],
                     float(np.round(rng.uniform(0, 30), 1)),
                     int(rng.integers(-50, 50))], t))
    return out


def run(port, app, events, outs=("Out",)):
    """``(rows by stream, lowering, fallback WARNINGs, app runtime)``."""
    mgr = SiddhiManager(device="cpu") if port else JaxManager()
    try:
        with FallbackLog("siddhi_tpu_torch" if port else "siddhi_tpu") as log:
            rt = mgr.create_siddhi_app_runtime(app)
        got = {}
        for o in outs:
            g = got.setdefault(o, [])
            rt.add_callback(o, lambda evs, g=g: g.extend(ev_key(e)
                                                         for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        for row, ts in events:
            h.send(list(row), timestamp=ts)
        low = rt.lowering()
        rt.shutdown()
        return got, low, log.messages, rt
    finally:
        mgr.shutdown()


def both(app, events, **kw):
    jres = run(False, app, events, **kw)
    tres = run(True, app, events, **kw)
    assert tres[:3] == jres[:3]
    return tres


BODIES = {
    "inner_chain": (
        "from S[v > 5.0] select sym, v, n insert into #A; "
        "from #A#window.length(3) select sym, sum(v) as s insert into #B; "
        "from #B[s > 20.0] select sym, s insert into Out;"),
    "pattern_reads_inner": (
        "from S select sym, v * 2.0 as w insert into #W; "
        "from every a=#W[w > 30.0] -> b=#W[w > a.w] "
        "select a.sym as sym, a.w as aw, b.w as bw insert into Out;"),
    "rate_limit": (
        "from S select sym, sum(v) as s output last every 3 events "
        "insert into Out;"),
    "time_rate_limit": (
        "from S select sym, count() as c output all every 500 millisec "
        "insert into Out;"),
    "order_by_limit": (
        "from S#window.lengthBatch(4) select sym, n, v order by v desc "
        "limit 2 insert into Out;"),
    "time_window": (
        "from S#window.time(300 millisec) select sym, avg(v) as a "
        "insert all events into Out;"),
    "time_batch": (
        "from S#window.timeBatch(400 millisec) select sym, sum(n) as s, "
        "count() as c insert into Out;"),
    "count_pattern": (
        "from every a=S[v > 10.0] -> b=S[v > a.v]<2:3> within 2 sec "
        "select a.sym as sym, a.v as av, b[0].v as b0, b[last].v as bl "
        "insert into Out;"),
    "absent_pattern": (
        "from every a=S[v > 20.0] -> not S[v > a.v] for 300 millisec "
        "select a.sym as sym, a.v as av insert into Out;"),
    "two_queries_one_output": (
        "from S[v > 15.0] select sym, v insert into Out; "
        "from S[n > 0] select sym, v insert into Out;"),
}


@pytest.mark.parametrize("label", sorted(BODIES))
def test_seeded_body_as_the_reference(label):
    """Each body inside ``partition with (sym of S)`` in the default
    mode: per-key instances in both packages, the same rows in order."""
    app = ("@app:playback " + DEFINE + "partition with (sym of S) begin "
           + BODIES[label] + " end;")
    got, low, warns, rt = both(app, sends(len(label)))
    assert got["Out"] and set(low.values()) == {"host"} and not warns
    pr = rt.partitions["partition_0"]
    assert set(pr.instances) <= set(SYMS) and pr.instances
    assert all(isinstance(i, PartitionInstance)
               for i in pr.instances.values())


def test_range_partition_as_the_reference():
    """Range labels, first matching range wins, rows no range takes are
    dropped; a per-label window and pattern."""
    app = ("@app:playback " + DEFINE
           + "partition with (v < 5.0 as 'low' or v < 20.0 as 'mid' or "
           "n > 40 as 'big' of S) begin "
           "from S#window.length(2) select sym, sum(v) as s insert into Out; "
           "from every a=S[v > 1.0] -> b=S[v > a.v] select a.v as av, "
           "b.v as bv insert into Pat; end;")
    got, _low, _w, rt = both(app, sends(17), outs=("Out", "Pat"))
    assert got["Out"] and got["Pat"]
    assert set(rt.partitions["partition_0"].instances) == {"low", "mid",
                                                            "big"}


def test_idle_purge_drops_instances_and_their_hooks():
    """``@purge``: the instances of keys idle for ``idle.period`` go, with
    the windows and tasks they registered; a returning key starts
    afresh, as in the reference."""
    app = ("@app:playback " + DEFINE
           + "@purge(enable='true', interval='1 sec', idle.period='2 sec') "
           "partition with (sym of S) begin "
           "from S#window.time(500 millisec) select sym, count() as c "
           "insert into Out; "
           "from every a=S[v > 1.0] -> not S[v > a.v] for 100 millisec "
           "select a.sym as sym insert into Out; end;")
    events = [(["IBM", 3.0, 1], 1000), (["WSO2", 4.0, 1], 1100),
              (["ORCL", 5.0, 1], 1200), (["IBM", 6.0, 1], 4000),
              (["IBM", 7.0, 1], 8000), (["WSO2", 8.0, 1], 8100)]

    def go(port):
        mgr = SiddhiManager(device="cpu") if port else JaxManager()
        rt = mgr.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback("Out", lambda evs: got.extend(ev_key(e) for e in evs))
        rt.start()
        pr = rt.partitions["partition_0"]
        h = rt.get_input_handler("S")
        sizes = []
        for row, ts in events:
            h.send(row, timestamp=ts)
            sizes.append(sorted(pr.instances))
        hooks = (len(rt.app_context.scheduler._windows),
                 len(rt.app_context.scheduler._tasks))
        rt.shutdown()
        mgr.shutdown()
        return got, sizes, hooks

    jgot, jsizes, _ = go(False)
    tgot, tsizes, hooks = go(True)
    assert tgot == jgot and tsizes == jsizes
    assert tsizes[2] == ["IBM", "ORCL", "WSO2"] and tsizes[-1] == ["IBM",
                                                                   "WSO2"]
    # two live instances: a window and a pattern task each, and the
    # partition's purge task
    assert hooks == (2, 3)


FALLBACKS = {
    # a tumbling window beside a filter the device query path takes
    "tumbling_window": (
        "@info(name='f') from S[v > 5.0] select sym, v insert into Out; "
        "@info(name='w') from S#window.lengthBatch(3) select sym, "
        "sum(v) as s insert into Out;"),
    "rate_limit": (
        "@info(name='r') from S select sym, count() as c output last "
        "every 2 events insert into Out;"),
    "order_by": (
        "@info(name='o') from S#window.length(3) select sym, v order by v "
        "limit 1 insert into Out;"),
    "inner_stream": (
        "@info(name='a') from S select sym, v insert into #I; "
        "@info(name='b') from #I[v > 10.0] select sym, v insert into Out;"),
    # a dense pattern with deadlines lowers first, then the host-only
    # pattern shape fails: the first's timer task must be unregistered
    "host_only_pattern": (
        "@info(name='d') from every a=S[v > 20.0] -> not S[v > a.v] for "
        "200 millisec select a.v as av insert into Out; "
        "@info(name='h') from every a=S[v > 5.0] -> b=S[v > a.v]<0:2> -> "
        "c=S[v > 25.0] select a.v as av, c.v as cv insert into Out;"),
}


@pytest.mark.parametrize("label", sorted(FALLBACKS))
def test_tpu_body_falls_back_wholesale(label):
    """Under ``@app:execution('tpu')`` a body with a query the device
    paths cannot take runs on per-key instances, whole, with the
    reference's WARNING and ``lowering()``; no device runtime is left
    registered with the scheduler."""
    app = ("@app:playback @app:execution('tpu', partitions='64') " + DEFINE
           + "partition with (sym of S) begin " + FALLBACKS[label] + " end;")
    got, low, warns, rt = both(app, sends(len(label) + 3))
    assert got["Out"] and set(low.values()) == {"host"}
    assert len(warns) == 1 and warns[0].startswith(
        "partition_0: dense TPU path unavailable (")
    assert warns[0].endswith("); using per-key instances")
    pr = rt.partitions["partition_0"]
    assert not pr.is_dense and not pr.dense_query_runtimes
    assert not any(isinstance(t, DensePatternRuntime)
                   for t in rt.app_context.scheduler._tasks)


def test_tpu_body_that_lowers_stays_on_the_device():
    """The same partition with a body the device paths take: one device
    engine a query, no instances, no WARNING."""
    app = ("@app:playback @app:execution('tpu', partitions='64') " + DEFINE
           + "partition with (sym of S) begin @info(name='f') from "
           "S[v > 5.0] select sym, v insert into Out; @info(name='p') from "
           "every a=S[v > 10.0] -> b=S[v > a.v] select a.v as av, b.v as bv "
           "insert into Out; end;")
    got, low, warns, rt = both(app, sends(23))
    assert low == {"f": "device", "p": "dense"} and not warns
    assert rt.partitions["partition_0"].is_dense
    assert not rt.partitions["partition_0"].instances and got["Out"]


# -- a JAX partition snapshot restored into the port ---------------------------------


def plain(state):
    """A JAX partition snapshot with every pattern instance made a plain
    dict of its ``__slots__`` (deep-copied together)."""
    out = {}
    for key, qstates in state.items():
        out[key] = {}
        for qname, qs in qstates.items():
            qs = dict(qs)
            if "pattern" in qs:
                pat = qs["pattern"]
                qs["pattern"] = {
                    "instances": [{s: getattr(i, s)
                                   for s in JaxInstance.__slots__}
                                  for i in pat["instances"]],
                    "matched_once": pat["matched_once"]}
            out[key][qname] = qs
    return copy.deepcopy(out)


def test_jax_partition_snapshot_restores_into_the_port():
    """Per-key pattern and rate-limiter state from the JAX package, taken
    mid-stream, restores into the port's partition; the rest of the
    stream gives the JAX run's rows."""
    app = ("@app:playback " + DEFINE + "partition with (sym of S) begin "
           "@info(name='p') from every a=S[v > 8.0] -> b=S[v > a.v]<2:3> "
           "within 1 sec select a.sym as sym, a.v as av, b[last].v as bl "
           "insert into Out; "
           "@info(name='r') from S[v > 20.0] select sym, v output first "
           "every 3 events insert into Out; end;")
    events = sends(31, n=200)
    half = len(events) // 2

    jm = JaxManager()
    jrt = jm.create_siddhi_app_runtime(app)
    jgot = []
    jrt.add_callback("Out", lambda evs: jgot.extend(ev_key(e) for e in evs))
    jrt.start()
    h = jrt.get_input_handler("S")
    for row, ts in events[:half]:
        h.send(row, timestamp=ts)
    snap = plain(jrt.partitions["partition_0"].snapshot())
    assert any(qs["p"]["pattern"]["instances"] for qs in snap.values())
    n_before = len(jgot)
    for row, ts in events[half:]:
        h.send(row, timestamp=ts)
    jrt.shutdown()
    jm.shutdown()

    mgr = SiddhiManager(device="cpu")
    rt = mgr.create_siddhi_app_runtime(app)
    got = []
    rt.add_callback("Out", lambda evs: got.extend(ev_key(e) for e in evs))
    rt.start()
    rt.app_context.timestamp_generator.set_event_time(events[half - 1][1])
    pr = rt.partitions["partition_0"]
    pr.restore(snap)
    assert set(pr.instances) == set(snap)
    th = rt.get_input_handler("S")
    for row, ts in events[half:]:
        th.send(row, timestamp=ts)
    again = pr.snapshot()
    rt.shutdown()
    mgr.shutdown()
    assert got == jgot[n_before:] and got
    assert set(again) == set(pr.instances)
