"""The port's host pattern engine held against the JAX package's.

Four kinds of case:

- the pattern and sequence corpora (``tests/test_patterns.py``,
  ``test_conformance_patterns2.py``, ``test_conformance_sequences.py``,
  ``test_conformance_sequences2.py``, ``test_conformance_absent.py``,
  ``test_conformance_absent_logical.py``,
  ``test_conformance_absent_sequences.py``) replayed through both
  packages with ``test_torch_device_query.py``'s recorder: every app a
  corpus test creates (under ``@app:playback``, in the default mode and,
  where the corpus also runs it so, under ``@app:execution('tpu')``),
  its callbacks and sends.  The port's ``SiddhiManager(device="cpu")``
  must give the same events (timestamps, expiry flags, values and their
  types, floats bit for bit) in the same order, the same ``lowering()``
  and the same fallback WARNINGs;
- the shapes of ``tests/test_dense_differential_fuzz.py`` in the default
  mode over seeded streams;
- the float-width and null cases where the two engines of the reference
  part ways or where a null decides a match;
- a JAX ``PatternProcessor`` snapshot, taken mid-stream and made plain,
  restored into the port, which then gives the JAX package's rows for
  the rest of the stream.
"""

from __future__ import annotations

import copy
import logging

import numpy as np
import pytest

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.ops.nfa import Instance as JaxInstance
from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.ops.nfa import Instance, PatternProcessor
from test_dense_differential_fuzz import SHAPES, gen_stream
from test_torch_device_query import (  # noqa: F401 (a fixture)
    FallbackLog,
    check_scenario,
    corpus_cases,
    one_torch_thread,
    record,
)
from test_torch_query import ev_key

CORPORA = ("test_patterns", "test_conformance_patterns2",
           "test_conformance_sequences", "test_conformance_sequences2",
           "test_conformance_absent", "test_conformance_absent_logical",
           "test_conformance_absent_sequences")
CASES = corpus_cases(CORPORA, {})


def test_the_corpora_were_read():
    assert len(CASES) >= 160
    assert {c[0] for c in CASES} == set(CORPORA)


@pytest.mark.parametrize(
    "corpus,cname,mname,k", CASES,
    ids=[f"{c[0][5:]}:{c[1] or ''}.{c[2]}" + (f"-{c[3]}" if c[3] else "")
         for c in CASES])
def test_pattern_corpus_as_the_reference(corpus, cname, mname, k):
    scenarios, _engines = record(corpus, cname, mname, k)
    assert scenarios, "the corpus test created no app"
    for sc in scenarios:
        check_scenario(sc)


# -- seeded apps -----------------------------------------------------------------

DEFINE = "define stream S (k long, u double, v double); "


def run(port, app, sends, out="Alerts", stream="S"):
    """``app`` through one package: ``(rows, lowering, fallbacks)``, each
    row ``ev_key``'s (timestamp, expired, typed values)."""
    mgr = SiddhiManager(device="cpu") if port else JaxManager()
    try:
        with FallbackLog("siddhi_tpu_torch" if port else "siddhi_tpu") as log:
            rt = mgr.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback(out, lambda evs: got.extend(ev_key(e) for e in evs))
        rt.start()
        for row, ts in sends:
            rt.get_input_handler(stream).send(list(row), timestamp=ts)
        low = rt.lowering()
        rt.shutdown()
        return got, low, log.messages
    finally:
        mgr.shutdown()


def both(app, sends, **kw):
    jres = run(False, app, sends, **kw)
    tres = run(True, app, sends, **kw)
    assert tres == jres
    return tres


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_seeded_shape_as_the_reference(shape, seed):
    """Each dense fuzz shape in the default mode: the host engine of
    both packages over a seeded stream (three keys, one-decimal values,
    1-400 ms apart)."""
    app = "@app:playback " + DEFINE + SHAPES[shape]
    rows, low, _ = both(app, gen_stream(seed, n=80))
    assert set(low.values()) == {"host"}
    if shape not in ("non_every", "bounded_count"):
        assert rows


def test_float_width_parts_the_two_engines():
    """``v == 8.1`` on a FLOAT column: the host engine compares the
    widened float32 value with the DOUBLE constant in float64 (no
    match), the dense step compares in float32 (a match).  One app,
    both lowerings, each giving the JAX package's own answer."""
    body = ("define stream S (k long, v float); @info(name='q') "
            "from every a=S[v == 8.1] -> b=S[v > a.v] "
            "select a.v as av, b.v as bv insert into Alerts;")
    sends = [([1, 8.1], 1000), ([1, 9.5], 1010), ([1, 8.1], 1020),
             ([1, 12.0], 1030)]
    host, hlow, _ = both("@app:playback " + body, sends)
    dense, dlow, _ = both("@app:playback @app:execution('tpu') " + body,
                          sends)
    assert hlow == {"q": "host"} and dlow == {"q": "dense"}
    assert host == [] and len(dense) == 2


NULL_APPS = {
    # an `or` side that never matched: its capture is null (None in an
    # object column), and a later filter over it is False
    "or_side_null": (
        "define stream S (sym string, v double); "
        "define stream T (sym string, v double); @info(name='q') "
        "from every (a=S[v > 15.0] or b=T[v > 15.0]) -> c=S[v > a.v] "
        "select a.v as av, b.v as bv, c.v as cv insert into Alerts;"),
    # a string comparison against a null capture raises TypeError in
    # Python: the filter is False
    "string_order_null": (
        "define stream S (sym string, v double); "
        "define stream T (sym string, v double); @info(name='q') "
        "from every (a=S[v > 15.0] or b=T[v > 15.0]) -> c=S[sym > a.sym] "
        "select a.sym as asym, b.sym as bsym, c.sym as csym "
        "insert into Alerts;"),
    # `e2[1] is null`: the presence of a count's second capture, in a
    # filter and in the select
    "presence": (
        "define stream S (sym string, v double); "
        "define stream T (sym string, v double); @info(name='q') "
        "from every a=S[v > 10.0] -> b=S[v > a.v]<1:2> -> "
        "c=T[b[1] is null] select a.v as av, b[0].v as b0, b[1].v as b1, "
        "c.v as cv insert into Alerts;"),
    # is null over a captured attribute, and functions in a filter
    "is_null_and_functions": (
        "define stream S (sym string, v double); "
        "define stream T (sym string, v double); @info(name='q') "
        "from every a=S[v > 10.0] -> b=T[not (sym is null) and "
        "convert(v, 'long') > cast(a.v, 'long')] "
        "select a.sym as asym, b.sym as bsym, b.v as bv insert into Alerts;"),
}


def null_sends(seed, n=120):
    """Seeded events on two streams, some with a null symbol."""
    rng = np.random.default_rng(seed)
    out, t = [], 1000
    for _ in range(n):
        t += int(rng.integers(1, 50))
        sym = [None, "IBM", "WSO2", "ORCL"][int(rng.integers(0, 4))]
        out.append(("ST"[int(rng.integers(0, 2))],
                    [sym, float(np.round(rng.uniform(0, 30), 1))], t))
    return out


@pytest.mark.parametrize("label", sorted(NULL_APPS))
def test_nulls_as_the_reference(label):
    """Null captures (NaN for numerics, None for objects, the column
    falling back to object dtype), a comparison that raises on a null,
    and presence keys, in the default mode and under
    ``execution('tpu')``, where both packages fall back to the host
    engine with the same WARNING."""
    sends = null_sends(len(label))

    def go(port, prefix):
        mgr = SiddhiManager(device="cpu") if port else JaxManager()
        try:
            with FallbackLog("siddhi_tpu_torch" if port
                             else "siddhi_tpu") as log:
                rt = mgr.create_siddhi_app_runtime(prefix + NULL_APPS[label])
            got = []
            rt.add_callback("Alerts", lambda evs: got.extend(
                ev_key(e) for e in evs))
            rt.start()
            for sid, row, ts in sends:
                rt.get_input_handler(sid).send(row, timestamp=ts)
            low = rt.lowering()
            rt.shutdown()
            return got, low, log.messages
        finally:
            mgr.shutdown()

    host = go(False, "@app:playback ")
    assert go(True, "@app:playback ") == host and host[0]
    if label != "presence":
        # a null capture reaches the output as None
        assert any(v == ("NoneType", None) for r in host[0] for v in r[2])
    tpu = go(False, "@app:playback @app:execution('tpu') ")
    assert go(True, "@app:playback @app:execution('tpu') ") == tpu
    if label != "or_side_null":
        # outside the dense subset: the host engine, with one WARNING
        assert tpu[1] == {"q": "host"} and len(tpu[2]) == 1


# -- a JAX snapshot restored into the port ------------------------------------------

SNAP_APPS = {
    "count_dual_pending": (
        "define stream S (k long, u double, v double); @info(name='q') "
        "from every a=S[v > 8.0] -> b=S[v > a.v]<2:4> -> c=S[v < 5.0] "
        "within 3 sec select a.v as av, b[0].v as b0, b[last].v as bl, "
        "c.v as cv insert into Alerts;"),
    "sequence": (
        "define stream S (k long, u double, v double); @info(name='q') "
        "from every a=S[v > 10.0], b=S[v > a.v], c=S[v > b.v] "
        "select a.v as av, c.v as cv insert into Alerts;"),
    "absent": (
        "define stream S (k long, u double, v double); @info(name='q') "
        "from every a=S[v > 12.0] -> not S[v > a.v] for 500 millisec "
        "select a.v as av insert into Alerts;"),
}


def plain(state):
    """A JAX query state with its pattern instances made plain dicts of
    their ``__slots__`` (deep-copied together, so shared capture lists
    stay shared)."""
    state = dict(state)
    pat = state["pattern"]
    state["pattern"] = copy.deepcopy({
        "instances": [{s: getattr(i, s) for s in JaxInstance.__slots__}
                      for i in pat["instances"]],
        "matched_once": pat["matched_once"]})
    return state


@pytest.mark.parametrize("label", sorted(SNAP_APPS))
def test_jax_snapshot_restores_into_the_port(label):
    """The JAX host engine runs the first half of a seeded stream; its
    query state (selector, limiter, pattern instances in their plain
    form) restores into a fresh port runtime, and the second half gives
    the JAX run's rows, in order."""
    assert Instance.__slots__ == JaxInstance.__slots__
    app = "@app:playback " + SNAP_APPS[label]
    # seeds whose second half holds matches
    sends = gen_stream({"sequence": 9}.get(label, 7), n=120)
    half = len(sends) // 2

    jm = JaxManager()
    jrt = jm.create_siddhi_app_runtime(app)
    jgot = []
    jrt.add_callback("Alerts", lambda evs: jgot.extend(ev_key(e) for e in evs))
    jrt.start()
    h = jrt.get_input_handler("S")
    for row, ts in sends[:half]:
        h.send(row, timestamp=ts)
    snap = plain(jrt.query_runtimes["q"].snapshot_state())
    assert snap["pattern"]["instances"]
    n_before = len(jgot)
    for row, ts in sends[half:]:
        h.send(row, timestamp=ts)
    jrt.shutdown()
    jm.shutdown()

    mgr = SiddhiManager(device="cpu")
    rt = mgr.create_siddhi_app_runtime(app)
    got = []
    rt.add_callback("Alerts", lambda evs: got.extend(ev_key(e) for e in evs))
    rt.start()
    # the clock at the snapshot (playback: the last event's time)
    rt.app_context.timestamp_generator.set_event_time(sends[half - 1][1])
    qr = rt.query_runtimes["q"]
    assert isinstance(qr.pattern_processor, PatternProcessor)
    qr.restore_state(snap)
    assert all(isinstance(i, Instance)
               for i in qr.pattern_processor.instances)
    th = rt.get_input_handler("S")
    for row, ts in sends[half:]:
        th.send(row, timestamp=ts)
    rt.shutdown()
    mgr.shutdown()
    assert got == jgot[n_before:] and got


def test_host_pattern_allocates_no_tensor(monkeypatch):
    """A host pattern app makes no torch tensor at all: the engine runs
    on Python objects, its filters on numpy scalars."""
    import torch

    made = []
    for name in ("empty", "zeros", "full", "tensor", "as_tensor",
                 "from_numpy", "arange"):
        def spy(*a, _real=getattr(torch, name), _name=name, **kw):
            made.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(torch, name, spy)
    app = "@app:playback " + DEFINE + SHAPES["every_triple"]
    rows, low, _ = run(True, app, gen_stream(5, n=60))
    assert rows and low == {"q": "host"} and not made


def test_fallback_warning_names_the_reason(caplog):
    """Under ``execution('tpu')`` a pattern the dense path cannot take
    runs on the host engine with the reference's WARNING."""
    app = ("@app:playback @app:execution('tpu') "
           "define stream S (sym string, v double); @info(name='q') "
           "from every a=S[v > 1.0] -> b=S[v > a.v] "
           "select a.sym as s, b.v as bv insert into Alerts;")
    with caplog.at_level(logging.WARNING, logger="siddhi_tpu_torch"):
        rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(app)
    assert rt.lowering() == {"q": "host"}
    assert [r.getMessage() for r in caplog.records
            if r.name == "siddhi_tpu_torch"] == [
        "query 'q': dense TPU path unavailable (dense path: capture 'a.sym' "
        "has type string; only numeric attributes have device lanes — host "
        "engine used); using host pattern engine"]


# -- a card whose kernels fail is no fallback ------------------------------------

KERNEL_APPS = {
    "pattern": (
        "define stream S (sym string, v double); @info(name='q') "
        "from every a=S[v > 1.0] -> b=S[v > a.v] "
        "select a.v as av, b.v as bv insert into Alerts;"),
    "partition": (
        "define stream S (sym string, v double); partition with (sym of S) "
        "begin @info(name='q') from every a=S[v > 1.0] -> b=S[v > a.v] "
        "select a.v as av, b.v as bv insert into Alerts; end;"),
}


def failing_probe(monkeypatch):
    """``probe.kernels_available`` fails, and every dense engine checks
    its kernels as it would on a card."""
    import torch

    from siddhi_tpu_torch.kernels import probe
    from siddhi_tpu_torch.ops.dense_nfa import DensePatternEngine

    monkeypatch.setattr(probe, "kernels_available", lambda device: (
        False, "kernel build or launch failed: no nvcc"))
    check = DensePatternEngine.check_kernels

    def on_card(self):
        device, self.device = self.device, torch.device("cuda")
        try:
            check(self)
        finally:
            self.device = device

    monkeypatch.setattr(DensePatternEngine, "check_kernels", on_card)


@pytest.mark.parametrize("label", sorted(KERNEL_APPS))
def test_kernel_failure_is_no_fallback(label, monkeypatch, caplog):
    """Under ``execution('tpu')`` a pattern the dense path takes, on a
    card whose kernels do not build or launch, fails app creation: it
    moves neither to the host engine nor to per-key instances."""
    from siddhi_tpu_torch.core.exceptions import KernelUnavailableError

    failing_probe(monkeypatch)
    app = ("@app:playback @app:execution('tpu', partitions='8') "
           + KERNEL_APPS[label])
    with caplog.at_level(logging.WARNING, logger="siddhi_tpu_torch"):
        with pytest.raises(KernelUnavailableError, match="no nvcc"):
            SiddhiManager(device="cpu").create_siddhi_app_runtime(app)
    assert not [r for r in caplog.records if r.name == "siddhi_tpu_torch"]
    # the same app in the default mode never reaches the probe
    rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(
        "@app:playback " + KERNEL_APPS[label])
    assert set(rt.lowering().values()) == {"host"}


@pytest.mark.parametrize("gate", ["check_scan_kernel_available",
                                  "check_bank_kernel_available"])
def test_scan_and_bank_gates_raise_kernel_unavailable(gate, monkeypatch):
    """The hot-key scan's and the aggregation bank's gates raise the
    error no fallback catches, on a card; a CPU engine passes."""
    import types

    import torch

    from siddhi_tpu_torch.core.exceptions import KernelUnavailableError
    from siddhi_tpu_torch.kernels import probe
    from siddhi_tpu_torch.planner import kernels

    monkeypatch.setattr(probe, "kernels_available", lambda device: (
        False, "kernel build or launch failed: no nvcc"))
    check = getattr(kernels, gate)
    check(types.SimpleNamespace(device=torch.device("cpu")))
    with pytest.raises(KernelUnavailableError, match="no nvcc"):
        check(types.SimpleNamespace(device=torch.device("cuda")))
