"""The port's general dense step (``DensePatternEngine.make_general_step``)
against the JAX package's XLA step.

The same seeded numpy batches go through the JAX engine's ``process``
(its jitted XLA step, ``use_kernel = False``, over padded collision
rounds) and through the port's engine on ``device="cpu"`` (the general
step in torch ops over the same rounds, unpadded).  Matches, output
values bit for bit (the sign of zero and NaN payloads included) and the
whole state (``active``, ``first_ts``, ``counts``, ``regs``, ``iregs``,
``overflow``, free lanes' stale registers included) must be equal:
tolerance 0.

The JAX package's ``compile_pattern`` resets a partition on every match
(``reset_on_emit=True``); its product runtime does so only for non-every
heads.  The port's ``compile_pattern`` takes the runtime's choice unless
``reset_on_emit`` is given, so each engine pair here is built with the
same setting.
"""

import re

import numpy as np
import pytest
import torch

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.ops.dense_nfa import compile_pattern as jax_compile
from siddhi_tpu_torch import (
    SiddhiManager,
    compile_pattern,
    state_from_numpy,
    state_to_numpy,
)
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.ops import dense_nfa
from test_torch_device_query import FallbackLog

DEFINE = "define stream S (k long, u double, v double); "
WITHIN_MS = 600_000


def headline_app(n_states):
    """``bench.py:161 pattern_query`` / ``:172 flat_app`` at ``n_states``
    nodes: every e1=Txn[v > 0.0] -> e2=Txn[v > 1.0 and v > e1.v] -> ..."""
    states = ["every e1=Txn[v > 0.0]"]
    for i in range(2, n_states + 1):
        states.append(f"e{i}=Txn[v > {float(i - 1)} and v > e1.v]")
    return ("define stream Txn (key long, v double); @info(name='bench') "
            f"from {' -> '.join(states)} within 10 min "
            f"select e1.v as v1, e{n_states}.v as v{n_states} "
            "insert into Alerts;")


def engines(app, qname, P, n_instances=4, reset_on_emit=False,
            kind="general"):
    je = jax_compile(app, qname, n_partitions=P, n_instances=n_instances)
    je.reset_on_emit = reset_on_emit
    te = compile_pattern(app, qname, n_partitions=P, n_instances=n_instances,
                         device="cpu", reset_on_emit=reset_on_emit)
    assert not je.use_kernel and te.step_kind == kind
    return je, te


def bits(out):
    """A match matrix as comparable bits: float32 lanes by their words,
    object matrices (integer outputs) by value type and float64 bits."""
    if out.dtype == object:
        return [[(type(x).__name__, np.float64(x).tobytes()
                  if isinstance(x, float) else int(x)) for x in row]
                for row in out.tolist()]
    return out.view(np.int32).tolist()


def assert_same_matches(jres, tres):
    (jev, jout), (tev, tout) = jres, tres
    assert np.array_equal(jev, tev)
    assert jout.dtype == tout.dtype and jout.shape == tout.shape
    assert bits(jout) == bits(tout)


def assert_same_state(jstate, te, tstate):
    host, base_ts = state_to_numpy(te, tstate)
    assert set(host) == set(jstate)
    for k, v in host.items():
        j = np.asarray(jstate[k])
        assert j.dtype == v.dtype and j.shape == v.shape, k
        assert np.array_equal(j.view(np.uint8), v.view(np.uint8)), k
    return host


def drive(je, te, sends, stream="S", jstate=None, tstate=None):
    jstate = je.init_state() if jstate is None else jstate
    tstate = te.init_state() if tstate is None else tstate
    n = 0
    for part, cols, ts in sends:
        jstate, *jres = je.process(jstate, stream, part, cols, ts)
        tstate, *tres = te.process(tstate, stream, part, cols, ts)
        assert_same_matches(jres, tres)
        n += len(tres[0])
    host = assert_same_state(jstate, te, tstate)
    return jstate, tstate, host, n


def mid_chain_state(engine, seed):
    """Seeded mid-chain state, as ``chip_smoke.py``'s 1 M cell starts:
    ~30% of lanes pending with anchors over the last ``within`` and
    registers everywhere (free lanes keep stale values, as in the
    reference)."""
    rng = np.random.default_rng(seed)
    host = engine.init_state_host()
    shape = host["active"].shape
    active = rng.random(shape) < 0.3
    active[-1] = False  # scratch row
    host["active"] = active
    host["first_ts"] = np.where(
        active, rng.integers(1, WITHIN_MS + 1, shape), 0).astype(np.int32)
    host["regs"] = rng.uniform(
        0.0, 20.0, host["regs"].shape).astype(np.float32)
    return host, 1000 - WITHIN_MS


def txn_batches(seed, n_batches, B, P, n_states):
    """``bench.py:191-205``'s batches, with partitions drawn at random so
    they collide (several rounds a batch) and per-event timestamps."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        part = rng.integers(0, P, B).astype(np.int32)
        v = rng.uniform(0.0, float(n_states + 4), B).astype(np.float32)
        ts = 1000 + 10 * B * i + np.arange(B, dtype=np.int64)
        out.append((part, {"key": part.astype(np.int64), "v": v}, ts))
    return out


@pytest.mark.parametrize("reset_on_emit", [False, True],
                         ids=["runtime", "jax_compile_pattern"])
@pytest.mark.parametrize("n_states", [4, 16])
def test_headline_chain_matches_jax(n_states, reset_on_emit):
    """The headline ``v > e1.v`` chain cut to 4 and 16 states, at 64
    partitions, from a mid-chain state, with colliding partitions."""
    je, te = engines(headline_app(n_states), "bench", P=64,
                     reset_on_emit=reset_on_emit)
    host, base_ts = mid_chain_state(te, seed=n_states)
    jstate = {k: je.jnp.asarray(v) for k, v in host.items()}
    je.base_ts = base_ts
    tstate = state_from_numpy(te, host, base_ts)
    sends = txn_batches(7, 3, 256, 64, n_states)
    assert max(np.bincount(p).max() for p, _c, _t in sends) > 4  # rounds
    *_, n = drive(je, te, sends, "Txn", jstate, tstate)
    assert n > 0


# the part-a shapes of tests/test_dense_differential_fuzz.py:88-122
FUZZ_SHAPES = {
    "every_pair": (
        "@info(name='q') from every a=S[v > 10.0] -> b=S[v > a.v] "
        "within 3 sec select a.v as av, b.v as bv insert into Alerts;"),
    "every_triple": (
        "@info(name='q') from every a=S[v > 5.0] -> b=S[v > a.v] "
        "-> c=S[v > b.v] within 5 sec "
        "select a.v as av, b.v as bv, c.v as cv insert into Alerts;"),
    "every_two_filters": (
        "@info(name='q') from every a=S[u > 10.0 and v > 10.0] "
        "-> b=S[v < a.v and u > a.u] within 4 sec "
        "select a.u as au, a.v as av, b.u as bu, b.v as bv "
        "insert into Alerts;"),
    "int_id_join": (
        "@info(name='q') from every a=S[v > 10.0] -> b=S[k == a.k] "
        "within 3 sec select a.v as av, b.v as bv insert into Alerts;"),
    "no_within": (
        "@info(name='q') from every a=S[v > 15.0] -> b=S[v > a.v] "
        "select a.v as av, b.v as bv insert into Alerts;"),
}


def fuzz_stream(seed, n=60, dt_max=400):
    """``tests/test_dense_differential_fuzz.py``'s ``gen_stream``."""
    rng = np.random.default_rng(seed)
    ts = 1000 + np.cumsum(rng.integers(1, dt_max, size=n))
    ks = rng.integers(0, 3, size=n)
    us = rng.uniform(0.0, 20.0, size=n).round(1)
    vs = rng.uniform(0.0, 20.0, size=n).round(1)
    return [([int(k), float(u), float(v)], int(t))
            for k, u, v, t in zip(ks, us, vs, ts)]


def run_app(port, app, sends, header="@app:playback "
            "@app:execution('tpu', instances='16') "):
    mgr = SiddhiManager(device="cpu") if port else JaxManager()
    try:
        rt = mgr.create_siddhi_app_runtime(header + DEFINE + app)
        got = []
        rt.add_callback("Alerts", lambda evs: got.append(
            [(e.timestamp, list(e.data)) for e in evs]))
        rt.start()
        h = rt.get_input_handler("S")
        for row, ts in sends:
            h.send(list(row), timestamp=ts)
        low = rt.lowering(step_kinds=True) if port else rt.lowering()
        rt.shutdown()
        return got, low
    finally:
        mgr.shutdown()


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("shape", sorted(FUZZ_SHAPES))
def test_fuzz_shapes_match_jax(shape, seed):
    """Unpartitioned apps through both packages' ``SiddhiManager``: the
    same rows, bit for bit, in the same order."""
    sends = fuzz_stream(seed)
    jgot, jlow = run_app(False, FUZZ_SHAPES[shape], sends)
    tgot, tlow = run_app(True, FUZZ_SHAPES[shape], sends)
    assert jlow == {"q": "dense"} and tlow == {"q": "dense/general"}
    assert tgot == jgot
    if shape != "no_within":  # no_within may not complete in 60 events
        assert tgot


SPECIALS = [-0.0, float(np.array([0x7FC12345], np.uint32).view(np.float32)[0]),
            -np.nan, 1e-40, -1e-40, 3.5]


@pytest.mark.parametrize("n_instances", [1, 4])
def test_signed_zero_nan_and_subnormal_captures(n_instances):
    """Registers move between nodes by the reference's one-hot sum: with
    one lane XLA keeps the value's bits, with more it turns -0.0 and
    subnormals into +0.0 and keeps NaN payloads.  Every capture rides
    the chain, so each of its values is checked at nodes 0, 1 and 2."""
    app = DEFINE + ("@info(name='q') from every a=S[u > 5.0] -> "
                    "b=S[u > 5.0] -> c=S[u > 5.0] select a.v as av, "
                    "b.v as bv, c.v as cv insert into Alerts;")
    je, te = engines(app, "q", P=len(SPECIALS), n_instances=n_instances)
    part = np.repeat(np.arange(len(SPECIALS), dtype=np.int32), 3)
    cols = {"k": np.zeros(len(part), np.int64), "u": np.full(len(part), 9.0),
            "v": np.repeat(np.array(SPECIALS), 3)}
    ts = 1000 + np.arange(len(part))
    jstate, *jres = je.process(je.init_state(), "S", part, cols, ts)
    tstate, tev, tout = te.process(te.init_state(), "S", part, cols, ts)
    assert_same_matches(jres, (tev, tout))
    assert_same_state(jstate, te, tstate)
    assert len(tev) == len(SPECIALS)
    av = tout[:, 0]
    # the pin: a -0.0 capture reaches the output signed at I = 1 only
    assert np.signbit(av[0]) == (n_instances == 1)
    assert np.isnan(av[1]) and np.isnan(av[2])


def test_first_and_last_select_refs():
    """``a[0]`` and ``a[last]`` refs of plain nodes, in filters and
    selects, with an integer capture (the ``iregs`` bank)."""
    app = DEFINE + ("@info(name='q') from every a=S[v > 8.0] -> "
                    "b=S[v > a[last].v and k > a[0].k] within 3 sec "
                    "select a[0].v as a0, a[last].v as al, a.k as ak, "
                    "b.v as bv insert into Alerts;")
    je, te = engines(app, "q", P=8)
    assert te.alloc.n == 2 and te.alloc.n_int == 1
    rng = np.random.default_rng(4)
    sends = []
    for i in range(3):
        part = rng.integers(0, 8, 96).astype(np.int32)
        cols = {"k": rng.integers(-2**40, 2**40, 96),
                "u": rng.uniform(0, 20, 96), "v": rng.uniform(0, 20, 96)}
        sends.append((part, cols, 1000 + 300 * i + np.arange(96)))
    *_, host, n = drive(je, te, sends)
    assert n > 0 and host["iregs"].shape == (9, 2, 4, 2)


def test_state_layout_matches_jax():
    app = DEFINE + ("@info(name='q') from every a=S[v > 8.0] -> "
                    "b=S[k == a.k and v > a.v] -> c=S[u > b.u] "
                    "select a.v as av, c.k as ck insert into Alerts;")
    je, te = engines(app, "q", P=10, n_instances=5)
    jhost, thost = je.init_state_host(), te.init_state_host()
    assert set(jhost) == set(thost) and "iregs" in thost
    for k in jhost:
        assert jhost[k].shape == thost[k].shape, k
        assert jhost[k].dtype == thost[k].dtype, k
        assert np.array_equal(jhost[k], thost[k]), k


def test_state_carried_across_from_jax():
    """JAX runs two batches; its state, registers included, continues in
    the port."""
    app = DEFINE + FUZZ_SHAPES["every_two_filters"]
    je, te = engines(app, "q", P=16)
    sends = []
    rng = np.random.default_rng(17)
    for i in range(4):
        part = rng.integers(0, 16, 64).astype(np.int32)
        cols = {"k": rng.integers(0, 9, 64), "u": rng.uniform(0, 20, 64),
                "v": rng.uniform(0, 20, 64)}
        sends.append((part, cols, 1000 + 500 * i + np.arange(64)))
    jstate = je.init_state()
    for part, cols, ts in sends[:2]:
        jstate, _ev, _out = je.process(jstate, "S", part, cols, ts)
    host = {k: np.asarray(v) for k, v in jstate.items()}
    assert host["regs"].any()
    tstate = state_from_numpy(te, host, je.base_ts)
    *_, n = drive(je, te, sends[2:], jstate=jstate, tstate=tstate)
    assert n > 0


def test_one_put_and_no_host_read_inside_the_rounds(monkeypatch):
    """A batch of several rounds: one ``staged_put``, one chunk per
    round, and no tensor read back to the host until ``resolve``."""
    te = compile_pattern(DEFINE + FUZZ_SHAPES["every_pair"], "q",
                         n_partitions=4, device="cpu")
    part = np.array([0, 1, 0, 0, 2, 1, 0], dtype=np.int32)
    cols = {"k": np.zeros(7, np.int64), "u": np.zeros(7),
            "v": np.array([11.0, 12, 13, 14, 15, 16, 17])}
    puts = []
    real_put = dense_nfa.staged_put
    monkeypatch.setattr(dense_nfa, "staged_put",
                        lambda *a, **k: puts.append(1) or real_put(*a, **k))

    def no_read(*_a, **_k):
        raise AssertionError("a tensor crossed to the host in the rounds")

    for name in ("item", "cpu", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, no_read)
    state, pending = te.process_deferred(te.init_state(), "S", part, cols,
                                         1000 + np.arange(7))
    monkeypatch.undo()
    assert len(puts) == 1 and len(pending.parts) == 4
    assert [len(p.ridx) for p in pending.parts] == [3, 2, 1, 1]
    assert pending.resolve() == 4  # 11->13->14->17 on row 0, 12->16 on 1


def test_snapshot_restore_with_registers():
    """The runtime's snapshot carries ``regs`` and ``iregs``; restoring
    rewinds a stray event, as in the reference."""
    app = ("partition with (k of S) begin @info(name='q') from every "
           "a=S[v > 8.0] -> b=S[v > a.v] within 5 sec select a.k as ak, "
           "a.v as av, b.v as bv insert into Alerts; end;")
    sends = fuzz_stream(8, n=160, dt_max=60)
    header = "@app:playback @app:execution('tpu', partitions='8') "
    runs = []
    for port in (False, True):
        mgr = SiddhiManager(device="cpu") if port else JaxManager()
        rt = mgr.create_siddhi_app_runtime(header + DEFINE + app)
        got = []
        rt.add_callback("Alerts", lambda evs, got=got: got.extend(
            (e.timestamp, list(e.data)) for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        for row, ts in sends[:80]:
            h.send(list(row), timestamp=ts)
        if port:
            dense = rt.pattern_runtimes()["q"]
        else:
            dense = next(iter(next(iter(rt.partitions.values()))
                              .dense_query_runtimes.values())).pattern_processor
        snap = dense.snapshot()
        h.send([1, 15.0, 19.5], timestamp=sends[79][1] + 5)
        dense.restore(snap)
        for row, ts in sends[80:]:
            h.send(list(row), timestamp=ts)
        final = dense.snapshot()["dense_state"]
        rt.shutdown()
        mgr.shutdown()
        runs.append((got, snap["dense_state"], final))
    (jgot, jsnap, jfinal), (tgot, tsnap, tfinal) = runs
    assert tgot == jgot and tgot
    assert tsnap["regs"].shape == (9, 2, 4, 1)
    assert tsnap["iregs"].shape == (9, 2, 4, 2)
    for k in jfinal:
        assert np.array_equal(np.asarray(jfinal[k]).view(np.uint8),
                              tfinal[k].view(np.uint8)), k


@pytest.mark.parametrize("app,kind", [
    ("@info(name='q') from every a=S[v > 8.0] -> b=S[v > a.v] within 3 sec "
     "select a.v as av, b.v as bv insert into Alerts;", "dense/general"),
    ("@info(name='q') from every a=S[v > 8.0] -> b=S[v > 12.0] within 3 sec "
     "select b.v as bv insert into Alerts;", "dense/batch"),
], ids=["capture", "capture_free"])
def test_unpartitioned_app_runs_at_one_partition(app, kind):
    """An unpartitioned pattern under ``execution('tpu')`` runs on one
    partition: a capturing chain on the general step (a round an
    event), a capture-free one on the batch step (one segment)."""
    sends = fuzz_stream(21, n=200, dt_max=90)
    header = "@app:playback @app:execution('tpu') "
    jgot, jlow = run_app(False, app, sends, header)
    tgot, tlow = run_app(True, app, sends, header)
    assert tlow == {"q": kind} and jlow == {"q": "dense"}
    assert tgot == jgot and tgot
    rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(
        header + DEFINE + app)
    assert rt.pattern_runtimes()["q"].engine.n_partitions == 1


# once refused (the part-b shapes): now the general step, as the
# reference runs them
ONCE_REFUSED = {
    "count": "every a=S[v > 8.0] -> b=S[v > a.v]<2> select b[last].v as bv",
    "sequence": "every a=S[v > 8.0], b=S[v > a.v] select b.v as bv",
    "non_every": "a=S[v > 8.0] -> b=S[v > a.v] select b.v as bv",
    "group_every": ("every (a=S[v > 8.0] -> b=S[v > a.v]) within 3 sec "
                    "select b.v as bv"),
    "logical": ("every a=S[v > 8.0] -> b=S[v > a.v] or c=S[u > 1.0] "
                "select a.v as av"),
}


@pytest.mark.parametrize("name", sorted(ONCE_REFUSED))
def test_once_refused_shapes_match_jax(name):
    """The shapes this port once refused run on the general step: the
    same rows as the reference through both packages' ``SiddhiManager``."""
    app = f"@info(name='q') from {ONCE_REFUSED[name]} insert into Alerts;"
    sends = fuzz_stream(31, n=120, dt_max=200)
    jgot, jlow = run_app(False, app, sends)
    tgot, tlow = run_app(True, app, sends)
    assert jlow == {"q": "dense"} and tlow == {"q": "dense/general"}
    assert tgot == jgot and tgot


@pytest.mark.parametrize("app,reason,item", [
    ("not S[v > 8.0] for 1 sec -> c=S[v > 1.0] select c.v as cv",
     "leading absent 'for' deadline", None),
    ("every a=S[v > 8.0] -> b=S[v > a.v] and not S[v > 1.0] "
     "select b.v as bv", "logical and-not over the SAME stream", None),
    ("every a=S[v > 8.0] -> b=S[v > a.v]<0:2> -> c=S[v > 1.0] "
     "select c.v as cv", "optional (min 0) states", None),
    ("every (a=S[v > 8.0] -> b=S[v > a.v]) -> c=S[v > 1.0] "
     "select c.v as cv", "group-`every` shape (partial chain", None),
    ("every a=S[v > 8.0]<1:> -> b=S[v < 4.0]<2> select a[0].v as av",
     "open-ended count followed by a count/logical node", None),
    ("every a=S[v > 8.0] -> b=S[v > a.v]<2> and c=T[v > 1.0] "
     "select c.v as cv", "count states inside logical and/or", None),
], ids=["absent", "and_not", "min_zero_count", "partial_group",
        "open_count_then_count", "count_in_logical"])
def test_refusals_name_their_roadmap_item(app, reason, item):
    """What the dense engine refuses: the shapes the reference sends to
    its host engine, with its reason, absent ones among them (a leading
    absent deadline, an ``and not`` over its present side's stream).
    Since the host pattern engine came to the port (``ROADMAP.md`` §1
    item 7), an app with such a query falls back to it, so the refusal
    names no later slice.  A count inside a logical node the reference's
    lowering refuses for both its engines; the port's copy of it gives
    the same reason.  (The name is the test's from when the refusals
    named item 7.)"""
    text = (f"{DEFINE}define stream T (k long, u double, v double); "
            f"@info(name='q') from {app} insert into Alerts;")
    with pytest.raises(SiddhiAppCreationError) as info:
        compile_pattern(text, "q", n_partitions=4, device="cpu")
    msg = str(info.value)
    if reason is not None:
        with pytest.raises(Exception, match=re.escape(reason)):
            jax_compile(text, "q", n_partitions=4)
        assert reason in msg
    if item is None:
        assert "ROADMAP" not in msg and "later slice" not in msg
    else:
        assert f"ROADMAP.md §1 {item}" in msg and "later slice" in msg


def test_a_bad_capture_filter_fails_at_plan_time():
    """The plan-time trace evaluates capture filters on register lanes:
    a filter that also reads a string attribute fails there, and the
    query falls back to the host pattern engine with a WARNING."""
    app = ("@app:execution('tpu') define stream T (sym string, v double); "
           "@info(name='q') from every a=T[v > 8.0] -> "
           "b=T[v > a.v and sym == 'IBM'] select a.v as av, b.v as bv "
           "insert into Alerts;")
    with FallbackLog("siddhi_tpu_torch") as log:
        rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(app)
    # the app then runs on the host pattern engine, as the reference's
    assert rt.lowering() == {"q": "host"}
    assert len(log.messages) == 1 and "not traceable" in log.messages[0]
    ok = app.replace(" and sym == 'IBM'", "")
    rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(ok)
    assert rt.lowering(step_kinds=True) == {"q": "dense/general"}


def test_bench_partitioned_app_matches_jax():
    """``bench.py``'s ``partitioned_app()`` (the headline chain inside
    ``partition with (key of Txn)``) with ``bench_product``'s batch
    layout, cut to 8 keys so chains complete: the same rows as the
    reference through both packages' ``SiddhiManager``."""
    import importlib.util
    from pathlib import Path

    from siddhi_tpu.core.event import EventBatch as JaxEventBatch
    from siddhi_tpu_torch.core.event import EventBatch

    spec = importlib.util.spec_from_file_location(
        "bench", Path(__file__).resolve().parent.parent / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    header = "@app:playback @app:execution('tpu', partitions='8') "
    rng = np.random.default_rng(11)
    batches = [(np.arange(256) % 8, rng.uniform(0.0, 20.0, 256),
                np.full(256, 1000 + 10 * i, dtype=np.int64)) for i in range(6)]
    runs = []
    for port in (False, True):
        mgr = SiddhiManager(device="cpu") if port else JaxManager()
        cls = EventBatch if port else JaxEventBatch
        rt = mgr.create_siddhi_app_runtime(header + bench.partitioned_app())
        got = []
        rt.add_callback("Alerts", lambda evs, got=got: got.append(
            [(e.timestamp, list(e.data)) for e in evs]))
        rt.start()
        h = rt.get_input_handler("Txn")
        for keys, v, ts in batches:
            h.send_batch(cls("Txn", ["key", "v"], {"key": keys, "v": v}, ts))
        low = rt.lowering(step_kinds=True) if port else rt.lowering()
        rt.shutdown()
        mgr.shutdown()
        runs.append((got, low))
    (jgot, jlow), (tgot, tlow) = runs
    assert jlow == {"bench": "dense"} and tlow == {"bench": "dense/general"}
    assert tgot == jgot and sum(map(len, tgot)) > 0


SUBNORMAL_FILTERS = {
    # the batch step (capture-free) and the general step read a
    # subnormal column as zero
    "batch_compare": ("v > 0.0", "select b.v as bv"),
    "general_compare": ("v > 0.0", "select a.v as av, b.v as bv"),
    # arithmetic landing below 2^-126 flushes to a zero of its sign
    "product": ("v * 1e-30 > 0.0", "select a.v as av, b.v as bv"),
    "difference": ("v - 1.4e-38 > 0.0", "select a.v as av, b.v as bv"),
    # a subnormal constant reads as zero where it meets a lane ...
    "constant": ("v >= 1e-40", "select a.v as av, b.v as bv"),
    # ... but constants multiply in float64 first, as in the trace
    "constant_product": ("v > 1e-20 * 1e-20", "select a.v as av, b.v as bv"),
}
SUBNORMAL_V = [1e-40, -1e-40, 1e-10, 1.5e-38, 0.0, 2e-40, 1.0]
# the partitions (one value each) whose chain completes on the
# reference's XLA on the CPU
SUBNORMAL_JAX = {
    "batch_compare": [2, 3, 6], "general_compare": [2, 3, 6],
    "product": [6], "difference": [2, 6], "constant": [0, 1, 2, 3, 4, 5, 6],
    "constant_product": [2, 3, 6],
}


@pytest.mark.parametrize("n_instances", [1, 4])
@pytest.mark.parametrize("case", sorted(SUBNORMAL_FILTERS))
def test_subnormal_compare_differs_from_xla_on_the_cpu(case, n_instances):
    """Once a divergence (``ROADMAP.md`` §3 item 6, now closed): XLA on
    the CPU reads a subnormal float32 as zero in a comparison and
    flushes subnormal results of float arithmetic, and the port's
    filters do the same, on the batch step and the general step.  One
    value a partition; the chains that complete are the reference's."""
    flt, sel = SUBNORMAL_FILTERS[case]
    app = DEFINE + (f"@info(name='q') from every a=S[{flt}] -> "
                    f"b=S[u > 5.0] {sel} insert into Alerts;")
    je, te = engines(app, "q", P=len(SUBNORMAL_V), n_instances=n_instances,
                     kind="batch" if case == "batch_compare" else "general")
    part = np.repeat(np.arange(len(SUBNORMAL_V), dtype=np.int32), 2)
    cols = {"k": np.zeros(len(part), np.int64),
            "u": np.tile([0.0, 9.0], len(SUBNORMAL_V)),
            "v": np.array([x for v in SUBNORMAL_V for x in (v, 3.0)])}
    ts = 1000 + np.arange(len(part))
    jstate, *jres = je.process(je.init_state(), "S", part, cols, ts)
    tstate, tev, tout = te.process(te.init_state(), "S", part, cols, ts)
    assert part[jres[0]].tolist() == SUBNORMAL_JAX[case]
    assert_same_matches(jres, (tev, tout))
    assert_same_state(jstate, te, tstate)


def test_subnormal_register_compare_matches_xla():
    """A subnormal capture keeps its bits at one lane and is compared as
    zero: ``b.v = 2e-40 > a.v = 1e-40`` fails on the reference and in
    the port."""
    app = DEFINE + ("@info(name='q') from every a=S[u < 1.0] -> "
                    "b=S[v > a.v and u > 5.0] select a.v as av, b.v as bv "
                    "insert into Alerts;")
    je, te = engines(app, "q", P=len(SUBNORMAL_V), n_instances=1)
    part = np.repeat(np.arange(len(SUBNORMAL_V), dtype=np.int32), 2)
    cols = {"k": np.zeros(len(part), np.int64),
            "u": np.tile([0.0, 9.0], len(SUBNORMAL_V)),
            "v": np.array([x for v in SUBNORMAL_V for x in (1e-40, v)])}
    ts = 1000 + np.arange(len(part))
    jstate, *jres = je.process(je.init_state(), "S", part, cols, ts)
    tstate, tev, tout = te.process(te.init_state(), "S", part, cols, ts)
    assert part[jres[0]].tolist() == [2, 3, 6]
    assert_same_matches(jres, (tev, tout))
    assert_same_state(jstate, te, tstate)
    # the capture rode the one-lane move with its bits
    assert tout[0, 0].view(np.int32) == np.float32(1e-40).view(np.int32)
