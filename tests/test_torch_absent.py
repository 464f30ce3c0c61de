"""Absent patterns on the port's dense engine against the JAX package.

``not X for t`` nodes and ``and not`` sides run on the general step
(kills on a matching event, deadlines armed on entry) and the timer
step (``make_time_step``: deadlines that passed fire or advance), driven
by the app scheduler.  The same apps and sends go through both
packages' ``SiddhiManager`` on the CPU (the JAX engine's XLA step and
timer step); engine-level tests start both engines from the same seeded
numpy state.  Tolerance 0: callbacks (values, timestamps, order), the
fired matches (outputs, fire times, partition rows, in the reference's
(fire time, row, lane) order) and the whole state (``deadline``
included) must be equal.

Both packages get the same app text.  ``tests/test_dense_absent.py``
adds a ``Tick`` consumer query, which the port refuses as a non-pattern
query (``ROADMAP.md`` §1 item 3); here the ticks go to a defined stream
with no query, which advances the clock in both packages alike.
"""

import numpy as np
import pytest

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.ops.dense_nfa import compile_pattern as jax_compile
from siddhi_tpu_torch import (
    SiddhiManager,
    compile_pattern,
    state_from_numpy,
    state_to_numpy,
)
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from test_torch_device_query import FallbackLog

STREAMS = (
    "define stream Stream1 (symbol string, price float, volume int); "
    "define stream Stream2 (symbol string, price float, volume int); "
    "define stream Stream3 (symbol string, price float, volume int); "
    "define stream Tick (x int); "
)
TPU = "@app:execution('tpu') "
F56 = float(np.float32(55.6))

TRAILING = ("@info(name='q') from e1=Stream1[price>20] -> "
            "not Stream2[price>e1.price] for 1 sec "
            "select e1.price as p1 insert into OutputStream;")
EVERY_TRAILING = TRAILING.replace("from e1=", "from every e1=")
MID = ("@info(name='q') from e1=Stream1[price>20] -> "
       "not Stream2[price == e1.price] for 1 sec -> "
       "e3=Stream3[price > e1.price] "
       "select e1.price as p1, e3.price as p insert into OutputStream;")
AND_NOT = ("@info(name='q') from e1=Stream1[price>20] -> "
           "(e2=Stream3[price>30] and not Stream2[price>40]) "
           "select e1.price as p1, e2.price as p insert into OutputStream;")
AND_NOT_FOR = AND_NOT.replace("Stream2[price>40])",
                              "Stream2[price>40] for 1 sec)")
ALL_ABSENT = ("@info(name='q') from e1=Stream1[price>20] -> "
              "(not Stream2[price>40] and not Stream3[price>40] for 1 sec) "
              "select e1.price as p insert into OutputStream;")
PARTITIONED = (
    "@app:execution('tpu', partitions='64') " + STREAMS +
    "partition with (symbol of Stream1, symbol of Stream2) begin "
    "@info(name='q') from e1=Stream1[price>20] -> "
    "not Stream2[price>e1.price] for 1 sec "
    "select e1.price as p insert into OutputStream; end;")

# tests/test_dense_absent.py's dense scenarios: app, sends, the rows the
# reference emits there
SCENARIOS = {
    "trailing_fires_at_deadline": (TRAILING, [
        ("Stream1", ["WSO2", 55.6, 100], 1000), ("Tick", [1], 2500)],
        [([F56], 2000)]),
    "trailing_suppressed": (TRAILING, [
        ("Stream1", ["WSO2", 55.6, 100], 1000),
        ("Stream2", ["IBM", 58.7, 100], 1500), ("Tick", [1], 2500)], []),
    "trailing_non_matching_keeps": (TRAILING, [
        ("Stream1", ["WSO2", 55.6, 100], 1000),
        ("Stream2", ["IBM", 10.0, 100], 1500), ("Tick", [1], 2500)],
        [([F56], 2000)]),
    "trailing_late_event": (TRAILING, [
        ("Stream1", ["WSO2", 55.6, 100], 1000),
        ("Stream2", ["IBM", 58.7, 100], 2100)], [([F56], 2000)]),
    "every_independent_deadlines": (EVERY_TRAILING, [
        ("Stream1", ["A", 30.0, 1], 1000), ("Stream1", ["B", 40.0, 1], 1400),
        ("Tick", [1], 2200), ("Tick", [2], 3000)],
        [([30.0], 2000), ([40.0], 2400)]),
    "every_kill_hits_matching_arms": (EVERY_TRAILING, [
        ("Stream1", ["A", 30.0, 1], 1000), ("Stream1", ["B", 40.0, 1], 1400),
        ("Stream2", ["K", 35.0, 1], 1600), ("Tick", [1], 3000)],
        [([40.0], 2400)]),
    "within_expires_first": (
        "@info(name='q') from e1=Stream1[price>20] -> "
        "not Stream2[price>e1.price] for 2 sec within 1 sec "
        "select e1.price as p1 insert into OutputStream;", [
            ("Stream1", ["WSO2", 55.6, 100], 1000), ("Tick", [1], 4000)], []),
    "mid_chain_after_deadline": (MID, [
        ("Stream1", ["W", 30.0, 1], 1000), ("Stream3", ["W", 50.0, 1], 1500),
        ("Tick", [1], 2100), ("Stream3", ["W", 60.0, 1], 2500)],
        [([30.0, 60.0], 2500)]),
    "mid_chain_killed": (MID, [
        ("Stream1", ["W", 30.0, 1], 1000), ("Stream2", ["W", 30.0, 1], 1500),
        ("Tick", [1], 2100), ("Stream3", ["W", 60.0, 1], 2500)], []),
    "mid_chain_filter_mismatch": (MID, [
        ("Stream1", ["W", 30.0, 1], 1000), ("Stream2", ["X", 1.0, 1], 1500),
        ("Tick", [1], 2100), ("Stream3", ["W", 60.0, 1], 2500)],
        [([30.0, 60.0], 2500)]),
    "and_not_fires_on_present": (AND_NOT, [
        ("Stream1", ["W", 25.0, 1], 1000), ("Stream3", ["W", 35.0, 1], 1500)],
        [([25.0, 35.0], 1500)]),
    "and_not_killed": (AND_NOT, [
        ("Stream1", ["W", 25.0, 1], 1000), ("Stream2", ["K", 45.0, 1], 1200),
        ("Stream3", ["W", 35.0, 1], 1500)], []),
    "and_not_for_waits_out_window": (AND_NOT_FOR, [
        ("Stream1", ["W", 25.0, 1], 1000), ("Stream3", ["W", 35.0, 1], 1500),
        ("Tick", [1], 2500)], [([25.0, 35.0], 2000)]),
    "and_not_for_present_after_window": (AND_NOT_FOR, [
        ("Stream1", ["W", 25.0, 1], 1000), ("Tick", [1], 2200),
        ("Stream3", ["W", 35.0, 1], 2500)], [([25.0, 35.0], 2500)]),
    "and_not_for_violated_in_window": (AND_NOT_FOR, [
        ("Stream1", ["W", 25.0, 1], 1000), ("Stream3", ["W", 35.0, 1], 1300),
        ("Stream2", ["K", 45.0, 1], 1600), ("Tick", [1], 2500)], []),
    "all_absent_timer_completes": (ALL_ABSENT, [
        ("Stream1", ["W", 25.0, 1], 1000), ("Stream2", ["X", 10.0, 1], 1500),
        ("Tick", [1], 2500)], [([25.0], 2000)]),
    "all_absent_violated": (ALL_ABSENT, [
        ("Stream1", ["W", 25.0, 1], 1000), ("Stream3", ["K", 45.0, 1], 1500),
        ("Tick", [1], 2500)], []),
    "partitioned_per_key_deadlines": (PARTITIONED, [
        ("Stream1", ["A", 30.0, 1], 1000), ("Stream1", ["B", 50.0, 1], 1200),
        ("Stream2", ["B", 60.0, 1], 1500), ("Tick", [1], 3000)],
        [([30.0], 2000)]),
}


def pattern_runtime(rt, port):
    """The query's dense runtime in either package."""
    if port:
        return rt.pattern_runtimes()["q"]
    qr = rt.query_runtimes.get("q")
    if qr is None:
        qr = rt.partitions["partition_0"].dense_query_runtimes["q"]
    return qr.pattern_processor


def run(port, app, sends, snapshot_at=None):
    """``sends`` (stream, row, ts) through a package's ``SiddhiManager``
    under ``@app:playback``: callbacks as (row, ts), the lowering, the
    final state and the runtime.  ``snapshot_at``: send index after
    which the runtime snapshots, to restore it after the next send."""
    text = app if app.startswith("@app:execution") else TPU + STREAMS + app
    mgr = SiddhiManager(device="cpu") if port else JaxManager()
    try:
        rt = mgr.create_siddhi_app_runtime("@app:playback " + text)
        got = []
        rt.add_callback("OutputStream", lambda evs: got.extend(
            (list(e.data), e.timestamp) for e in evs))
        rt.start()
        proc = pattern_runtime(rt, port)
        snap = None
        for i, (stream, row, ts) in enumerate(sends):
            rt.get_input_handler(stream).send(list(row), timestamp=ts)
            if snap is not None:
                proc.restore(snap)
                snap = None
            if i == snapshot_at:
                snap = proc.snapshot()
        low = rt.lowering(step_kinds=True) if port else rt.lowering()
        rt.shutdown()
    finally:
        mgr.shutdown()
    if port:
        state, base = state_to_numpy(proc.engine, proc.state)
    else:
        state = {k: np.asarray(v) for k, v in proc.state.items()}
        base = proc.engine.base_ts
    return got, low["q"], state, base, proc


def assert_same_state(jstate, tstate):
    assert set(jstate) == set(tstate)
    for k, v in tstate.items():
        j = jstate[k]
        assert j.dtype == v.dtype and j.shape == v.shape, k
        assert np.array_equal(j.view(np.uint8), v.view(np.uint8)), k


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_absent_apps_match_jax(name):
    """Every dense absent scenario of ``tests/test_dense_absent.py``:
    the same rows, timestamps and order as the reference, the same
    timer fires, and the same final state, ``deadline`` included."""
    app, sends, want = SCENARIOS[name]
    jgot, jlow, jstate, jbase, jproc = run(False, app, sends)
    tgot, tlow, tstate, tbase, tproc = run(True, app, sends)
    assert jlow == "dense" and tlow == "dense/general"
    assert tgot == jgot == want
    assert tproc.time_fires == jproc.time_fires
    assert tbase == jbase
    assert ("deadline" in tstate) == tproc.engine.has_deadlines
    assert_same_state(jstate, tstate)


def test_pending_deadline_survives_restore():
    """``TestAbsentSnapshotDense``: a kill after the snapshot is undone by
    the restore, and the restored deadline fires (the runtime's own
    snapshot; the port also restores the reference's)."""
    sends = [("Stream1", ["WSO2", 55.6, 100], 1000),
             ("Stream2", ["K", 60.0, 1], 1200), ("Tick", [1], 2500)]
    jgot, _jl, jstate, _jb, jproc = run(False, TRAILING, sends, snapshot_at=0)
    tgot, _tl, tstate, _tb, _tp = run(True, TRAILING, sends, snapshot_at=0)
    assert tgot == jgot == [([F56], 2000)]
    assert_same_state(jstate, tstate)
    # the reference's snapshot restores into the port's runtime
    mgr = SiddhiManager(device="cpu")
    rt = mgr.create_siddhi_app_runtime("@app:playback " + TPU + STREAMS
                                       + TRAILING)
    rt.pattern_runtimes()["q"].restore(jproc.snapshot())
    assert_same_state(jstate, state_to_numpy(
        rt.pattern_runtimes()["q"].engine,
        rt.pattern_runtimes()["q"].state)[0])
    mgr.shutdown()


# -- engine level: seeded states at S = 3, I = 4 ----------------------------

DEFINE = ("define stream S (k long, u double, v double); "
          "define stream T (k long, u double, v double); "
          "define stream U (k long, u double, v double); ")
ENGINE_APPS = {
    # a mid-chain absent node under within
    "within": "every a=S[v > 8.0] -> not T[v > a.v] for 1 sec -> "
              "c=S[v > a.v] within 4 sec select a.v as av, c.v as cv",
    # a trailing absent node, float and integer registers as outputs
    "trailing": "every a=S[v > 8.0] -> b=S[k == a.k] -> not T[v > b.v] "
                "for 2 sec select a.k as ak, b.v as bv",
    # `and not ... for` on another stream than the present side
    "and_not_for": "every a=S[v > 8.0] -> (b=U[v > a.v] and not T[v > "
                   "10.0] for 1 sec) -> c=S[u > 5.0] "
                   "select a.v as av, b.v as bv, c.v as cv",
    # `and not` without `for`, then a trailing absent node
    "and_not": "every a=S[v > 8.0] -> (b=U[v > a.v] and not T[v > 10.0]) "
               "-> not S[v > 15.0] for 1 sec select a.v as av, b.v as bv",
    # a non-every head: one lane, node 0 armed once, reset on emit
    "non_every": "a=S[v > 8.0] -> not T[v > a.v] for 1 sec -> "
                 "c=S[v > 1.0] select a.v as av, c.v as cv",
}
# a few deadlines, so fires tie across rows and lanes
DEADLINES = (3200, 3500, 3500, 4000)


def engines(name, P=8, reset_on_emit=None):
    text = f"{DEFINE}@info(name='q') from {ENGINE_APPS[name]} insert into A;"
    je = jax_compile(text, "q", n_partitions=P)
    te = compile_pattern(text, "q", n_partitions=P, device="cpu",
                         reset_on_emit=reset_on_emit)
    je.reset_on_emit = te.reset_on_emit
    assert te.step_kind == "general" and te.has_deadlines
    assert te.deadline_w == je.deadline_w
    return je, te


def seeded_state(te, seed, first_hi=3000, deadlines=DEADLINES, first_lo=1):
    """About half the lanes pending, anchors in ``[first_lo, first_hi]``,
    side
    bitmasks at logical nodes, registers everywhere, and deadlines from
    ``deadlines`` on the pending lanes of deadline nodes."""
    rng = np.random.default_rng(seed)
    host = te.init_state_host()
    shape = host["active"].shape
    act = rng.random(shape) < 0.5
    act[-1] = False  # scratch row
    host["active"] = act | host["active"]
    host["first_ts"] = np.where(
        act, rng.integers(first_lo, first_hi + 1, shape), 0).astype(np.int32)
    counts = np.zeros(shape, np.int32)
    for s, node in enumerate(te.nodes):
        if node.kind == "logical":
            counts[:, s] = rng.integers(0, 1 << len(node.specs), shape[::2])
    host["counts"] = np.where(act, counts, 0).astype(np.int32)
    host["regs"] = rng.uniform(0.0, 20.0, host["regs"].shape).astype(
        np.float32)
    if "iregs" in host:
        host["iregs"] = rng.integers(-3, 3, host["iregs"].shape,
                                     dtype=np.int32)
    armed = act & np.array([w is not None for w in te.deadline_w])[:, None]
    host["deadline"] = np.where(armed, rng.choice(deadlines, shape),
                                0).astype(np.int32)
    return host


def start_both(je, te, host, base_ts):
    jstate = {k: je.jnp.asarray(v) for k, v in host.items()}
    je.base_ts = base_ts
    return jstate, state_from_numpy(te, host, base_ts)


def same_fired(jf, tf):
    """Both engines' ``on_time_state`` fires, bit for bit."""
    assert (jf is None) == (tf is None)
    if jf is None:
        return 0
    (jout, jts, jrows), (tout, tts, trows) = jf, tf
    assert np.array_equal(jts, tts) and np.array_equal(jrows, trows)
    assert jout.dtype == tout.dtype and jout.shape == tout.shape
    if tout.dtype == object:
        assert jout.tolist() == tout.tolist()
    else:
        assert np.array_equal(jout.view(np.int32), tout.view(np.int32))
    return len(tts)


def assert_engine_state(jstate, te, tstate):
    host, _ = state_to_numpy(te, tstate)
    assert_same_state({k: np.asarray(v) for k, v in jstate.items()}, host)


@pytest.mark.parametrize("reset_on_emit", [None, True],
                         ids=["product_reset", "reset_on_emit"])
@pytest.mark.parametrize("name", sorted(ENGINE_APPS))
def test_on_time_state_matches_jax(name, reset_on_emit):
    """The timer step from a seeded state, ticked past each deadline:
    the same fires in the same (fire time, row, lane) order, and the
    same state after every tick."""
    je, te = engines(name, reset_on_emit=reset_on_emit)
    host = seeded_state(te, seed=len(name))
    jstate, tstate = start_both(je, te, host, 1000)
    fired = 0
    for now in (1000, 4100, 4500, 4500, 5000, 9000):
        jstate, jf = je.on_time_state(jstate, now)
        tstate, tf = te.on_time_state(tstate, now)
        fired += same_fired(jf, tf)
        assert_engine_state(jstate, te, tstate)
    assert fired or name in ("within", "non_every", "and_not_for")


@pytest.mark.parametrize("name", sorted(ENGINE_APPS))
def test_general_step_absent_kills_match_jax(name):
    """Event batches on every stream of the pattern from a seeded state,
    each after a tick to its last timestamp (the scheduler's order):
    kills, and-not completions, deadline arming and the fires match."""
    je, te = engines(name)
    host = seeded_state(te, seed=7 + len(name), first_hi=900,
                        deadlines=(1500, 1800, 2600))
    jstate, tstate = start_both(je, te, host, 0)
    rng = np.random.default_rng(len(name))
    t, n_matches = 1000, 0
    for i in range(8):
        stream = te.stream_keys[i % len(te.stream_keys)]
        part = rng.integers(0, 8, 24).astype(np.int32)
        cols = {"k": rng.integers(0, 3, 24), "u": rng.uniform(0, 20, 24),
                "v": rng.uniform(0, 20, 24)}
        ts = t + np.sort(rng.integers(0, 300, 24))
        t = int(ts[-1])
        jstate, jf = je.on_time_state(jstate, t)
        tstate, tf = te.on_time_state(tstate, t)
        n_matches += same_fired(jf, tf)
        jstate, jev, jout = je.process(jstate, stream, part, cols, ts)
        tstate, tev, tout = te.process(tstate, stream, part, cols, ts)
        assert np.array_equal(jev, tev)
        assert np.array_equal(np.asarray(jout, dtype=object).astype(str),
                              np.asarray(tout, dtype=object).astype(str))
        n_matches += len(tev)
        assert_engine_state(jstate, te, tstate)
    assert n_matches


@pytest.mark.parametrize("name", ["trailing", "within"])
def test_re_anchor_with_deadlines_pending(name):
    """A batch past the int32 headroom re-anchors both engines with
    deadlines pending: armed deadlines shift with the base, overdue
    ones clamp to 1 and fire on the next tick."""
    je, te = engines(name)
    limit = te._REL_LIMIT
    # anchors that survive the shift (under within 4 sec too), deadlines
    # that clamp, shift, and stay ahead of the batch; the batch crosses
    # the limit (under within a short one: later events would expire
    # every row)
    host = seeded_state(te, seed=3, first_lo=limit - 4_000,
                        first_hi=limit - 3_000,
                        deadlines=(limit - 9_000, limit - 3_000, limit + 500))
    jstate, tstate = start_both(je, te, host, 0)
    lo = limit - (500 if te.within_ms else 4_000)
    ts = np.arange(lo, limit + 1_000, 500, dtype=np.int64)
    part = (np.arange(len(ts)) % 8).astype(np.int32)
    cols = {"k": np.zeros(len(ts), np.int64), "u": np.full(len(ts), 1.0),
            "v": np.full(len(ts), 1.0)}
    jstate, jev, _ = je.process(jstate, "S", part, cols, ts)
    tstate, tev, _ = te.process(tstate, "S", part, cols, ts)
    assert te.base_ts == je.base_ts > 0 and np.array_equal(jev, tev)
    dl = state_to_numpy(te, tstate)[0]["deadline"]
    assert (dl == 1).any() and (dl > 1).any()
    assert_engine_state(jstate, te, tstate)
    fired = 0
    for now in (int(ts[-1]) + 1, int(ts[-1]) + 10_000):
        jstate, jf = je.on_time_state(jstate, now)
        tstate, tf = te.on_time_state(tstate, now)
        fired += same_fired(jf, tf)
        assert_engine_state(jstate, te, tstate)
    assert fired or name == "within"


def test_next_wakeup_is_the_earliest_armed_deadline():
    je, te = engines("trailing")
    host = seeded_state(te, seed=5)
    jstate, tstate = start_both(je, te, host, 1000)
    assert te.next_wakeup_state(tstate) == je.next_wakeup_state(jstate) \
        == 1000 + min(DEADLINES)
    host["deadline"][:] = 0
    jstate, tstate = start_both(je, te, host, 1000)
    assert te.next_wakeup_state(tstate) is None
    te.base_ts = None
    assert te.next_wakeup_state(tstate) is None


# -- what stays refused ------------------------------------------------------

@pytest.mark.parametrize("app,reason", [
    ("from not Stream1[price>20] for 1 sec -> e2=Stream2[price>20] "
     "select e2.price as p", "leading absent 'for' deadline"),
    ("from e1=Stream1[price>20], not Stream2[price>e1.price] for 1 sec "
     "select e1.price as p", "absent states in sequences"),
    ("from every (e1=Stream1[price>20] and not Stream2[price>40]) "
     "select e1.price as p", "every-start logical and-not"),
    ("from e1=Stream1[price>20] -> (e2=Stream1[price>30] and not "
     "Stream1[price>100]) select e1.price as p", "SAME stream"),
    ("from e1=Stream1[price>10] -> not Stream2[price>20] for 1 sec or "
     "e3=Stream3[price>30] select e1.price as p1, e3.price as p3",
     "'or' with an absent side"),
    ("from every (e1=Stream1[price>10] -> not Stream2[price>20] for 1 sec) "
     "select e1.price as p", "group-`every` shape"),
    ("from e1=Stream1[price>20] -> not Stream2[price>e1.price] for 10000 sec "
     "select e1.price as p", "above 2^23 ms"),
    ("from e1=Stream1[price>20] -> not Stream2[price>e1.price] -> "
     "e3=Stream3[price>20] select e1.price as p", "without a 'for'"),
], ids=["leading", "sequence", "every_start_and_not", "same_stream_and_not",
        "or_absent", "group_every", "over_2_23_ms", "no_for"])
def test_host_only_absent_shapes_refused(app, reason):
    """The absent shapes the reference sends to its host engine (the
    ``execution('tpu')`` apps of ``tests/test_dense_absent.py`` and
    ``tests/test_conformance_absent_logical.py`` it keeps there): the
    port's dense engine refuses them with the reference's reason, and
    the app falls back to the host pattern engine with the reference's
    WARNING, giving its rows (the name is the test's from when the port
    refused the app)."""
    text = STREAMS + f"@info(name='q') {app} insert into OutputStream;"
    pattern = (reason.replace("'", ".").replace("(", ".").replace(")", ".")
               .replace("^", "."))
    with pytest.raises(Exception, match=pattern):
        jax_compile(text, "q", n_partitions=4)
    with pytest.raises(SiddhiAppCreationError, match=pattern) as info:
        compile_pattern(text, "q", n_partitions=4, device="cpu")
    assert "ROADMAP" not in str(info.value)
    sends = [("Stream1", ["A", 25.0, 1], 1000), ("Stream2", ["B", 21.0, 1],
                                                 1200),
             ("Stream3", ["C", 35.0, 1], 1300), ("Stream1", ["D", 45.0, 1],
                                                 2600),
             ("Stream3", ["E", 31.0, 1], 2700), ("Tick", [1], 5000),
             ("Stream1", ["F", 22.0, 1], 5100), ("Stream1", ["G", 33.0, 1],
                                                 5200),
             ("Tick", [2], 9000)]

    def go(port):
        mgr = SiddhiManager(device="cpu") if port else JaxManager()
        try:
            with FallbackLog("siddhi_tpu_torch" if port
                             else "siddhi_tpu") as log:
                rt = mgr.create_siddhi_app_runtime(
                    "@app:playback " + TPU + text)
            got = []
            rt.add_callback("OutputStream", lambda evs: got.extend(
                (e.timestamp, list(e.data)) for e in evs))
            rt.start()
            for stream, row, ts in sends:
                rt.get_input_handler(stream).send(row, timestamp=ts)
            low = rt.lowering()
            rt.shutdown()
            return got, low, log.messages
        finally:
            mgr.shutdown()

    got, low, warns = go(True)
    assert (got, low, warns) == go(False)
    assert low == {"q": "host"} and len(warns) == 1 and reason in warns[0]


def test_aggregating_absent_select_refused():
    """``TestPartitionedAggregatingAbsent``'s ``count()`` selector runs
    dense in the reference, and since the host query runtime came to the
    port (``ROADMAP.md`` §1 item 3) in the port too: the timer-fired
    alerts reach the per-key selector through the reverse row -> key
    map, a count per key.  (The name is the test's from when the port
    refused this app.)"""
    app = ("@app:execution('tpu', partitions='16') " + STREAMS
           + "partition with (symbol of Stream1, symbol of Stream2) begin "
           "@info(name='q') from every e1=Stream1[price>20] -> "
           "not Stream2[price>e1.price] for 1 sec "
           "select count() as n insert into OutputStream; end;")
    sends = [("Stream1", ["a", 30.0, 1], 1000),
             ("Stream1", ["b", 40.0, 1], 1200),
             ("Stream2", ["b", 50.0, 1], 1500), ("Tick", [1], 3000),
             ("Stream1", ["a", 35.0, 1], 3500), ("Tick", [2], 5000)]
    jgot, jlow, *_ = run(False, app, sends)
    tgot, tlow, _state, _base, proc = run(True, app, sends)
    assert tgot == jgot == [([1], 2000), ([2], 4500)]
    assert jlow == "dense" and tlow == "dense/general"
    assert proc.time_fires >= 2
