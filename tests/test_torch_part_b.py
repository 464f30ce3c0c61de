"""The port's general dense step, part b (counts, Kleene closures,
logical ``and``/``or``, sequences, non-every heads, whole-chain
group-every), against the JAX package's XLA step.

The same seeded numpy inputs go through the JAX engine (its jitted XLA
step, ``use_kernel = False``) and the port's engine on ``device="cpu"``.
Tolerance 0: the matches, the output bits (the sign of zero and NaN
payloads included) and the whole state (``active``, ``first_ts``,
``counts`` as capture counts and as side bitmasks, ``regs``, ``iregs``
with free lanes' stale values, ``overflow``) must be equal.

The JAX package's ``compile_pattern`` resets a partition on every match
(``reset_on_emit=True``); its product runtime does so only for non-every
heads.  Each engine pair here is built with the same setting.
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
from siddhi_tpu_torch.ops.nfa import ANY
from test_torch_device_query import FallbackLog

DEFINE = "define stream S (k long, u double, v double); "
TWO = ("define stream Tick (sym long, price double); "
       "define stream News (sym long, score double); ")


def engines(app, qname, P, n_instances=4, reset_on_emit=None,
            every_start=None):
    """The JAX engine and the port's, with the same reset and head."""
    je = jax_compile(app, qname, n_partitions=P, n_instances=n_instances,
                     every_start=every_start)
    te = compile_pattern(app, qname, n_partitions=P, n_instances=n_instances,
                         device="cpu", reset_on_emit=reset_on_emit,
                         every_start=every_start)
    je.reset_on_emit = te.reset_on_emit
    assert not je.use_kernel and te.step_kind == "general"
    assert (je.I, je.group_every, je.every_start) == (
        te.I, te.group_every, te.every_start)
    return je, te


def bits(out):
    """A match matrix as comparable bits: float32 lanes by their words,
    object matrices (integer outputs) by value type and float64 bits."""
    if out.dtype == object:
        return [[(type(x).__name__, np.float64(x).tobytes()
                  if isinstance(x, float) else int(x)) for x in row]
                for row in out.tolist()]
    return out.view(np.int32).tolist()


def assert_same_state(jstate, te, tstate):
    host, _base = state_to_numpy(te, tstate)
    assert set(host) == set(jstate)
    for k, v in host.items():
        j = np.asarray(jstate[k])
        assert j.dtype == v.dtype and j.shape == v.shape, k
        assert np.array_equal(j.view(np.uint8), v.view(np.uint8)), k
    return host


def drive(je, te, sends, jstate=None, tstate=None):
    """``sends``: (stream, part, cols, ts) batches through both engines;
    matches after every batch and the final state must be equal.
    Returns the final state and the matches by emit bank."""
    jstate = je.init_state() if jstate is None else jstate
    tstate = te.init_state() if tstate is None else tstate
    n = 0
    for stream, part, cols, ts in sends:
        jstate, jev, jout = je.process(jstate, stream, part, cols, ts)
        tstate, tev, tout = te.process(tstate, stream, part, cols, ts)
        assert np.array_equal(jev, tev), stream
        assert jout.dtype == tout.dtype and jout.shape == tout.shape
        assert bits(jout) == bits(tout)
        n += len(tev)
    return assert_same_state(jstate, te, tstate), n


def seeded_state(engine, seed, within_ms=5_000):
    """A seeded mid-chain state in the engine's layout: about 30% of
    lanes pending with anchors over the last ``within``, counts below
    max at count nodes (some satisfied, so open counts clone) and side
    bitmasks at logical nodes, registers everywhere (free lanes keep
    stale values, as in the reference)."""
    rng = np.random.default_rng(seed)
    host = engine.init_state_host()
    shape = host["active"].shape
    active = rng.random(shape) < 0.3
    active[-1] = False  # scratch row
    host["active"] = active | host["active"]
    host["first_ts"] = np.where(
        active, rng.integers(1, within_ms + 1, shape), 0).astype(np.int32)
    counts = np.zeros(shape, np.int32)
    for s, node in enumerate(engine.nodes):
        if node.kind == "logical":
            hi = (1 << len(node.specs)) - 1  # never every side
            counts[:, s] = rng.integers(0, hi, shape[::2])
        elif not (node.min_count == 1 and node.max_count == 1):
            top = (node.min_count + 2 if node.max_count == ANY
                   else node.max_count)
            counts[:, s] = rng.integers(1, top, shape[::2])
    host["counts"] = np.where(active, counts, 0).astype(np.int32)
    host["regs"] = rng.uniform(0.0, 20.0, host["regs"].shape).astype(
        np.float32)
    if "iregs" in host:
        host["iregs"] = rng.integers(-3, 3, host["iregs"].shape,
                                     dtype=np.int32)
    return host, 1000 - within_ms


def start_both(je, te, host, base_ts):
    jstate = {k: je.jnp.asarray(v) for k, v in host.items()}
    je.base_ts = base_ts
    return jstate, state_from_numpy(te, host, base_ts)


def s_batches(seed, n_batches, B, P, stream="S", dt=40):
    """Seeded ``S (k long, u double, v double)`` batches with colliding
    partitions (several rounds a batch) and ascending times."""
    rng = np.random.default_rng(seed)
    out, t = [], 1000
    for _ in range(n_batches):
        part = rng.integers(0, P, B).astype(np.int32)
        cols = {"k": rng.integers(0, 3, B), "u": rng.uniform(0, 20, B),
                "v": rng.uniform(0, 20, B)}
        ts = t + np.sort(rng.integers(0, dt * B // P + 1, B))
        t = int(ts[-1])
        out.append((stream, part, cols, ts))
    return out


# the part-b shapes of tests/test_dense_differential_fuzz.py:100-116,
# with its whole-chain group-every shape (:155-159)
FUZZ_SHAPES = {
    "exact_count": (
        "@info(name='q') from every a=S[v > 8.0]<2> -> b=S[v < 4.0] "
        "within 5 sec select a[0].v as a0, a[last].v as a1, b.v as bv "
        "insert into Alerts;"),
    "open_count": (
        "@info(name='q') from every a=S[v > 12.0]<1:> -> b=S[v < 4.0] "
        "within 5 sec select a[0].v as a0, b.v as bv insert into Alerts;"),
    "bounded_count": (
        "@info(name='q') from a=S[v > 8.0]<2:4> -> b=S[v < 4.0] "
        "within 5 sec select a[0].v as a0, b.v as bv insert into Alerts;"),
    "sequence_pair": (
        "@info(name='q') from every a=S[v > 10.0], b=S[v > a.v] "
        "select a.v as av, b.v as bv insert into Alerts;"),
    "non_every": (
        "@info(name='q') from a=S[v > 10.0] -> b=S[v > a.v] "
        "select a.v as av, b.v as bv insert into Alerts;"),
    "group_every": (
        "@info(name='q') from every (a=S[v > 8.0] -> b=S[v > a.v]) "
        "within 2 sec select a.v as av, b.v as bv insert into Alerts;"),
}


def fuzz_stream(seed, n=60, dt_max=400):
    """``tests/test_dense_differential_fuzz.py``'s ``gen_stream``."""
    rng = np.random.default_rng(seed)
    ts = 1000 + np.cumsum(rng.integers(1, dt_max, size=n))
    ks = rng.integers(0, 3, size=n)
    us = rng.uniform(0.0, 20.0, size=n).round(1)
    vs = rng.uniform(0.0, 20.0, size=n).round(1)
    return [("S", [int(k), float(u), float(v)], int(t))
            for k, u, v, t in zip(ks, us, vs, ts)]


def run_app(port, app, sends, header="@app:playback "
            "@app:execution('tpu', instances='16') ", out="Alerts"):
    """``sends`` (stream, row, ts) through a package's ``SiddhiManager``:
    the callback's (timestamp, row) lists and the lowering."""
    mgr = SiddhiManager(device="cpu") if port else JaxManager()
    try:
        rt = mgr.create_siddhi_app_runtime(header + app)
        got = []
        rt.add_callback(out, lambda evs: got.append(
            [(e.timestamp, list(e.data)) for e in evs]))
        rt.start()
        for stream, row, ts in sends:
            rt.get_input_handler(stream).send(list(row), timestamp=ts)
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
    jgot, jlow = run_app(False, DEFINE + FUZZ_SHAPES[shape], sends)
    tgot, tlow = run_app(True, DEFINE + FUZZ_SHAPES[shape], sends)
    assert jlow == {"q": "dense"} and tlow == {"q": "dense/general"}
    assert tgot == jgot


# engine-level apps over S: every class of part b, with the mid-chain
# seeded state and colliding partitions
ENGINE_APPS = {
    # an open count on the head, via-path into the last node (bank 1)
    "kleene_head": (
        "every a=S[v > 6.0]<1:3> -> b=S[v < 6.0 and u > a[last].v] "
        "within 5 sec select a[0].v as a0, a[last].v as al, b.v as bv"),
    # an open count mid-chain: via-path then placement at node 2
    "open_mid": (
        "every a=S[v > 12.0] -> b=S[v > 5.0]<2:> -> c=S[u > b[last].v] "
        "within 5 sec select a.v as av, b[0].v as b0, b[last].v as bl, "
        "c.u as cu"),
    # an exact count mid-chain: advance at min == max
    "exact_mid": (
        "every a=S[v > 10.0] -> b=S[v > a.v]<2> -> c=S[u > 10.0] "
        "within 5 sec select a.v as av, b[0].v as b0, b[last].v as bl"),
    # an open bounded count on the last node: emits at min, releases at
    # max
    "count_last": (
        "every a=S[v > 15.0] -> b=S[v > a.v]<2:4> within 5 sec "
        "select a.v as av, b[0].v as b0, b[last].v as bl"),
    # integer captures through a count ([last] on iregs)
    "int_count": (
        "every a=S[v > 14.0]<2:3> -> b=S[k == a[last].k] within 5 sec "
        "select a[0].k as a0, a[last].k as al, b.v as bv"),
    # one event fills both sides of a same-stream `and`
    "and_same_stream": (
        "every a=S[v > 4.0] -> (b=S[v > a.v] and c=S[u > 10.0]) "
        "within 5 sec select a.v as av, b.v as bv, c.u as cu"),
    # `or` takes the first matching side
    "or_mid": (
        "every a=S[v > 12.0] -> (b=S[v < 3.0] or c=S[u > 17.0]) "
        "-> d=S[v > a.v] within 5 sec "
        "select a.v as av, b.v as bv, c.u as cu, d.v as dv"),
    "or_head": (
        "every (a=S[v > 18.0] or b=S[u > 18.0]) -> c=S[v < 2.0] "
        "within 5 sec select a.v as av, b.u as bu, c.v as cv"),
    "sequence_count": (
        "every a=S[v > 10.0], b=S[v > 5.0]<1:3>, c=S[u > 2.0] within 5 sec "
        "select a.v as av, b[last].v as bl, c.u as cu"),
    "sequence_triple": (
        "every a=S[v > 4.0], b=S[v > a.v], c=S[v > b.v] within 5 sec "
        "select a.v as av, b.v as bv, c.v as cv"),
    "non_every_count": (
        "a=S[v > 8.0]<2:3> -> b=S[v < 4.0] within 5 sec "
        "select a[0].v as a0, a[last].v as al, b.v as bv"),
    "group_every": (
        "every (a=S[v > 8.0] -> b=S[v > a.v] -> c=S[u > 9.0]) "
        "within 5 sec select a.v as av, b.v as bv, c.u as cu"),
}


@pytest.mark.parametrize("reset_on_emit", [None, True],
                         ids=["runtime", "jax_compile_pattern"])
@pytest.mark.parametrize("name", sorted(ENGINE_APPS))
def test_engine_apps_from_mid_chain_state(name, reset_on_emit):
    """Each class at the engine level, from a seeded mid-chain state
    (counts below max, side bitmasks, stale registers), at 8
    partitions with colliding events: matches, output bits and the
    whole state."""
    app = (DEFINE + "@info(name='q') from " + ENGINE_APPS[name]
           + " insert into Alerts;")
    je, te = engines(app, "q", P=8, reset_on_emit=reset_on_emit)
    host, base_ts = seeded_state(te, seed=len(name))
    jstate, tstate = start_both(je, te, host, base_ts)
    sends = s_batches(len(name) + 100, 3, 96, 8)
    host, n = drive(je, te, sends, jstate, tstate)
    assert n > 0


def test_non_every_head_arms_node_zero_once():
    """A non-every head arms node 0, lane 0, of every partition (the
    scratch row too), as the reference's initial state does."""
    app = DEFINE + ("@info(name='q') from a=S[v > 8.0] -> b=S[v > a.v] "
                    "select b.v as bv insert into Alerts;")
    je, te = engines(app, "q", P=5)
    jhost, thost = je.init_state_host(), te.init_state_host()
    assert te.I == 1 and thost["active"][:, 0, 0].all()
    for k in jhost:
        assert np.array_equal(jhost[k], thost[k]), k
    assert np.array_equal(te.init_state()["active"].numpy(), thost["active"])


# tests/test_dense_nfa.py's apps (TestDenseFraud, TestDenseSequence,
# TestDenseNonEverySequence), at the engine level
FRAUD_APP = (
    "define stream Txn (card long, amount double); "
    "@info(name='fraud') "
    "from every a=Txn[amount > 100.0] -> b=Txn[amount > a.amount]<3:5> "
    "within 10 min "
    "select a.amount as base, b[0].amount as b0, b[last].amount as blast "
    "insert into Alerts;"
)
KLEENE_APP = (
    "define stream Login (user long, ok int); "
    "@info(name='bf') "
    "from every f=Login[ok == 0]<3:100> -> s=Login[ok == 1] within 1 min "
    "select f[0].ok as f0, s.ok as sk insert into Alerts;"
)
AND_APP = (
    TWO + "@info(name='an') "
    "from t=Tick[price > 10.0] and n=News[score > 0.5] within 5 sec "
    "select t.price as p, n.score as sc insert into Alerts;"
)
SEQ_APP = (
    "define stream Ticks (key long, price double); "
    "@info(name='seq3') "
    "from every e1=Ticks[price > 10.0], e2=Ticks[price > e1.price], "
    "e3=Ticks[price > e2.price] within 1 sec "
    "select e1.price as p1, e2.price as p2, e3.price as p3 "
    "insert into Alerts;"
)
NE_SEQ_APP = SEQ_APP.replace("from every e1", "from e1").replace(
    "'seq3'", "'ne'")


def sends_of(stream, rows, key, col, ts=None):
    """``(key, value[, ts])`` rows -> one engine batch."""
    part = np.asarray([r[0] for r in rows])
    cols = {col: np.asarray([float(r[1]) for r in rows]),
            key: np.asarray([r[0] for r in rows])}
    if ts is None:
        ts = np.asarray([r[2] for r in rows], dtype=np.int64)
    return (stream, part, cols, ts)


@pytest.mark.parametrize("rows,n", [
    ([(0, 150.0, 1000), (0, 200.0, 2000), (0, 50.0, 2500),
      (0, 250.0, 3000), (0, 300.0, 4000)], (1, 1)),
    ([(0, 150.0, 1000), (0, 200.0, 2000), (0, 250.0, 700_000),
      (0, 260.0, 701_000), (0, 270.0, 702_000), (0, 280.0, 703_000)],
     (1, 1)),
    ([(3, 150.0, 1000), (7, 500.0, 1100), (3, 200.0, 1200),
      (7, 100.0, 1300), (3, 250.0, 1400), (7, 90.0, 1500),
      (3, 300.0, 1600), (7, 80.0, 1700)], (1, 1)),
    # a=150 completes at 300 and a=200 at 350, unless the first match
    # resets the partition
    ([(1, a, 1000 + i) for i, a in enumerate([150.0, 200.0, 250.0, 300.0,
                                              350.0])], (2, 1)),
], ids=["single_partition", "within_expiry", "isolation", "collisions"])
@pytest.mark.parametrize("reset_on_emit", [None, True],
                         ids=["runtime", "jax_compile_pattern"])
def test_dense_fraud_apps(rows, n, reset_on_emit):
    """``tests/test_dense_nfa.py`` ``TestDenseFraud``: the fraud app
    (``every a -> b<3:5> within 10 min``, BASELINE config 2); ``n``:
    the matches without and with reset on emit."""
    je, te = engines(FRAUD_APP, "fraud", P=16, reset_on_emit=reset_on_emit)
    _host, got = drive(je, te, [sends_of("Txn", rows, "card", "amount")])
    assert got == n[reset_on_emit is True]


def test_dense_brute_force_kleene():
    """``TestDenseFraud.test_brute_force_kleene`` (BASELINE config 3):
    user 5's three fails then a success emit through bank 1 (the
    via-path clone of the open count); user 9's two fails do not."""
    je, te = engines(KLEENE_APP, "bf", P=32)
    rows = [(5, 0), (9, 0), (5, 0), (9, 0), (5, 0), (5, 1), (9, 1)]
    ts = np.arange(1000, 1000 + len(rows), dtype=np.int64) * 10
    batch = ("Login", np.asarray([r[0] for r in rows]),
             {"ok": np.asarray([r[1] for r in rows]),
              "user": np.asarray([r[0] for r in rows])}, ts)
    host, n = drive(je, te, [batch])
    assert n == 1
    _s, pending = te.process_deferred(te.init_state(), *batch)
    pending.resolve()
    assert sum(int(p.emit[:, te.I:].sum()) for p in pending.parts) == 1


def test_dense_logical_and_two_streams():
    """``TestDenseFraud.test_logical_and_two_streams``: ``Tick and News``
    compiled with the ``every_start`` override, one stream a batch."""
    je, te = engines(AND_APP, "an", P=8, every_start=True)
    sends = [
        ("Tick", np.asarray([2]), {"price": np.asarray([20.0])},
         np.asarray([1000])),
        ("News", np.asarray([2]), {"score": np.asarray([0.9])},
         np.asarray([2000])),
        ("Tick", np.asarray([4]), {"price": np.asarray([20.0])},
         np.asarray([10_000])),
        ("News", np.asarray([4]), {"score": np.asarray([0.9])},
         np.asarray([20_000])),
    ]
    _host, n = drive(je, te, sends)
    assert n == 1


def two_stream_batches(seed, n_batches, P, b_tick=48, b_news=16, dt=500):
    """Alternating ``Tick`` and ``News`` batches, each covering the next
    ``dt`` ms with non-decreasing times."""
    rng = np.random.default_rng(seed)
    out, t = [], 1000
    for i in range(n_batches):
        stream, B = ("Tick", b_tick) if i % 2 == 0 else ("News", b_news)
        part = rng.integers(0, P, B).astype(np.int32)
        ts = t + np.sort(rng.integers(0, dt, B))
        if stream == "Tick":
            cols = {"sym": part.astype(np.int64),
                    "price": rng.uniform(1.0, 20.0, B)}
        else:
            cols = {"sym": part.astype(np.int64),
                    "score": rng.uniform(0.0, 1.0, B)}
        out.append((stream, part, cols, ts))
        t += dt
    return out


@pytest.mark.parametrize("op", ["and", "or"])
def test_every_logical_two_streams_from_mid_chain_state(op):
    """BASELINE config 4's shape, ``every (t=Tick[...] and|or
    n=News[...]) within 5 sec``: one logical node (S = 1), side bitmasks
    in ``counts``, from a seeded state, over alternating batches."""
    app = (TWO + f"@info(name='q') from every (t=Tick[price > 10.0] {op} "
           "n=News[score > 0.5]) within 5 sec "
           "select t.price as p, n.score as sc insert into Alerts;")
    je, te = engines(app, "q", P=8)
    assert te.S == 1 and te.nodes[0].kind == "logical"
    host, base_ts = seeded_state(te, seed=5)
    jstate, tstate = start_both(je, te, host, base_ts)
    host, n = drive(je, te, two_stream_batches(6, 6, 8), jstate, tstate)
    assert n > 0 and host["counts"].any()


@pytest.mark.parametrize("rows,n", [
    ([(0, 11.0, 100), (0, 12.0, 200), (0, 13.0, 300)], 1),
    ([(0, 11.0, 100), (0, 12.0, 200), (0, 5.0, 300), (0, 20.0, 400),
      (0, 21.0, 500), (0, 22.0, 600)], 1),
    ([(0, 11.0, 100), (0, 12.0, 200), (0, 13.0, 5000)], 0),
    ([(0, 11.0, 100), (1, 50.0, 150), (0, 12.0, 200), (1, 51.0, 250),
      (0, 13.0, 300), (1, 52.0, 350)], 2),
    ([(0, float(p), 100 * (i + 1)) for i, p in enumerate(
        np.random.default_rng(11).uniform(5.0, 30.0, 40).round(1))], None),
], ids=["rising_triple", "interruption", "within", "isolation",
        "randomized"])
@pytest.mark.parametrize("app", ["every", "non_every"])
def test_dense_sequences(rows, n, app):
    """``tests/test_dense_nfa.py`` ``TestDenseSequence`` (BASELINE
    config 1's ``e1, e2, e3 within 1 sec``) and
    ``TestDenseNonEverySequence`` (arms once; an interruption kills it
    and nothing re-arms)."""
    text, name = (SEQ_APP, "seq3") if app == "every" else (NE_SEQ_APP, "ne")
    je, te = engines(text, name, P=8, reset_on_emit=True)
    _host, got = drive(je, te, [sends_of("Ticks", rows, "key", "price")])
    if n is not None and app == "every":
        assert got == n


def test_non_every_sequence_dies_after_interruption():
    je, te = engines(NE_SEQ_APP, "ne", P=4)
    rows = [(0, 11.0, 100), (0, 5.0, 200), (0, 20.0, 300), (0, 21.0, 400),
            (0, 22.0, 500), (0, 23.0, 600)]
    host, n = drive(je, te, [sends_of("Ticks", rows, "key", "price")])
    assert n == 0 and not host["active"][0].any()


# tests/test_every_instances.py:93-206 (counts, logical nodes, a
# sequence) and :293-312 (instance overflow), through both packages'
# SiddhiManager
EVERY_DEF = "define stream S (k double, v double); "
EVERY_CASES = {
    "every_exact_count_pairs": (
        EVERY_DEF + "@info(name='q') from every a=S[v > 0.0]<2> -> "
        "b=S[v < 0.0] within 10 min select a[0].v as a0, a[last].v as a1, "
        "b.v as bv insert into Alerts;",
        [("S", [0.0, x], 1000 + 100 * i)
         for i, x in enumerate([1.0, 2.0, 3.0, 4.0, -1.0])],
        [[1.0, 2.0, -1.0], [3.0, 4.0, -1.0]]),
    "open_count_clones_per_success": (
        "define stream Login (user double, ok double); "
        "@info(name='q') from every f=Login[ok < 1.0]<1:> "
        "-> s=Login[ok > 0.0] within 10 min "
        "select f[0].ok as fo, s.ok as so insert into Alerts;",
        [("Login", [1.0, x], 1000 + 100 * i)
         for i, x in enumerate([0.0, 0.5, 2.0, 3.0, 0.0, 4.0])], None),
    "open_count_bounded_moves_at_max": (
        EVERY_DEF + "@info(name='q') from a=S[v > 0.0]<2:3> -> b=S[v < 0.0] "
        "within 10 min select a[0].v as a0, b.v as bv insert into Alerts;",
        [("S", [0.0, x], 1000 + 100 * i)
         for i, x in enumerate([1.0, 2.0, 3.0, -1.0])], None),
    "open_count_last_ref_same_stream_clone": (
        EVERY_DEF + "@info(name='q') from every a=S[v > 0.0]<1:> -> "
        "b=S[v > 10.0] within 10 min select a[0].v as a0, "
        "a[last].v as al, b.v as bv insert into Alerts;",
        [("S", [0.0, x], 1000 + 100 * i)
         for i, x in enumerate([1.0, 2.0, 15.0, 20.0])], None),
    "logical_repeat_side_ignored": (
        "define stream A (x double); define stream B (y double); "
        "@info(name='q') from every (a=A[x > 0.0] and b=B[y > 0.0]) "
        "within 1 sec select a.x as ax, b.y as by insert into Alerts;",
        [("A", [1.0], 100), ("A", [2.0], 800), ("B", [3.0], 1500),
         ("A", [1.0], 3100), ("A", [2.0], 3800), ("B", [3.0], 3900)],
        [[1.0, 3.0]]),
    "logical_and_every_overlap": (
        "define stream A (x double); define stream B (y double); "
        "define stream C (z double); "
        "@info(name='q') from every (a=A[x > 0.0] and b=B[y > 0.0]) "
        "-> c=C[z > 0.0] within 10 min "
        "select a.x as ax, b.y as by, c.z as cz insert into Alerts;",
        [("A", [1.0], 1000), ("B", [2.0], 1100), ("A", [3.0], 1200),
         ("B", [4.0], 1300), ("C", [5.0], 1400)], None),
    "sequence_keeps_single_instance": (
        EVERY_DEF + "@info(name='q') from every a=S[v > 100.0], "
        "b=S[v > a.v] select a.v as av, b.v as bv insert into Alerts;",
        [("S", [0.0, x], 1000 + 100 * i)
         for i, x in enumerate([500.0, 600.0, 700.0])], None),
}


@pytest.mark.parametrize("case", sorted(EVERY_CASES))
def test_every_instances_cases(case):
    app, sends, want = EVERY_CASES[case]
    header = "@app:playback @app:execution('tpu') "
    jgot, jlow = run_app(False, app, sends, header)
    tgot, tlow = run_app(True, app, sends, header)
    assert jlow == {"q": "dense"} and tlow == {"q": "dense/general"}
    assert tgot == jgot and tgot
    if want is not None:
        assert [row for b in tgot for _ts, row in b] == want


@pytest.mark.parametrize("instances,dropped", [(2, 2), (4, 0)])
def test_instance_overflow_counts_as_reference(instances, dropped):
    """``TestInstanceCapacity`` over a count: with two lanes the third
    arm is dropped at node 0 and again at node 1, counted in the port's
    state as in the reference's; four lanes drop nothing."""
    app = EVERY_DEF + (
        "@info(name='q') from every a=S[v > 100.0] -> b=S[v > a.v]<1:2> "
        "within 10 min select a.v as av, b[0].v as bv insert into Alerts;")
    sends = [("S", [0.0, x], 1000 + 100 * i)
             for i, x in enumerate([500.0, 400.0, 300.0, 600.0])]
    header = f"@app:playback @app:execution('tpu', instances='{instances}') "
    runs = []
    for port in (False, True):
        mgr = SiddhiManager(device="cpu") if port else JaxManager()
        rt = mgr.create_siddhi_app_runtime(header + app)
        got = []
        rt.add_callback("Alerts", lambda evs, got=got: got.extend(
            (e.timestamp, list(e.data)) for e in evs))
        rt.start()
        for stream, row, ts in sends:
            rt.get_input_handler(stream).send(row, timestamp=ts)
        if port:
            ovf = rt.pattern_runtimes()["q"].overflow_total()
        else:
            ovf = next(iter(rt.query_runtimes.values())
                       ).pattern_processor.overflow_total()
        rt.shutdown()
        mgr.shutdown()
        runs.append((got, ovf))
    assert runs[0] == runs[1] and runs[1][1] == dropped and runs[1][0]


PARTITIONED_TWO = (
    TWO + "partition with (sym of Tick, sym of News) begin "
    "@info(name='q') from every (t=Tick[price > 10.0] and "
    "n=News[score > 0.5]) within 5 sec "
    "select t.price as p, n.score as sc insert into Alerts; end;")


def test_partitioned_logical_app_over_two_streams():
    """``partition with (sym of Tick, sym of News)`` over a two-stream
    ``and``: each stream reaches the one engine through its own
    receiver, and the rows are the reference's."""
    rng = np.random.default_rng(9)
    sends = []
    for i in range(240):
        sym = int(rng.integers(0, 12))
        if rng.random() < 0.6:
            sends.append(("Tick", [sym, round(float(rng.uniform(1, 20)), 1)],
                          1000 + 40 * i))
        else:
            sends.append(("News", [sym, round(float(rng.uniform(0, 1)), 2)],
                          1000 + 40 * i))
    header = "@app:playback @app:execution('tpu', partitions='16') "
    jgot, jlow = run_app(False, PARTITIONED_TWO, sends, header)
    tgot, tlow = run_app(True, PARTITIONED_TWO, sends, header)
    assert tlow == {"q": "dense/general"}
    assert tgot == jgot and sum(map(len, tgot)) > 10
    rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(
        header + PARTITIONED_TWO)
    assert rt.pattern_runtimes()["q"].engine.stream_keys == ["Tick", "News"]


def test_output_types_of_count_refs():
    """``f[0].ok`` (INT) and ``b[last].amount`` (DOUBLE) reach the
    callback with their source types, as in the reference."""
    app = ("define stream Login (user long, ok int, amount double); "
           "partition with (user of Login) begin @info(name='q') from "
           "every f=Login[ok == 0]<2> -> b=Login[ok == 1]<1:2> "
           "-> s=Login[amount > f[last].amount] within 1 min "
           "select f[0].ok as f0, f[last].amount as fa, "
           "b[last].amount as ba, s.ok as sk insert into Alerts; end;")
    rng = np.random.default_rng(3)
    sends = [("Login", [int(rng.integers(0, 3)), int(rng.random() < 0.4),
                        round(float(rng.uniform(0, 10)), 1)], 1000 + 10 * i)
             for i in range(150)]
    header = "@app:playback @app:execution('tpu', partitions='4') "
    jgot, _ = run_app(False, app, sends, header)
    tgot, tlow = run_app(True, app, sends, header)
    assert tlow == {"q": "dense/general"} and tgot == jgot and tgot
    rows = [row for b in tgot for _ts, row in b]
    assert all(type(r[0]) is int and type(r[3]) is int for r in rows)
    assert all(type(r[1]) is float and type(r[2]) is float for r in rows)


@pytest.mark.parametrize("app", [
    # the second side of a logical node
    "every (a=T[v > 8.0] and b=T[v > 1.0 and sym == 'IBM']) "
    "select a.v as av",
    # a filter that the via-path evaluates against the open count's
    # registers
    "every a=T[v > 8.0]<1:> -> b=T[v > a[last].v and sym == 'IBM'] "
    "select b.v as bv",
], ids=["logical_side", "via_path"])
def test_a_bad_part_b_filter_fails_at_plan_time(app):
    text = ("@app:execution('tpu') define stream T (sym string, v double); "
            f"@info(name='q') from {app} insert into Alerts;")
    with FallbackLog("siddhi_tpu_torch") as log:
        rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(text)
    # the plan-time trace refuses it; the host pattern engine runs it
    assert rt.lowering() == {"q": "host"}
    assert len(log.messages) == 1 and "not traceable" in log.messages[0]
    ok = text.replace(" and sym == 'IBM'", "")
    rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(ok)
    assert rt.lowering(step_kinds=True) == {"q": "dense/general"}
