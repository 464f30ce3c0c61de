"""The dense product path's adaptive depths, engine introspection and the
single-key scan engine, held against the JAX package.

- ``emit.depth='auto'``/``ingest.depth='auto'``: the depth controller's
  arithmetic on injected times (``tests/test_ingest_pipeline.py``'s
  ``TestAutoEmitDepth``), and apps at staged and adaptive depths on the
  device query path, the dense path (general and batch steps) and the
  skew router, whose callbacks must equal the JAX package's and the
  port's own depth-1 run, batch by batch;
- the barriers: a timer-fired pane and a snapshot in the middle of a
  staged stream;
- ``pattern_state()`` (the dense runtime's and the router's ``stats()``,
  the host engine's) equal to the JAX package's;
- ``compile_scan_pattern(..., device="cpu")`` against the JAX
  ``ScanPatternEngine`` on ``tests/test_nfa_scan.py``'s cases: the same
  detections and starts, live state lanes bit-equal, dead lanes at or
  below ``NEG / 2``, chunked or not.

Shapes are tiny: at most 64 partitions, chains of at most 4 nodes (5 in
one of ``tests/test_nfa_scan.py``'s fuzz cases, replayed as it is), a
few hundred events a run (2,000 in one scan case).
"""

import numpy as np
import pytest

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.core.emit_queue import EmitDepthController as JaxController
from siddhi_tpu.core.event import EventBatch as JaxEventBatch
from siddhi_tpu.ops.nfa_scan import compile_scan_pattern as jax_scan_pattern
from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.core.dense_pattern import DensePatternRuntime
from siddhi_tpu_torch.core.device_single import DeviceQueryRuntime
from siddhi_tpu_torch.core.emit_queue import EmitDepthController
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.ops.nfa_scan import NEG, compile_scan_pattern

DEFINE = "define stream S (k long, v double); "
FILTER_APP = DEFINE + ("@info(name='q') from S[v > 20.0] select k, v, "
                       "v * 2.0 as dbl insert into OutputStream;")
AGG_APP = DEFINE + ("@info(name='q') from S#window.length(4) "
                    "select k, sum(v) as s group by k "
                    "insert into OutputStream;")
PATTERN_APP = DEFINE + (
    "@info(name='q') from every e1=S[v > 50.0] -> e2=S[v > e1.v] "
    "within 10 sec select e1.v as a, e2.v as b insert into OutputStream;")
TIMEBATCH_APP = DEFINE + (
    "@info(name='q') from S#window.timeBatch(1 sec) select k, sum(v) as s "
    "group by k insert into OutputStream;")


def series(n, seed, n_keys=4, t0=1000, dt_max=400):
    """``tests/test_ingest_pipeline.py``'s series: (row, ts) sends."""
    rng = np.random.default_rng(seed)
    ts = t0 + np.cumsum(rng.integers(1, dt_max, size=n))
    keys = rng.integers(0, n_keys, size=n)
    vals = rng.integers(1, 100, size=n).astype(float)
    return [([int(k), float(v)], int(t)) for k, v, t in zip(keys, vals, ts)]


def device_runtime(rt):
    qr = next(iter(rt.query_runtimes.values()))
    return (getattr(qr, "device_runtime", None)
            or getattr(qr, "pattern_processor", None))


def run_app(port, app, sends, exec_opts=None, mid=None):
    """A playback run of ``app`` -> (rows, device runtime, pattern_state,
    ``mid(runtime)``'s value after the first half of the sends).
    ``exec_opts`` is the option tail of ``@app:execution('tpu'...)``;
    None runs the host engine."""
    header = "@app:playback "
    if exec_opts is not None:
        header += f"@app:execution('tpu'{exec_opts}) "
    m = SiddhiManager(device="cpu") if port else JaxManager()
    try:
        rt = m.create_siddhi_app_runtime(header + app)
        got = []
        rt.add_callback("OutputStream", lambda evs: got.extend(
            (e.timestamp, tuple(e.data)) for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        at_mid = None
        for i, (row, ts) in enumerate(sends):
            if mid is not None and i == len(sends) // 2:
                at_mid = (list(got), mid(device_runtime(rt)))
            h.send(row, timestamp=ts)
        runtime = device_runtime(rt)
        state = rt.pattern_state()
        rt.shutdown()
        return got, runtime, state, at_mid
    finally:
        m.shutdown()


# -- the depth controller ------------------------------------------------------


@pytest.mark.parametrize("cls", [EmitDepthController, JaxController],
                         ids=["port", "jax"])
class TestAutoEmitDepth:
    def test_controller_converges_to_rtt_over_cadence(self, cls):
        c = cls()
        t = 0.0
        for _ in range(50):
            c.note_push(t)
            t += 0.001
            c.note_drain(0.0042)
        assert c.effective_depth == 5  # ceil(4.2 ms rtt / 1 ms gap)

    def test_controller_never_exceeds_bound(self, cls):
        c = cls()
        c.note_push(0.0)
        c.note_push(0.001)
        c.note_drain(60.0)
        assert c.effective_depth == cls.AUTO_DEPTH_MAX == 32

    def test_controller_floors_at_sync(self, cls):
        c = cls()
        c.note_push(0.0)
        c.note_push(10.0)
        c.note_drain(0.0001)
        assert c.effective_depth == 1


def test_controller_tracks_the_reference_step_by_step():
    """The same injected pushes and drains give the same depth after
    every sample (seeded cadence and round trips)."""
    rng = np.random.default_rng(5)
    a, b = EmitDepthController(), JaxController()
    t = 0.0
    for _ in range(300):
        t += float(rng.exponential(0.002))
        a.note_push(t)
        b.note_push(t)
        if rng.random() < 0.5:
            rtt = float(rng.exponential(0.01))
            a.note_drain(rtt)
            b.note_drain(rtt)
        assert a.effective_depth == b.effective_depth


# -- staged and adaptive depths ------------------------------------------------


def depth_differential(app, sends, opts, extra="", ordered=True):
    """JAX at ``opts`` == port at depth 1 == port at ``opts`` (rows and
    timestamps), and their rows == the host engine's (the reference's
    test; a device pane's timestamps are its own); returns the port's
    runtime at ``opts``."""
    host, *_ = run_app(False, app, sends)
    jgot, *_ = run_app(False, app, sends, exec_opts=extra + opts)
    sync, rt1, *_ = run_app(True, app, sends, exec_opts=extra)
    got, rt, *_ = run_app(True, app, sends, exec_opts=extra + opts)
    assert rt1 is not None and rt is not None, "no device lowering"
    assert len(rt.ingest_stage) == 0, "shutdown left staged batches"
    if not ordered:
        host, jgot, sync, got = map(sorted, (host, jgot, sync, got))
    assert sync == jgot
    assert got == jgot, "the depths changed callback content or order"
    data = lambda rows: [r for _ts, r in rows]
    if not ordered:
        host, got = sorted(data(host)), sorted(data(got))
    else:
        host, got = data(host), data(got)
    assert got == host
    return rt


class TestStagedAndAdaptiveDepths:
    def test_device_filter_staged(self):
        rt = depth_differential(FILTER_APP, series(120, seed=21),
                                ", ingest.depth='2'")
        assert isinstance(rt, DeviceQueryRuntime)
        st = rt.ingest_stats
        assert st.staged_batches == 120 and st.max_staging_depth == 2
        assert st.device_puts > 0 and st.flush_syncs > 0
        # every non-barrier finish is an overlap or a stall (on the CPU
        # every step has finished: overlaps)
        assert st.overlapped_batches + st.ingest_stalls == 119
        assert st.as_dict()["overlappedBatches"] == st.overlapped_batches

    def test_grouped_window_staged(self):
        rt = depth_differential(AGG_APP, series(150, seed=22, n_keys=5),
                                ", ingest.depth='2'")
        assert rt.ingest_stats.staged_batches > 0

    def test_staging_composes_with_deep_emit(self):
        rt = depth_differential(FILTER_APP, series(160, seed=23),
                                ", ingest.depth='3', emit.depth='4'")
        assert rt.ingest_stats.max_staging_depth == 3
        assert rt.emit_stats.deferred_batches > 0

    def test_auto_emit_depth(self):
        rt = depth_differential(FILTER_APP, series(150, seed=41),
                                ", emit.depth='auto'")
        assert rt.emit_queue.controller is not None
        assert 1 <= rt.emit_queue.depth <= EmitDepthController.AUTO_DEPTH_MAX
        assert rt.emit_stats.auto_depth >= 1
        assert (rt.emit_stats.max_pending_depth
                <= EmitDepthController.AUTO_DEPTH_MAX)
        assert rt.emit_stats.as_dict()["autoEffectiveDepth"] >= 1

    def test_auto_depth_with_staged_ingest(self):
        rt = depth_differential(AGG_APP, series(150, seed=42, n_keys=5),
                                ", ingest.depth='2', emit.depth='auto'")
        assert rt.ingest_stats.staged_batches > 0
        assert rt.emit_queue.controller is not None

    def test_auto_ingest_depth(self):
        rt = depth_differential(AGG_APP, series(150, seed=43, n_keys=5),
                                ", ingest.depth='auto', emit.depth='auto'")
        assert rt.ingest_stage.controller is not None
        assert rt.ingest_stats.auto_depth >= 1

    @pytest.mark.parametrize("opts", [", ingest.depth='2'",
                                      ", ingest.depth='2', emit.depth='auto'",
                                      ", ingest.depth='auto', "
                                      "emit.depth='auto'"])
    def test_dense_pattern(self, opts):
        rt = depth_differential(PATTERN_APP, series(120, seed=24),
                                opts, extra=", instances='32'")
        assert isinstance(rt, DensePatternRuntime)
        assert rt.engine.step_kind == "general"
        st = rt.ingest_stats
        assert st.staged_batches == 120
        assert st.overlapped_batches + st.ingest_stalls > 0

    def test_timer_fire_barrier_staged(self):
        """timeBatch panes close on timer fires: the fire must flush the
        stage before the emit queue, or panes shift by batches."""
        depth_differential(TIMEBATCH_APP, series(150, seed=26),
                           ", ingest.depth='3'", ordered=False)

    def test_snapshot_midstream_is_a_barrier(self):
        """A snapshot in the middle of a staged stream drains first: the
        callbacks so far and the snapshot equal the depth-1 run's."""
        sends = series(100, seed=27)

        def snap(runtime):
            tree = runtime.snapshot()
            return {k: (v.tolist() if hasattr(v, "tolist") else v)
                    for k, v in tree["dense_state"].items()}

        runs = [run_app(True, PATTERN_APP, sends, exec_opts=opts, mid=snap)
                for opts in (", instances='32'",
                             ", instances='32', ingest.depth='3', "
                             "emit.depth='auto'")]
        (got1, _, _, mid1), (got2, _, _, mid2) = runs
        assert mid2 == mid1 and mid1[0], "the snapshot was no barrier"
        assert got2 == got1


# -- the product chain at small size ------------------------------------------


N_STATES = 4
PARTITIONS = 64


def product_app(capturing=True, opts=""):
    """``bench.py``'s partitioned headline chain (``partitioned_app``) or
    its capture-free form (``kernel_eligible_app``), cut to 4 nodes and
    64 partitions."""
    if capturing:
        states = ["every e1=Txn[v > 0.0]"] + [
            f"e{i}=Txn[v > {float(i - 1)} and v > e1.v]"
            for i in range(2, N_STATES + 1)]
        sel = f"select e1.v as v1, e{N_STATES}.v as v{N_STATES}"
    else:
        states = ["every e1=Txn[v > 1.0]"] + [
            f"e{i}=Txn[v > {float(i)}]" for i in range(2, N_STATES + 1)]
        sel = f"select e{N_STATES}.v as v"
    return ("@app:playback "
            f"@app:execution('tpu', partitions='{PARTITIONS}'{opts}) "
            "define stream Txn (key long, v double); "
            "partition with (key of Txn) begin "
            f"@info(name='bench') from {' -> '.join(states)} within 10 min "
            f"{sel} insert into Alerts; end;")


def product_batches(n_steps, batch, seed=11):
    """``bench.py``'s ``_product_batches`` at small size: stride-walked
    keys, v ~ U(0, S + 4), one timestamp a batch."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_steps):
        keys = ((np.arange(batch, dtype=np.int64) * 524287 + i * batch)
                % PARTITIONS)
        v = rng.uniform(0.0, float(N_STATES + 4), batch)
        out.append((keys, v, np.full(batch, 1_000 + i * 10, dtype=np.int64)))
    return out


def run_product(port, app, batches, windows=2, warmup=2):
    """bench_product's sends: the warm-up batches, then the rest once a
    window (timestamps repeat from window to window, as in ``bench.py``).
    Returns the callback batches, ``pattern_state()`` and the runtime's
    emit and ingest counters."""
    m = SiddhiManager(device="cpu") if port else JaxManager()
    cls = EventBatch if port else JaxEventBatch
    try:
        rt = m.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback("Alerts", lambda evs: got.append(
            [(e.timestamp, tuple(e.data)) for e in evs]))
        rt.start()
        h = rt.get_input_handler("Txn")
        for keys, v, ts in batches[:warmup] + batches[warmup:] * windows:
            h.send_batch(cls("Txn", ["key", "v"], {"key": keys, "v": v}, ts))
        state = rt.pattern_state()
        pr = rt.partitions["partition_0"]
        runtime = pr.dense_query_runtimes["bench"].pattern_processor
        counters = (runtime.emit_stats, runtime.ingest_stats)
        rt.shutdown()
        return got, state, counters
    finally:
        m.shutdown()


@pytest.mark.parametrize("capturing", [True, False],
                         ids=["general", "batch"])
def test_product_chain_at_adaptive_depths(capturing):
    """The product configuration's depths against the JAX package and
    against the port's depth-1 run: the same callback batches in order,
    the same ``pattern_state()``."""
    batches = product_batches(6, 200)
    opts = ", ingest.depth='2', emit.depth='auto'"
    jgot, jstate, _ = run_product(False, product_app(capturing, opts),
                                  batches)
    got, state, (es, ist) = run_product(True, product_app(capturing, opts),
                                        batches)
    got1, state1, _ = run_product(True, product_app(capturing), batches)
    assert sum(map(len, got)) > 0
    assert got == jgot == got1
    assert state == jstate == state1
    assert state["bench"]["engine"] == "dense"
    assert state["bench"]["partitions_in_use"] == PARTITIONS
    assert es.auto_depth >= 1 and ist.staged_batches == 10
    assert ist.overlapped_batches + ist.ingest_stalls > 0


def test_product_step_kinds():
    """The capturing chain takes the general step, the capture-free one
    the batch step (kernel 1 on a card)."""
    for capturing, kind in ((True, "general"), (False, "batch")):
        m = SiddhiManager(device="cpu")
        rt = m.create_siddhi_app_runtime(product_app(capturing))
        assert rt.lowering(step_kinds=True) == {"bench": "dense/" + kind}
        m.shutdown()


# -- pattern_state -------------------------------------------------------------


def pattern_states(app, sends):
    out = []
    for m in (JaxManager(), SiddhiManager(device="cpu")):
        try:
            rt = m.create_siddhi_app_runtime(app)
            rt.start()
            for sid, row, ts in sends:
                rt.get_input_handler(sid).send(row, timestamp=ts)
            out.append((rt.pattern_state(), rt.query_names(),
                        sorted(rt.get_stream_definitions())))
            rt.shutdown()
        finally:
            m.shutdown()
    return out


def test_runtime_pattern_state_dense_and_host():
    """``tests/test_every_instances.py``'s
    ``TestPatternStateIntrospection`` case: a dense query and a host one
    (a string capture) in one app."""
    app = ("@app:playback @app:execution('tpu') "
           "define stream S (v double); "
           "@info(name='qd') from every a=S[v > 100.0] -> b=S[v > a.v] "
           "within 10 min select a.v as av, b.v as bv insert into Alerts; "
           "define stream T (card string, v double); "
           "@info(name='qh') from every a=T[v > 100.0] -> "
           "b=T[card == a.card] select a.v as av insert into Alerts2;")
    sends = [("S", [500.0], 1000), ("S", [400.0], 1100),
             ("T", ["c1", 500.0], 1200)]
    (jst, jnames, jdefs), (st, names, defs) = pattern_states(app, sends)
    assert st == jst
    assert (names, defs) == (jnames, jdefs)
    assert st["qd"]["engine"] == "dense"
    assert st["qd"]["active_instances"] == 2
    assert st["qh"]["engine"] == "host"


def test_pattern_state_partitioned_and_default_mode():
    """A partitioned dense query (interned rows only) beside a default-mode
    host pattern."""
    rng = np.random.default_rng(9)
    sends = [("S", [int(k), float(v)], 1000 + i)
             for i, (k, v) in enumerate(zip(rng.integers(0, 20, 300),
                                            rng.uniform(0, 200, 300)))]
    dense = ("@app:playback @app:execution('tpu', partitions='32', "
             "instances='8') " + DEFINE + "partition with (k of S) begin "
             "@info(name='qp') from every a=S[v > 100.0] -> b=S[v > a.v] "
             "within 1 sec select a.v as av insert into Alerts; end;")
    host = ("@app:playback " + DEFINE + "@info(name='qh') from every "
            "a=S[v > 150.0] -> b=S[v > a.v] within 1 sec select a.v as av "
            "insert into Alerts;")
    for app in (dense, host):
        (jst, *_), (st, *_) = pattern_states(app, sends)
        assert st == jst and st


def test_router_stats_at_adaptive_depths():
    """The skew router's ``stats()``: the dense runtime's with its hot
    slots, at auto depths, equal to the JAX package's; callbacks too."""
    rng = np.random.default_rng(31)
    ks = np.where(rng.random(600) < 0.7, 7, rng.integers(0, 30, 600))
    u, v = rng.uniform(0, 20, 600).round(1), rng.uniform(0, 20, 600).round(1)
    sends = [("S", [int(k), float(a), float(b)], 1000 + 3 * i)
             for i, (k, a, b) in enumerate(zip(ks, u, v))]
    app = ("@app:playback @app:execution('tpu', instances='16', "
           "ingest.depth='auto', emit.depth='auto') "
           "@app:hotkeys(k='4', promote='0.3', demote='0.1') "
           "define stream S (k long, u double, v double); "
           "partition with (k of S) begin @info(name='q') from every "
           "a=S[v > 8.0] -> b=S[v > 12.0] select b.v as bv "
           "insert into Alerts; end;")
    outs = []
    for m in (JaxManager(), SiddhiManager(device="cpu")):
        try:
            rt = m.create_siddhi_app_runtime(app)
            got = []
            rt.add_callback("Alerts", lambda evs, g=got: g.extend(
                (e.timestamp, tuple(e.data)) for e in evs))
            rt.start()
            for sid, row, ts in sends:
                rt.get_input_handler(sid).send(row, timestamp=ts)
            outs.append((got, rt.pattern_state(), rt.lowering()))
            rt.shutdown()
        finally:
            m.shutdown()
    assert outs[1] == outs[0]
    st = outs[1][1]["q"]
    assert st["engine"] == "hotkey" and st["hotkeyPromotions"] >= 1
    assert st["hot_slots"] == 4 and len(st["hot_keys"]) == 1


# -- the single-key scan engine ------------------------------------------------

SCAN_DEFS = "define stream S (v double, n int); "


def scan_data(n=60, seed=0, t_step=300):
    """``tests/test_nfa_scan.py``'s ``mk``."""
    rng = np.random.default_rng(seed)
    cols = {"v": rng.uniform(0, 50, n).round(1),
            "n": rng.integers(0, 5, n)}
    ts = 1_000 + np.cumsum(rng.integers(1, t_step, n)).astype(np.int64)
    return cols, ts


def fuzz_case(seed):
    rng = np.random.default_rng(500 + seed)
    s = int(rng.integers(2, 6))
    thr = sorted(rng.uniform(5, 45, s).round(1))
    chain = " -> ".join(f"e{i}=S[v > {thr[i]}]" for i in range(s))
    within = (f" within {int(rng.integers(1, 4))} sec"
              if rng.integers(2) else "")
    app = (SCAN_DEFS + f"@info(name='q') from every {chain}{within} "
           "select e0.v as x insert into Out;")
    data = dict(n=int(rng.integers(30, 100)), seed=900 + seed,
                t_step=int(rng.integers(100, 900)))
    return app, data, int(rng.integers(1, 4))


CHAIN3 = ("every a=S[v > 10.0] -> b=S[v > 20.0] -> c=S[v > 30.0]")
SCAN_CASES = {
    "three_node_chain": (SCAN_DEFS + f"@info(name='q') from {CHAIN3} "
                         "select a.v as av insert into Out;", {}, 1),
    "within_pruning": (SCAN_DEFS + f"@info(name='q') from {CHAIN3} within "
                       "1 sec select a.v as av insert into Out;",
                       dict(n=80, seed=1, t_step=700), 1),
    "two_node_chain": (SCAN_DEFS + "@info(name='q') from every a=S[v > 25.0] "
                       "-> b=S[v < 5.0] select a.v as av insert into Out;",
                       dict(n=50, seed=2), 1),
    "chunked_state_carry": (SCAN_DEFS + f"@info(name='q') from {CHAIN3} "
                            "within 5 sec select a.v as av insert into Out;",
                            dict(n=90, seed=3), 7),
    "compound_filters": (SCAN_DEFS + "@info(name='q') from every "
                         "a=S[v > 10.0 and n != 2] -> b=S[v > 20.0 or n == 4]"
                         " -> c=S[v > 30.0] select a.v as av "
                         "insert into Out;", dict(n=70, seed=4), 1),
    **{f"fuzz_{s}": fuzz_case(s) for s in range(4)},
}


def scan_runs(app, cols, ts, chunks, port_bytes=None):
    """Both engines over ``chunks`` batches: per batch (idx, starts) of
    each, and the final states."""
    je = jax_scan_pattern(app, "q")
    te = compile_scan_pattern(app, "q", device="cpu")
    if port_bytes is not None:
        te.SCAN_BYTES = {"cpu": port_bytes}
    js, tstate = je.init_state(), te.init_state()
    out = []
    for part in np.array_split(np.arange(len(ts)), chunks):
        if len(part) == 0:
            continue
        c = {k: v[part] for k, v in cols.items()}
        js, ji, jst = je.process(js, c, ts[part])
        tstate, ti, tst = te.process(tstate, c, ts[part])
        out.append(((ji, jst), (ti, tst), np.array(js), tstate.numpy()))
    return out


def assert_scan_equal(runs):
    detections = 0
    for (ji, jst), (ti, tst), js, ts_ in runs:
        assert np.array_equal(ti, ji) and np.array_equal(tst, jst)
        assert ti.dtype == ji.dtype and tst.dtype == jst.dtype
        live = js > NEG / 2
        assert np.array_equal(live, ts_ > NEG / 2)
        assert js[live].tobytes() == ts_[live].tobytes()
        assert (ts_[~live] <= NEG / 2).all()
        detections += len(ti)
    return detections


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_engine_as_the_reference(case):
    app, data, chunks = SCAN_CASES[case]
    cols, ts = scan_data(**data)
    assert_scan_equal(scan_runs(app, cols, ts, chunks))


@pytest.mark.parametrize("case", ["three_node_chain", "within_pruning",
                                  "chunked_state_carry"])
def test_scan_engine_chunks_inside_a_batch(case):
    """A budget of a few events a chunk: the state carried from chunk to
    chunk gives the same detections and live lanes."""
    app, data, _ = SCAN_CASES[case]
    cols, ts = scan_data(**data)
    eng = compile_scan_pattern(app, "q", device="cpu")
    per_event = 2 * 4 * eng.n_nodes ** 3
    runs = scan_runs(app, cols, ts, 2, port_bytes=5 * per_event)
    assert assert_scan_equal(runs) > 0


def test_scan_engine_long_stream():
    """One key's 2,000-event stream in batches of 500 at S = 4: the
    detections a seeded stream gives, both packages."""
    app = (SCAN_DEFS + "@info(name='q') from every a=S[v > 10.0] -> "
           "b=S[v > 20.0] -> c=S[v > 30.0] -> d=S[v > 40.0] within 2 sec "
           "select a.v as av insert into Out;")
    cols, ts = scan_data(n=2000, seed=12, t_step=40)
    assert assert_scan_equal(scan_runs(app, cols, ts, 4)) > 50


@pytest.mark.parametrize("app", [
    SCAN_DEFS + "@info(name='q') from every a=S[v > 10.0] -> b=S[v > a.v] "
    "select a.v as av insert into Out;",
    SCAN_DEFS + "@info(name='q') from every a=S[v > 10.0] -> "
    "b=S[v > 20.0]<2:3> select a.v as av insert into Out;",
    SCAN_DEFS + "@info(name='q') from a=S[v > 10.0] -> b=S[v > 20.0] "
    "select a.v as av insert into Out;",
    "define stream A (v double); define stream B (v double); "
    "@info(name='q') from every (a=A and b=B) select a.v as av "
    "insert into Out;",
], ids=["capture", "count", "non_every", "logical"])
def test_scan_eligibility_as_the_reference(app):
    from siddhi_tpu.core.exceptions import (
        SiddhiAppCreationError as JaxCreationError,
    )

    with pytest.raises(JaxCreationError):
        jax_scan_pattern(app, "q")
    with pytest.raises(SiddhiAppCreationError):
        compile_scan_pattern(app, "q", device="cpu")


def test_compile_scan_pattern_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(SiddhiAppCreationError, match="CUDA"):
        compile_scan_pattern(SCAN_CASES["two_node_chain"][0], "q")
