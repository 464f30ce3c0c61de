"""The port's app scheduler, playback clock and ``@purge`` against the
JAX package's.

``siddhi_tpu_torch/util/scheduler.py`` is the port's own copy of the
reference's ``Scheduler`` (tasks only): the same fake tasks go through
both and must fire alike.  The rest goes through both packages'
``SiddhiManager`` on the CPU: the tick-before-batch order, the
``@app:playback(idle.time, increment)`` clock and heartbeat, and
``@purge`` on a dense partition (plain and under ``@app:hotkeys``),
whose callbacks, key maps and state must be equal.  Tests that wait on
the wall clock poll with a bounded deadline of a few seconds and use
deadlines of tens of ms.
"""

import logging
import threading
import time

import numpy as np
import pytest

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.compiler.parser import SiddhiParserError as JaxParserError
from siddhi_tpu.core.context import TimestampGenerator as JaxClock
from siddhi_tpu.core.event import EventBatch as JaxEventBatch
from siddhi_tpu.util.scheduler import Scheduler as JaxScheduler
from siddhi_tpu_torch import SiddhiManager, state_to_numpy
from siddhi_tpu_torch.compiler import SiddhiParserError
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.planner.app_planner import TimestampGenerator
from siddhi_tpu_torch.util.scheduler import Scheduler

STREAMS = (
    "define stream Stream1 (symbol string, price float, volume int); "
    "define stream Stream2 (symbol string, price float, volume int); "
)
TRAILING = ("@info(name='q') from e1=Stream1[price>20] -> "
            "not Stream2[price>e1.price] for 1 sec "
            "select e1.price as p1 insert into OutputStream;")
F56 = float(np.float32(55.6))
WAIT_S = 5.0  # the longest any test here waits on the wall clock


class FakeContext:
    def __init__(self, clock):
        self.timestamp_generator = clock
        self.playback = True
        self.process_lock = threading.RLock()


class PeriodicTask:
    """Wakes every ``period`` ms from ``start``; records each fire."""

    def __init__(self, start, period):
        self.next, self.period, self.fired = start, period, []

    def next_wakeup(self):
        return self.next

    def fire(self, now):
        self.fired.append((now, self.next))
        self.next += self.period


class StuckTask(PeriodicTask):
    """A fire that does not move its wakeup (the equal-wake guard)."""

    def fire(self, now):
        self.fired.append((now, self.next))


class FailingTask(PeriodicTask):
    def fire(self, now):
        super().fire(now)
        raise RuntimeError("task failed")


def both_schedulers(make_tasks):
    """The same tasks on the reference's scheduler and the port's."""
    out = []
    for cls, clock in ((JaxScheduler, JaxClock), (Scheduler,
                                                  TimestampGenerator)):
        sch = cls(FakeContext(clock(playback=True)))
        tasks = make_tasks()
        for t in tasks:
            sch.register_task(t)
        out.append((sch, tasks))
    return out


def test_advance_drains_every_elapsed_wakeup():
    """One advance over several periods fires each elapsed wakeup, in
    order; an advance to an earlier time fires nothing."""
    runs = both_schedulers(lambda: [PeriodicTask(1000, 250),
                                    PeriodicTask(1100, 1000)])
    for sch, _tasks in runs:
        for now in (999, 2100, 2000, 2600):
            sch.advance(now)
    (_, jt), (_, tt) = runs
    assert [t.fired for t in tt] == [t.fired for t in jt]
    assert [len(t.fired) for t in tt] == [7, 2]


def test_equal_wake_guard_stops_a_stuck_task():
    runs = both_schedulers(lambda: [StuckTask(1000, 0)])
    for sch, _tasks in runs:
        sch.advance(5000)
        sch.advance(6000)
    (_, jt), (_, tt) = runs
    assert tt[0].fired == jt[0].fired == [(5000, 1000), (6000, 1000)]


def test_failing_task_is_isolated(caplog):
    """A task that raises stops its own drain, is logged, and the other
    tasks still fire; the next advance tries it again."""
    runs = both_schedulers(lambda: [FailingTask(1000, 100),
                                    PeriodicTask(1000, 100)])
    with caplog.at_level(logging.ERROR):
        for sch, _tasks in runs:
            sch.advance(1350)
            sch.advance(1400)
    (_, jt), (_, tt) = runs
    assert [t.fired for t in tt] == [t.fired for t in jt]
    assert tt[0].fired == [(1350, 1000), (1400, 1100)]
    assert len(tt[1].fired) == 5
    port_errors = [r for r in caplog.records
                   if r.name == "siddhi_tpu_torch" and "failed" in r.message]
    assert len(port_errors) == 2


def test_unregister_and_start_calls_on_start():
    class Starter(PeriodicTask):
        def on_start(self, now):
            self.started = now

    sch = Scheduler(FakeContext(TimestampGenerator(playback=True)))
    a, b = Starter(None, 1), Starter(None, 1)
    sch.register_task(a)
    sch.register_task(b)
    sch.unregister_task(b)
    sch.unregister_task(b)  # absent: no error
    sch.start()
    assert a.started == 0 and not hasattr(b, "started")
    assert sch._thread is None  # playback: event time only
    sch.stop()


# -- through SiddhiManager ---------------------------------------------------

def app_run(port, app, header="@app:playback @app:execution('tpu') "):
    mgr = SiddhiManager(device="cpu") if port else JaxManager()
    rt = mgr.create_siddhi_app_runtime(header + app)
    got = []
    rt.add_callback("OutputStream", lambda evs: got.extend(
        (list(e.data), e.timestamp) for e in evs))
    rt.start()
    return mgr, rt, got


def test_tick_runs_before_the_batch_it_advances_to():
    """The scheduler advances to a batch's watermark before the batch
    steps: a deadline at or below its last timestamp fires even though
    an earlier event of the same batch would have killed it (the
    reference's order)."""
    res = []
    for port in (False, True):
        mgr, rt, got = app_run(port, STREAMS + TRAILING)
        cls = EventBatch if port else JaxEventBatch
        rt.get_input_handler("Stream1").send(["W", 55.6, 1], timestamp=1000)
        rt.get_input_handler("Stream2").send_batch(cls(
            "Stream2", ["symbol", "price", "volume"],
            {"symbol": np.array(["K", "L"], dtype=object),
             "price": np.array([60.0, 0.0], dtype=np.float32),
             "volume": np.array([1, 1], dtype=np.int32)},
            np.array([1500, 2500], dtype=np.int64)))
        rt.shutdown()
        mgr.shutdown()
        res.append(got)
    assert res[1] == res[0] == [([F56], 2000)]


def test_playback_clock_matches_the_reference():
    """``current_time`` is event time plus the increment (0 before the
    first event); the idle heartbeat's ``advance_idle`` moves event time
    by the increment."""
    clocks = [JaxClock(playback=True, increment_ms=500),
              TimestampGenerator(playback=True, increment_ms=500)]
    seen = []
    for c in clocks:
        trace = [c.current_time(), c.advance_idle()]
        for ts in (1000, 900, 1200):
            c.set_event_time(ts)
            trace.append(c.current_time())
        trace += [c.advance_idle(), c.advance_idle(), c.current_time()]
        seen.append(trace)
    assert seen[1] == seen[0] == [0, 0, 1500, 1500, 1700, 2200, 2700, 2700]


@pytest.mark.parametrize("ann,increment,idle", [
    ("@app:playback", 0, 0),
    ("@app:playback(increment='2 sec')", 2000, 0),
    ("@app:playback(idle.time='100 millisecond', increment='250')", 250, 100),
])
def test_playback_annotation_parsed_as_reference(ann, increment, idle):
    app = ann + " " + STREAMS + TRAILING
    jrt = JaxManager().create_siddhi_app_runtime(
        app.replace(STREAMS, STREAMS + "@app:execution('tpu') "))
    trt = SiddhiManager(device="cpu").create_siddhi_app_runtime(
        ann + " @app:execution('tpu') " + STREAMS + TRAILING)
    for ctx in (jrt.app_context, trt.app_context):
        assert ctx.playback
        assert ctx.timestamp_generator.increment_ms == increment
        assert ctx.playback_idle_ms == idle


def test_invalid_increment_rejected():
    """``tests/test_conformance_playback.py:117``: a non-time increment
    is a parse error in both packages."""
    app = ("@app:playback(idle.time='100 millisecond', increment='x') "
           + STREAMS + "@app:execution('tpu') " + TRAILING)
    with pytest.raises(JaxParserError):
        JaxManager().create_siddhi_app_runtime(app)
    with pytest.raises(SiddhiParserError, match="expected a time value"):
        SiddhiManager(device="cpu").create_siddhi_app_runtime(app)


def wait_for(pred):
    stop = time.monotonic() + WAIT_S
    while not pred() and time.monotonic() < stop:
        time.sleep(0.005)
    return pred()


def test_idle_heartbeat_fires_a_deadline_with_no_input():
    """``@app:playback(idle.time, increment)``: with no event after the
    arm, the heartbeat moves event time by the increment and the
    scheduler fires the deadline at its own time, as the reference's."""
    header = ("@app:playback(idle.time='20 millisecond', "
              "increment='400 millisecond') @app:execution('tpu') ")
    res = []
    for port in (False, True):
        mgr, rt, got = app_run(port, STREAMS + TRAILING, header)
        rt.get_input_handler("Stream1").send(["W", 55.6, 1], timestamp=1000)
        assert wait_for(lambda: got), "no heartbeat fire within the limit"
        rt.shutdown()
        mgr.shutdown()
        res.append(got)
    assert res[1] == res[0] == [([F56], 2000)]


def test_wall_clock_fires_a_deadline_in_processing_time():
    """Without ``@app:playback`` the scheduler's wall-clock thread fires
    a 30 ms deadline at its time (send time + 30) with no further input,
    in both packages; shutdown stops the thread."""
    q = TRAILING.replace("for 1 sec", "for 30 millisecond")
    res = []
    for port in (False, True):
        mgr, rt, got = app_run(port, STREAMS + q, "@app:execution('tpu') ")
        t0 = int(time.time() * 1000)
        rt.get_input_handler("Stream1").send(["W", 55.6, 1], timestamp=t0)
        assert wait_for(lambda: got), "no wall-clock fire within the limit"
        rt.shutdown()
        mgr.shutdown()
        res.append([(row, ts - t0) for row, ts in got])
        if port:
            assert rt.scheduler._thread is None
    assert res[1] == res[0] == [([F56], 30)]


# -- @purge -------------------------------------------------------------------

PURGE_APP = (
    "@app:playback "
    "@app:execution('tpu', partitions='4') "
    "define stream Txn (card string, amount double); "
    "@purge(enable='true', interval='1 sec', idle.period='2 sec') "
    "partition with (card of Txn) begin "
    "@info(name='q') "
    "from a=Txn[amount > 100.0] -> b=Txn[amount > a.amount] "
    "select a.amount as base, b.amount as bv insert into Alerts; "
    "end;"
)


def dense_of(rt, port):
    if port:
        return rt.pattern_runtimes()["q"]
    pr = rt.partitions["partition_0"]
    return next(iter(pr.dense_query_runtimes.values())).pattern_processor


def purge_run(port, app, sends, advance_to):
    mgr = SiddhiManager(device="cpu") if port else JaxManager()
    rt = mgr.create_siddhi_app_runtime(app)
    got = []
    rt.add_callback("Alerts", lambda evs: got.extend(
        (list(e.data), e.timestamp) for e in evs))
    rt.start()
    h = rt.get_input_handler("Txn")
    keys = []
    for row, ts in sends:
        h.send(row, timestamp=ts)
        if ts == advance_to:
            rt.scheduler.advance(advance_to + 1)
        keys.append(dict(dense_of(rt, port)._key_rows))
    proc = dense_of(rt, port)
    rt.shutdown()
    mgr.shutdown()
    if port:
        state = state_to_numpy(proc.engine, proc.state)[0]
    else:
        state = {k: np.asarray(v) for k, v in proc.state.items()}
    return got, keys, state, proc


def test_purge_recycles_idle_rows_as_reference():
    """``tests/test_dense_integration.py:337``'s app: four keys fill the
    partition capacity, the watermark passes the idle period, the purge
    recycles the idle rows and a new key completes a match.  Callbacks,
    the key map after every send, the free rows and the state must
    match the reference's."""
    sends = [(["a", 150.0], 1000), (["b", 150.0], 1001),
             (["c", 150.0], 1002), (["d", 150.0], 1003),
             (["a", 90.0], 20_000), (["e", 150.0], 21_000),
             (["e", 250.0], 21_500), (["f", 150.0], 21_600),
             (["f", 300.0], 21_700)]
    jgot, jkeys, jstate, jproc = purge_run(False, PURGE_APP, sends, 20_000)
    tgot, tkeys, tstate, tproc = purge_run(True, PURGE_APP, sends, 20_000)
    assert tgot == jgot and ([150.0, 250.0], 21_500) in tgot
    assert tkeys == jkeys and len(tkeys[4]) < 4
    assert tproc._free_rows == jproc._free_rows
    assert tproc._next_row == jproc._next_row == 4
    assert set(tstate) == set(jstate)
    for k in tstate:
        assert np.array_equal(tstate[k], jstate[k]), k


def test_purge_resets_pending_deadlines():
    """An idle key's pending absent deadline is purged with its row: it
    never fires, and the recycled row starts clean (``deadline``
    included)."""
    app = ("@app:playback @app:execution('tpu', partitions='2') "
           + STREAMS + "@purge(enable='true', interval='1 sec', "
           "idle.period='2 sec') partition with (symbol of Stream1, "
           "symbol of Stream2) begin "
           + TRAILING.replace("for 1 sec", "for 5 sec") + " end;")
    res = []
    for port in (False, True):
        mgr = SiddhiManager(device="cpu") if port else JaxManager()
        rt = mgr.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback("OutputStream", lambda evs: got.extend(
            (list(e.data), e.timestamp) for e in evs))
        rt.start()
        h1, h2 = (rt.get_input_handler(s) for s in ("Stream1", "Stream2"))
        h1.send(["A", 30.0, 1], timestamp=1000)  # deadline 6000
        h2.send(["B", 1.0, 1], timestamp=4000)   # A idle 3 s: purged
        h1.send(["C", 40.0, 1], timestamp=4100)  # takes A's row
        h2.send(["C", 1.0, 1], timestamp=9500)   # C's deadline 9100 fires
        proc = dense_of(rt, port)
        rt.shutdown()
        mgr.shutdown()
        res.append((got, dict(proc._key_rows)))
    assert res[1] == res[0]
    assert res[1][0] == [([40.0], 9100)]


def test_router_purge_demotes_an_idle_hot_key():
    """Under ``@app:hotkeys`` a promoted key that goes idle is demoted
    (its pending chains back in its dense row) before the purge
    recycles the row, as the reference's router does."""
    header = ("@app:playback @app:execution('tpu', partitions='64', "
              "instances='16') @app:hotkeys(k='4', promote='0.3', "
              "demote='0.1') ")
    app = (header + "define stream S (k long, u double, v double); "
           "@purge(enable='true', interval='1 sec', idle.period='5 sec') "
           "partition with (k of S) begin @info(name='q') from every "
           "a=S[v > 8.0] -> b=S[v > 12.0] select b.v as bv insert into "
           "Alerts; end;")
    rng = np.random.default_rng(3)
    sends, t = [], 1000
    for _ in range(300):
        t += int(rng.integers(1, 20))
        k = 7 if rng.random() < 0.8 else int(rng.integers(0, 30))
        sends.append(([k, float(rng.uniform(0, 20)),
                       float(rng.uniform(0, 20))], t))
    # one cold key long after key 7's last event: the purge runs before
    # that event is routed, while key 7 is still promoted
    sends.append(([100, 10.0, 13.0], t + 10_000))
    res = []
    for port in (False, True):
        mgr = SiddhiManager(device="cpu") if port else JaxManager()
        rt = mgr.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback("Alerts", lambda evs: got.extend(
            (list(e.data), e.timestamp) for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        for row, ts in sends:
            h.send(row, timestamp=ts)
        router = dense_of(rt, port)
        hot = router.hot_metrics()
        keys = dict(router._key_rows)
        rt.shutdown()
        mgr.shutdown()
        res.append((got, hot, keys))
    assert res[1] == res[0]
    got, hot, keys = res[1]
    assert hot["hotkeyPromotions"] == hot["hotkeyDemotions"] == 1
    assert hot["hotkeyActiveKeys"] == 0 and list(keys) == [100] and got
