"""Asynchronous junctions and the emit pipeline, held through both
packages; the repairs of ``ROADMAP.md`` §3 faults 9–12.

``tests/test_async_emit.py`` and ``tests/test_conformance_async.py`` run
by ``test_torch_persistence.py``'s twin runs (see
``test_torch_done_slices.py``): both packages pass each test's own
assertions and deliver the same events.  ``LEFT_OUT`` names what waits:
``devices=`` (item 16); the full-ring shutdown case has its own test
(the port's stop delivers what the reference's drops).  The fault tests run one app
string through both packages:

- 9: ``@async(buffer.size, batch.size.max)`` queues sends and a worker
  coalesces them, so a callback sees the reference's chunking (fewer
  calls than sends, none above ``batch.size.max``);
- 10: ``@OnError(action='STREAM')`` routes a failing batch to the
  fault stream ``!S`` with its ``_error``, as the reference does, and
  ``@OnError(action='LOG')`` logs it (``test_torch_transport.py``
  replays the on-error corpus);
- 11: ``@app:enforceOrder`` and an ``@app:`` name the reference does not
  know run as in the reference;
- 12: ``DeviceQueryRuntime.step_invocations`` counts the device steps.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.core.event import EventBatch as JaxBatch
from siddhi_tpu_torch.core.event import EventBatch as PortBatch
from siddhi_tpu_torch.core.exceptions import SiddhiAppRuntimeError
from test_torch_device_query import one_torch_thread  # noqa: F401
from test_torch_done_slices import INNER, stand_ins
from test_torch_persistence import cases, check_twin, run

LEFT_OUT = {
    "test_async_emit": {
        ("TestDenseAndShardedDifferential", "test_sharded_dense_deferred"):
            "devices= (item 16)",
        ("TestShardedBigBatchRegression",
         "test_group_keys_aligned_past_2048_rows_deferred"):
            "devices= (item 16)",
    },
    "test_conformance_async": {
        (None, "test_stop_with_full_queue_does_not_deadlock"):
            "test_stop_with_a_full_ring_as_the_reference",
    },
}
CORPORA = ("test_async_emit", "test_conformance_async")
CASES = [c for corpus in CORPORA
         for c in cases(corpus, LEFT_OUT.get(corpus, {}))]


def test_the_corpora_were_read():
    counts = {}
    for p in CASES:
        counts[p.values[0]] = counts.get(p.values[0], 0) + 1
    assert counts == {"test_async_emit": 21, "test_conformance_async": 4}


@pytest.mark.parametrize("corpus,cname,mname,k", CASES)
def test_async_corpus_as_the_reference(corpus, cname, mname, k, tmp_path,
                                       request):
    check_twin(corpus, cname, mname, k, tmp_path, request, inner=INNER,
               stand_ins=stand_ins)


def test_stop_with_a_full_ring_as_the_reference(tmp_path, request):
    """``test_stop_with_full_queue_does_not_deadlock`` in both packages:
    each shuts down without blocking.  The reference drops what its
    ring still holds at stop (how much is timing-bound); the port's stop
    dispatches it, so it delivers every event sent, and the reference's
    delivery is a prefix of the port's."""
    args = ("test_conformance_async", None,
            "test_stop_with_full_queue_does_not_deadlock", 0)
    jax = run(*args, False, tmp_path, request, stand_ins=stand_ins)
    port = run(*args, True, tmp_path, request, inner=INNER,
               stand_ins=stand_ins)
    jrows, prows = jax.got["Out"], port.got["Out"]
    assert len(prows) == 32 * 64
    assert prows[:len(jrows)] == jrows


def _managers():
    return (("jax", siddhi_tpu.SiddhiManager, JaxBatch),
            ("port", lambda: siddhi_tpu_torch.SiddhiManager(device="cpu"),
             PortBatch))


# -- fault 9: @async junctions ------------------------------------------------

ASYNC_APP = ("@async(buffer.size='64', batch.size.max='8') "
             "define stream S (v long); "
             "@info(name='q') from S[v % 3 != 0] select v insert into O;")


def _async_run(make, n):
    m = make()
    try:
        rt = m.create_siddhi_app_runtime(ASYNC_APP)
        chunks = []
        rt.add_callback("q", lambda ts, ins, outs: chunks.append(
            [e.data[0] for e in ins or []]))
        rt.start()
        h = rt.get_input_handler("S")
        for i in range(n):
            h.send([i])
        # the reference's stop drops what its ring still holds, so wait
        # for the worker to deliver every event first
        want = len([i for i in range(n) if i % 3])
        deadline = time.time() + 20
        while (sum(len(c) for c in chunks) < want
               and time.time() < deadline):
            time.sleep(0.01)
        rt.shutdown()
        return chunks
    finally:
        m.shutdown()


def test_async_junction_coalesces_as_the_reference():
    n = 300
    want = [i for i in range(n) if i % 3]
    for _name, make, _b in _managers():
        chunks = _async_run(make, n)
        # every event once, in order, in fewer callbacks than sends and
        # none over batch.size.max (the exact split is timing-bound)
        assert [v for c in chunks for v in c] == want
        assert len(chunks) < len(want)
        assert max(len(c) for c in chunks) <= 8


def test_async_worker_dispatches_under_the_app_lock():
    """The worker takes the app lock for each dispatch, as every send and
    scheduler tick does: while a thread holds the lock, queued batches
    wait, and they all arrive once it lets go."""
    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    try:
        rt = m.create_siddhi_app_runtime(ASYNC_APP)
        got = []
        rt.add_callback("O", lambda evs: got.extend(e.data[0] for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        with rt.app_context.process_lock:
            for i in range(1, 30):
                h.send([i])
            time.sleep(0.2)
            assert got == []
        deadline = time.time() + 5
        while len(got) < 20 and time.time() < deadline:
            time.sleep(0.01)
        assert got == [i for i in range(1, 30) if i % 3]
        rt.shutdown()
    finally:
        m.shutdown()


def test_async_stop_with_a_full_ring_loses_nothing():
    """A producer blocked on a full ring while the app shuts down
    finishes, and every batch it had queued is dispatched."""
    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    try:
        rt = m.create_siddhi_app_runtime(
            "@async(buffer.size='2', batch.size.max='4') "
            "define stream S (v double); from S select v insert into O;")
        got = []
        rt.add_callback("O", lambda evs: (time.sleep(0.005),
                                          got.extend(evs)))
        rt.start()
        h = rt.get_input_handler("S")
        b = PortBatch("S", ["v"], {"v": np.ones(16)},
                      np.zeros(16, dtype=np.int64))
        t = threading.Thread(target=lambda: [h.send_batch(b)
                                             for _ in range(20)])
        t.start()
        t.join(timeout=20)
        rt.shutdown()
        assert not t.is_alive()
        assert len(got) == 320
    finally:
        m.shutdown()


def test_async_stop_keeps_the_send_order():
    """A producer waiting on a full ring while the app stops sends after
    what the ring still holds: every event of every send that returned
    arrives once, in send order (the port's stop dispatches the ring
    where the reference's drops it, so this is the port's alone).  Three
    rounds, since where the stop lands is timing-bound."""
    for _round in range(3):
        m = siddhi_tpu_torch.SiddhiManager(device="cpu")
        try:
            rt = m.create_siddhi_app_runtime(
                "@async(buffer.size='4', batch.size.max='4') "
                "define stream S (v double); from S select v insert into O;")
            got = []
            rt.add_callback("O", lambda evs: (time.sleep(0.003), got.extend(
                e.data[0] for e in evs)))
            rt.start()
            h = rt.get_input_handler("S")
            sent = []

            def produce():
                for i in range(400):
                    b = PortBatch("S", ["v"],
                                  {"v": np.arange(4 * i, 4 * i + 4,
                                                  dtype=np.float64)},
                                  np.zeros(4, dtype=np.int64))
                    try:
                        h.send_batch(b)
                    except SiddhiAppRuntimeError:
                        return
                    sent.append(i)

            t = threading.Thread(target=produce)
            t.start()
            deadline = time.time() + 10
            while len(sent) < 20 and time.time() < deadline:
                time.sleep(0.001)
            rt.shutdown()
            t.join(timeout=20)
            assert not t.is_alive()
            assert 20 <= len(sent) < 400
            assert got == [float(v) for i in sent
                           for v in range(4 * i, 4 * i + 4)]
        finally:
            m.shutdown()


# -- fault 10: @OnError(action='STREAM') -------------------------------------

@pytest.mark.parametrize("action", ["STREAM", "LOG"])
def test_on_error_stream_refused_until_item_15a(action):
    """Fault 10, closed: a query failing on some events (``v == 7``)
    sends them, with the error, to ``!S`` under
    ``@OnError(action='STREAM')``, and logs them under LOG; the other
    events flow on.  The same rows in both packages."""
    def fail_on_seven(v):
        if v == 7:
            raise RuntimeError("seven")
        return v

    app = (f"@app:playback @OnError(action='{action}') "
           "define stream S (v int); "
           "@info(name='q') from S select custom:f7(v) as v insert into O; "
           + ("@info(name='qf') from !S select v, _error insert into F;"
              if action == "STREAM" else ""))
    rows = {}
    for name, make, _b in _managers():
        m = make()
        m.set_extension("custom:f7", fail_on_seven, kind="function")
        rt = m.create_siddhi_app_runtime(app)
        got, faults = [], []
        rt.add_callback("O", lambda evs, g=got: g.extend(
            tuple(e.data) for e in evs))
        if action == "STREAM":
            rt.add_callback("F", lambda evs, g=faults: g.extend(
                (e.data[0], str(e.data[1])) for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        for i, v in enumerate((5, 7, 8)):
            h.send([v], timestamp=1000 + i)
        rt.shutdown()
        m.shutdown()
        rows[name] = (got, faults)
    assert rows["port"] == rows["jax"]
    assert rows["port"] == ([(5,), (8,)],
                            [(7, "seven")] if action == "STREAM" else [])


# -- fault 11: @app:enforceOrder and unknown @app: names ----------------------

@pytest.mark.parametrize("ann", ["@app:enforceOrder",
                                 "@app:enforceOrder('true')",
                                 "@app:somethingElse(x='1')"])
def test_app_annotations_the_reference_accepts_run(ann):
    app = (f"{ann} @app:playback define stream S (v int); "
           "@info(name='q') from S[v > 1] select v insert into O;")
    rows = {}
    for name, make, _b in _managers():
        m = make()
        rt = m.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback("O", lambda evs, g=got: g.extend(
            (e.timestamp, tuple(e.data)) for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        for i, v in enumerate([1, 2, 3]):
            h.send([v], timestamp=1000 + i)
        rt.shutdown()
        m.shutdown()
        rows[name] = got
    assert rows["port"] == rows["jax"] == [(1001, (2,)), (1002, (3,))]


@pytest.mark.parametrize("ann,item", [("@app:trace(sample='1')", 15),
                                      ("@app:statistics('true')", 15),
                                      ("@app:limits(rate='10')", 15)])
def test_later_app_annotations_stay_refused(ann, item):
    """Its name kept from when the port refused these item-``item``
    annotations: they now plan and run, with the reference's rows (the
    rate of 10 a second admits every one of the three events)."""
    app = (f"@app:playback {ann} @app:execution('tpu') "
           "define stream S (v int); from S select v insert into O;")
    rows = []
    for make in (siddhi_tpu.SiddhiManager,
                 lambda: siddhi_tpu_torch.SiddhiManager(device="cpu")):
        m = make()
        rt = m.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback("O", lambda evs: got.extend(e.data[0] for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        for i in range(3):
            h.send([i], timestamp=1000 + 200 * i)
        rt.shutdown()
        m.shutdown()
        rows.append(got)
    assert rows[0] == rows[1] == [0, 1, 2]


# -- fault 12: DeviceQueryRuntime.step_invocations ----------------------------

def test_step_invocations_count_the_device_steps():
    app = ("@app:playback @app:execution('tpu') "
           "define stream S (k int, v float); "
           "@info(name='q') from S#window.length(4) "
           "select k, sum(v) as s insert into O;")
    counts = {}
    for name, make, batch in _managers():
        m = make()
        rt = m.create_siddhi_app_runtime(app)
        rt.start()
        h = rt.get_input_handler("S")
        for i in range(5):
            h.send([i, float(i)], timestamp=1000 + i)
        h.send_batch(batch("S", ["k", "v"],
                           {"k": np.arange(3, dtype=np.int32),
                            "v": np.ones(3, dtype=np.float32)},
                           np.full(3, 2000, dtype=np.int64)))
        qr = rt.query_runtimes["q"]
        assert qr.lowered_to == "device" if name == "port" else True
        counts[name] = qr.device_runtime.step_invocations
        rt.shutdown()
        m.shutdown()
    assert counts == {"jax": 6, "port": 6}
