"""Error isolation held against the JAX package: a failing query, stream
callback or dense emit logs and lets the rest of the app go on.

The JAX package isolates each junction receiver and callback (the LOG
form of ``@OnError``: log, then the app's exception listeners) and each
emit-queue entry (a failing materializer drops its one pending batch and
logs).  The same app and events go through both packages; the
delivered rows, the rows lost and the errors the listeners saw must
agree.
"""

from __future__ import annotations

import numpy as np

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager
from test_torch_device_query import one_torch_thread  # noqa: F401 (a fixture)

DEFINE = "@app:playback define stream Txn (card long, amount double); "


def events(n=10, seed=3):
    rng = np.random.default_rng(seed)
    return [([int(rng.integers(0, 4)), float(rng.integers(11, 60))],
             1000 + 10 * i) for i in range(n)]


def run(port, app, sends, setup=None, streams=("B",)):
    """Rows per stream, and the listener's error types, in order."""
    mgr = SiddhiManager(device="cpu") if port else JaxManager()
    try:
        rt = mgr.create_siddhi_app_runtime(app)
        errors, got = [], {}
        rt.add_exception_listener(lambda e: errors.append(type(e).__name__))
        for s in streams:
            rt.add_callback(s, lambda evs, g=got.setdefault(s, []):
                            g.extend(tuple(e.data) for e in evs))
        if setup is not None:
            setup(rt)
        rt.start()
        h = rt.get_input_handler("Txn")
        for row, ts in sends:
            h.send(list(row), timestamp=ts)
        rt.shutdown()
        return got, errors
    finally:
        mgr.shutdown()


def test_failing_group_by_query_beside_a_filter():
    """``q0`` fails at run time in both packages (``group by c`` names a
    select alias: ``KeyError`` in the selector); ``q1``, planned after
    it on the same junction, still delivers every row."""
    app = (DEFINE + "@info(name='q0') from Txn select card as c, count() "
           "as n group by c insert into A; @info(name='q1') from "
           "Txn[amount > 10.0] select card, amount insert into B;")
    jgot, jerr = run(False, app, events(), streams=("A", "B"))
    tgot, terr = run(True, app, events(), streams=("A", "B"))
    assert tgot == jgot and terr == jerr
    assert len(tgot["B"]) == 10 and not tgot["A"]
    assert terr == ["KeyError"] * 10


def test_raising_stream_callback():
    """The first of two callbacks on ``B`` raises on every batch; the
    second still gets all the rows, and the listener sees each error."""
    app = DEFINE + "from Txn select card, amount insert into B;"

    def setup(rt):
        def boom(evs):
            raise ValueError("callback failed")

        # registered before the recorder: isolation must reach it
        rt.add_callback("B", boom)

    def run_first(port):
        mgr = SiddhiManager(device="cpu") if port else JaxManager()
        try:
            rt = mgr.create_siddhi_app_runtime(app)
            errors, got = [], []
            rt.add_exception_listener(
                lambda e: errors.append(type(e).__name__))
            setup(rt)
            rt.add_callback("B", lambda evs: got.extend(
                tuple(e.data) for e in evs))
            rt.start()
            h = rt.get_input_handler("Txn")
            for row, ts in events(5):
                h.send(list(row), timestamp=ts)
            rt.shutdown()
            return got, errors
        finally:
            mgr.shutdown()

    jgot, jerr = run_first(False)
    tgot, terr = run_first(True)
    assert (tgot, terr) == (jgot, jerr)
    assert len(tgot) == 5 and terr == ["ValueError"] * 5


def test_raising_selector_on_a_dense_emit():
    """A dense pattern's selector raises on its second match batch: that
    one pending batch is dropped and logged, the matches before and
    after it are delivered, and a plain query on the same stream is
    untouched.  The listeners hear the same in both packages: not the
    emit's error, but the dense engine's dropped-instance warning."""
    app = ("@app:playback @app:execution('tpu') define stream Txn "
           "(card long, amount double); @info(name='p') from every "
           "a=Txn[amount > 20.0] -> b=Txn[amount > a.amount] select a.card "
           "as ac, b.amount as bm insert into M; @info(name='f') from "
           "Txn[amount > 50.0] select card, amount insert into B;")

    def setup(rt):
        qr = rt.query_runtimes["p"]
        orig, calls = qr.selector.process, []

        def flaky(batch, now):
            calls.append(len(batch))
            if len(calls) == 2:
                raise RuntimeError("selector failed")
            return orig(batch, now)

        qr.selector.process = flaky

    sends = events(40, seed=7)
    jgot, jerr = run(False, app, sends, setup, streams=("M", "B"))
    tgot, terr = run(True, app, sends, setup, streams=("M", "B"))
    assert tgot == jgot and terr == jerr == ["SiddhiAppRuntimeError"]
    assert tgot["M"] and tgot["B"]
    # the dropped batch's rows are missing in both
    full, _ = run(True, app, sends, streams=("M", "B"))
    assert len(full["M"]) > len(tgot["M"])
