"""Each of the 17 built-in windows of the port's host query runtime
(``siddhi_tpu_torch/ops/windows.py``) held against the JAX package's.

One seeded app a window, under ``@app:playback``: its query selects the
raw attributes with ``insert all events`` (current and expired events,
through a query callback that sees them apart) and a second query
aggregates over the same window, so batch windows' reset markers clear
the running sums.  The events come 1-400 ms apart over a few seconds of
event time, and events on a stream no query reads tick the clock past
the last event, so time windows expire and flush through the app
scheduler.  Outputs must be equal in order, with timestamps, expiry
flags and types, floats bit for bit.  The corpora's window apps
(``tests/test_windows.py``, ``tests/test_conformance_windows.py``) run
in ``tests/test_torch_query.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.extension import default_registry

DEFINE = ("@app:playback define stream S (sym string, p double, n int, "
          "ts long); define stream Tick (x int); ")

WINDOWS = {
    "length": "length(3)",
    "lengthBatch": "lengthBatch(4)",
    "time": "time(500 millisec)",
    "timeBatch": "timeBatch(1 sec)",
    "externalTime": "externalTime(ts, 700 millisec)",
    "externalTimeBatch": "externalTimeBatch(ts, 1 sec)",
    "timeLength": "timeLength(1 sec, 3)",
    "delay": "delay(300 millisec)",
    "sort": "sort(3, p, 'asc')",
    "frequent": "frequent(2, sym)",
    "lossyFrequent": "lossyFrequent(0.3, 0.05, sym)",
    "hopping": "hopping(1 sec, 500 millisec)",
    "batch": "batch()",
    "session": "session(500 millisec, sym)",
    "cron": "cron('*/1 * * * * ?')",
    "expression": "expression('count() <= 3')",
    "expressionBatch": "expressionBatch('sum(p) > 150.0')",
}


def sends(seed, n=40):
    """Seeded events on ``S`` (1-400 ms apart; ``ts`` a second, skewed
    event time), then three ``Tick`` events, 2 s apart."""
    rng = np.random.default_rng(seed)
    out, t = [], 1000
    for _ in range(n):
        t += int(rng.integers(1, 400))
        out.append(("S", [("A", "B", "C")[int(rng.integers(0, 3))],
                          float(np.round(rng.uniform(0, 100), 2)),
                          int(rng.integers(0, 9)),
                          t + int(rng.integers(-50, 50))], t))
    for _ in range(3):
        t += 2000
        out.append(("Tick", [0], t))
    return out


def run(port, app, events):
    mgr = SiddhiManager(device="cpu") if port else JaxManager()
    try:
        rt = mgr.create_siddhi_app_runtime(app)
        got = {"q": [], "Sums": []}

        def key(e):
            return (e.timestamp, e.is_expired,
                    tuple(v.hex() if isinstance(v, float) else v
                          for v in e.data))

        rt.add_callback("q", lambda ts, i, o: got["q"].append(
            (ts, [key(e) for e in i or []], [key(e) for e in o or []])))
        rt.add_callback("Sums", lambda evs: got["Sums"].extend(
            key(e) for e in evs))
        rt.start()
        for sid, row, ts in events:
            rt.get_input_handler(sid).send(row, timestamp=ts)
        rt.shutdown()
        return got
    finally:
        mgr.shutdown()


def test_every_builtin_window_is_registered():
    assert default_registry().names("window") == sorted(WINDOWS)


@pytest.mark.parametrize("window", list(WINDOWS.values()), ids=list(WINDOWS))
def test_window_as_the_reference(window):
    app = (DEFINE
           + f"@info(name='q') from S#window.{window} select sym, p, n "
             "insert all events into Out; "
           + f"@info(name='s') from S#window.{window} select sym, "
             "sum(p) as total, count() as c group by sym "
             "insert all events into Sums;")
    events = sends(len(window))
    want = run(False, app, events)
    got = run(True, app, events)
    assert got == want
    assert want["q"] and want["Sums"]
