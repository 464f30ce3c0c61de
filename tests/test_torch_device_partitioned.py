"""The port's partitioned device queries held against the JAX package's.

``tests/test_device_partitioned.py`` replayed through both packages, as
``test_torch_device_query.py`` replays the single-stream corpora: every
app its tests create under ``@app:execution('tpu')`` whose partition
the JAX package lowers to its device paths (filters, running
aggregates, per-key sliding windows, group by inside a key, range
partitions, a pattern beside a filter, ``@purge``), with its sends,
lowering and output, goes through ``SiddhiManager(device="cpu")``.
Where the JAX package runs the body on per-key host instances (no
``execution('tpu')``, a tumbling window, a rate limit, order by), so
does the port, with the same WARNING.  Output rows are compared
in order; the bounds are the ones ``test_torch_device_query.py`` states
(float32 sums within the reference's ``rel=1e-4, abs=1e-3``, stdDev
within its ``rel=2e-3, abs=5e-3``, everything else exact).
"""

from __future__ import annotations

import pytest

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager
from test_torch_device_query import (  # noqa: F401 (a fixture)
    _ev_row,
    check_scenario,
    corpus_cases,
    one_torch_thread,
    record,
    same_rows,
)

# the app's persist and restore_revision (item 11); the device runtime's
# snapshot contract is held in test_torch_device_query.py
LEFT_OUT = {("test_device_partitioned", "TestPartitionedDevicePersistence",
             None): "app persistence (item 11)"}
CASES = corpus_cases(("test_device_partitioned",), LEFT_OUT)


def test_the_corpus_was_read():
    assert len(CASES) >= 40


@pytest.mark.parametrize(
    "corpus,cname,mname,k", CASES,
    ids=[f"{c[1] or ''}.{c[2]}" + (f"-{c[3]}" if c[3] else "")
         for c in CASES])
def test_partitioned_corpus_as_the_reference(corpus, cname, mname, k):
    scenarios, _engines = record(corpus, cname, mname, k)
    assert scenarios, "the corpus test created no app"
    for sc in scenarios:
        check_scenario(sc)


def test_purge_recycles_rows_as_the_reference():
    """``@purge`` on a partitioned running count and a per-key sliding
    sum at two key rows: idle keys are purged on the watermark, their
    rows recycled for new keys, and a returning key starts afresh, in
    both packages alike."""
    app = ("@app:playback @app:execution('tpu', partitions='2') "
           "define stream S (user string, v double); "
           "@purge(enable='true', interval='1 sec', idle.period='2 sec') "
           "partition with (user of S) begin "
           "@info(name='c') from S select user, count() as n insert into "
           "C; @info(name='w') from S#window.length(2) select user, "
           "sum(v) as s insert into W; end;")
    sends = [("a", 1.0, 1000), ("b", 2.0, 1001), ("a", 3.0, 1500),
             ("c", 4.0, 60_000), ("a", 5.0, 60_001), ("c", 6.0, 60_002),
             ("d", 7.0, 200_000), ("b", 8.0, 200_001)]

    def run(port):
        mgr = SiddhiManager(device="cpu") if port else JaxManager()
        try:
            rt = mgr.create_siddhi_app_runtime(app)
            got = []
            for out in ("C", "W"):
                rt.add_callback(out, lambda evs: got.extend(
                    _ev_row(e) for e in evs))
            rt.start()
            for u, v, t in sends:
                rt.get_input_handler("S").send([u, v], timestamp=t)
            low = rt.lowering()
            rt.shutdown()
            return got, low
        finally:
            mgr.shutdown()

    jgot, jlow = run(False)
    tgot, tlow = run(True)
    assert tlow == jlow == {"c": "device", "w": "device"}
    assert [r[:2] for r in tgot] == [r[:2] for r in jgot]
    assert same_rows([r[2] for r in jgot], [r[2] for r in tgot], None)
    # b comes back at 200,001 after its purge: a fresh count, and a
    # window holding its one new event
    assert [r[2] for r in tgot[-2:]] == [("b", 1), ("b", 8.0)]
