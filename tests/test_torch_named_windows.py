"""The port's named windows and triggers held against the JAX package's.

- the corpora (``tests/test_named_windows_triggers.py``,
  ``test_conformance_named_windows.py``) replayed through both packages
  with ``test_torch_device_query.py``'s recorder (every app under
  ``@app:playback``), in the default mode and under
  ``@app:execution('tpu')``: the same events, tables, ``lowering()`` and
  fallback WARNINGs;
- the corpus tests the recorder cannot replay run as port twins (the
  same test code with its imports pointed at the port): the cron
  schedule driven directly, and concurrent senders, whose recorded send
  order need not be the order the JAX run processed them in;
- triggers under ``@app:playback``: periodic, cron and start triggers
  fire on event time as sends advance the clock, alone and feeding a
  named window, a join and an aggregating query, with the same events
  in both packages.
"""

from __future__ import annotations

import numpy as np
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
from test_torch_tables import run_twin, twin_cases

CORPORA = ("test_named_windows_triggers", "test_conformance_named_windows")
TWINS = {
    ("test_named_windows_triggers", None, "test_cron_every_five_seconds"):
        "CronSchedule driven directly",
    ("test_named_windows_triggers", None, "test_cron_unix_five_field_daily"):
        "CronSchedule driven directly",
    ("test_named_windows_triggers", None, "test_cron_day_of_week"):
        "CronSchedule driven directly",
    ("test_conformance_named_windows", "TestJunctionTopologies",
     "test_multithreaded_producers"):
        "concurrent senders: the recorded send order is not the order "
        "the JAX run processed them in",
}
LEFT_OUT = dict(TWINS)
CASES = corpus_cases(CORPORA, LEFT_OUT)
MODES = {"default": "", "tpu": "@app:execution('tpu')"}


def test_the_corpora_were_read():
    assert len(CASES) >= 15
    assert {c[0] for c in CASES} == set(CORPORA)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize(
    "corpus,cname,mname,k", CASES,
    ids=[f"{c[0][5:]}:{c[1] or ''}.{c[2]}" + (f"-{c[3]}" if c[3] else "")
         for c in CASES])
def test_window_corpus_as_the_reference(corpus, cname, mname, k, mode):
    scenarios, _engines = record(corpus, cname, mname, k, mode=MODES[mode])
    assert scenarios, "the corpus test created no app"
    for sc in scenarios:
        check_scenario(sc)


@pytest.mark.parametrize("corpus,cname,mname", twin_cases(TWINS),
                         ids=lambda v: str(v))
def test_port_twin_of_the_corpus(corpus, cname, mname):
    run_twin(corpus, cname, mname)


# -- triggers on event time ------------------------------------------------------

TRIGGER_APPS = {
    "periodic": "define trigger T at every 100 milliseconds; "
                "define stream S (v int); "
                "from T select triggered_time insert into O;",
    "cron": "define trigger T at '*/2 * * * * ?'; "
            "define stream S (v int); "
            "from T select triggered_time insert into O;",
    "start": "define trigger T at 'start'; define stream S (v int); "
             "from T select triggered_time insert into O;",
    "window": "define trigger T at every 250 milliseconds; "
              "define stream S (v int); "
              "define window W (v int) length(3) output all events; "
              "from S insert into W; "
              "from T join W select T.triggered_time as t, W.v as v "
              "insert into O;",
    "join": "define trigger T at every 300 milliseconds; "
            "define stream S (v int); "
            "from T#window.length(1) join S#window.length(4) "
            "select T.triggered_time as t, S.v as v insert into O;",
    "count": "define trigger T at every 200 milliseconds; "
             "define stream S (v int); "
             "from T#window.time(1 sec) select count() as n insert into O;",
}


@pytest.mark.parametrize("mode", ["", "@app:execution('tpu') "])
@pytest.mark.parametrize("name", list(TRIGGER_APPS))
def test_trigger_on_event_time_as_the_reference(name, mode):
    app = "@app:playback " + mode + TRIGGER_APPS[name]
    rng = np.random.default_rng(len(name))
    sends, t = [], 10_000
    for _ in range(40):
        t += int(rng.integers(1, 250))
        sends.append(([int(rng.integers(0, 100))], t))
    outs = []
    for mgr in (JaxManager(), SiddhiManager(device="cpu")):
        try:
            rt = mgr.create_siddhi_app_runtime(app)
            got = []
            rt.add_callback("O", lambda evs: got.extend(_ev_row(e)
                                                        for e in evs))
            rt.start()
            h = rt.get_input_handler("S")
            for row, ts in sends:
                h.send(row, ts)
            outs.append((got, rt.lowering()))
            rt.shutdown()
        finally:
            mgr.shutdown()
    (jgot, jlow), (tgot, tlow) = outs
    assert tlow == jlow
    assert [r[:2] for r in tgot] == [r[:2] for r in jgot]
    assert same_rows([r[2] for r in jgot], [r[2] for r in tgot], None)
    assert tgot
