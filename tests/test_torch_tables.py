"""The port's tables, record tables and on-demand queries held against
the JAX package's.

- the table corpora (``tests/test_tables.py``, ``test_record_tables.py``,
  ``test_on_demand.py``, ``test_conformance_tables.py``,
  ``test_conformance_tables2.py``, ``test_conformance_tables3.py``)
  replayed through both packages with ``test_torch_device_query.py``'s
  recorder, in the default mode and under ``@app:execution('tpu')``:
  the same events, the same rows from every ``rt.query(...)`` (or the
  same refusal), the same table contents when the test is over, the
  same ``lowering()`` and fallback WARNINGs;
- the corpus tests built on the JAX package's classes (a custom store
  subclassing ``InMemoryRecordStore``, ``TableCache`` and the store
  condition IR driven directly) run a second time as port twins: the
  same test code with its imports pointed at the port, asserting the
  corpus's own expectations (``TWINS``).  The corpus's store double
  ``testStoreContainingInMemoryTable`` has its port twin registered
  here;
- seeded apps: a dense pattern under ``execution('tpu')`` with emit
  depth 4 inserting into a table that ``rt.query`` then reads, writes
  and reads again (the pull barrier drains the queued emits first),
  ``in Table`` filters in both modes, and a ``@store(ref=...)`` table
  whose options come from the config manager.
"""

from __future__ import annotations

import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.util import config as jconfig
from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.extension.registry import extension
from siddhi_tpu_torch.table import InMemoryRecordStore
from siddhi_tpu_torch.util import config as tconfig
from test_torch_device_query import (  # noqa: F401 (a fixture)
    _ev_row,
    check_scenario,
    corpus_cases,
    one_torch_thread,
    record,
    same_rows,
)

TESTS = Path(__file__).resolve().parent
CORPORA = ("test_tables", "test_record_tables", "test_on_demand",
           "test_conformance_tables", "test_conformance_tables2",
           "test_conformance_tables3")
# corpus tests built on the JAX package's classes: the recorder replays
# apps, not these, so each runs as a port twin below
TWINS = {
    ("test_record_tables", "TestRecordTable", "test_custom_store_spi"):
        "a store subclassing InMemoryRecordStore, set as an extension",
    ("test_record_tables", "TestStoreConditionIR", None):
        "the store condition IR evaluated directly",
    ("test_record_tables", "TestTableCache", "test_fifo_eviction"):
        "TableCache driven directly",
    ("test_record_tables", "TestTableCache", "test_lru_eviction"):
        "TableCache driven directly",
    ("test_record_tables", "TestTableCache", "test_lfu_eviction"):
        "TableCache driven directly",
    ("test_record_tables", "TestTableCache",
     "test_shared_store_uses_shared_lock"):
        "InMemoryRecordStore driven directly",
    ("test_record_tables", "TestCacheRetention", "test_entries_expire"):
        "TableCache driven directly",
    ("test_record_tables", "TestCacheRetention", "test_put_sweeps_expired"):
        "TableCache driven directly",
}
LEFT_OUT = dict(TWINS)
CASES = corpus_cases(CORPORA, LEFT_OUT)
MODES = {"default": "", "tpu": "@app:execution('tpu')"}


@extension("store", "testStoreContainingInMemoryTable")
class _TestStoreContainingInMemoryTable(InMemoryRecordStore):
    """The port twin of ``test_conformance_tables.py``'s store double."""


def test_the_corpora_were_read():
    assert len(CASES) >= 90
    assert {c[0] for c in CASES} == set(CORPORA)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize(
    "corpus,cname,mname,k", CASES,
    ids=[f"{c[0][5:]}:{c[1] or ''}.{c[2]}" + (f"-{c[3]}" if c[3] else "")
         for c in CASES])
def test_table_corpus_as_the_reference(corpus, cname, mname, k, mode):
    scenarios, _engines = record(corpus, cname, mname, k, mode=MODES[mode])
    assert scenarios, "the corpus test created no app"
    for sc in scenarios:
        check_scenario(sc)


# -- port twins ----------------------------------------------------------------


def port_twin(corpus: str):
    """The corpus module with its imports pointed at the port, and its
    ``SiddhiManager`` the port's on the CPU."""
    src = (TESTS / f"{corpus}.py").read_text()
    src = src.replace("from siddhi_tpu.", "from siddhi_tpu_torch.")
    src = src.replace("from siddhi_tpu import", "from siddhi_tpu_torch import")
    spec = importlib.util.spec_from_loader(f"_{corpus}_port_twin",
                                           loader=None)
    mod = importlib.util.module_from_spec(spec)
    exec(compile(src, f"{corpus}_port_twin", "exec"), mod.__dict__)
    mod.SiddhiManager = lambda *a, **kw: SiddhiManager(device="cpu")
    return mod


def twin_cases(twins):
    out = []
    for (corpus, cname, mname) in twins:
        if mname is not None:
            out.append((corpus, cname, mname))
            continue
        cls = getattr(port_twin(corpus), cname)
        out.extend((corpus, cname, m) for m in sorted(vars(cls))
                   if m.startswith("test_"))
    return out


def run_twin(corpus, cname, mname):
    mod = port_twin(corpus)
    fn = getattr(getattr(mod, cname)(), mname) if cname else getattr(mod,
                                                                    mname)
    kwargs = {}
    m = None
    if "manager" in inspect.signature(fn).parameters:
        m = kwargs["manager"] = SiddhiManager(device="cpu")
    try:
        fn(**kwargs)
    finally:
        if m is not None:
            m.shutdown()


@pytest.mark.parametrize("corpus,cname,mname", twin_cases(TWINS),
                         ids=lambda v: str(v))
def test_port_twin_of_the_corpus(corpus, cname, mname):
    """The corpus test's own calls and assertions, on the port's
    classes."""
    run_twin(corpus, cname, mname)


# -- seeded apps -----------------------------------------------------------------


def both(app, steps, mgr_setup=None):
    """Each package's rows of every pull query and callback, in order,
    for the same app and steps (``("send", stream, row, ts)`` or
    ``("query", q)``); a pull that raises gives ``"raises"``."""
    out = []
    for mgr in (JaxManager(), SiddhiManager(device="cpu")):
        try:
            if mgr_setup is not None:
                mgr_setup(mgr)
            rt = mgr.create_siddhi_app_runtime(app)
            got = []
            if "O" in rt.junctions:
                rt.add_callback("O", lambda evs: got.append(
                    [_ev_row(e) for e in evs]))
            rt.start()
            for step in steps:
                if step[0] == "send":
                    rt.get_input_handler(step[1]).send(step[2], step[3])
                    continue
                try:
                    got.append((step[1], [_ev_row(e)
                                          for e in rt.query(step[1])]))
                except Exception:
                    got.append((step[1], "raises"))
            out.append((got, rt.lowering()))
            rt.shutdown()
        finally:
            mgr.shutdown()
    return out


def assert_same(jgot, tgot):
    assert len(jgot) == len(tgot)
    for j, t in zip(jgot, tgot):
        if isinstance(j, tuple):
            assert j[0] == t[0]
            if j[1] == "raises" or t[1] == "raises":
                assert j[1] == t[1], j[0]
                continue
            j, t = j[1], t[1]
        assert [r[:2] for r in j] == [r[:2] for r in t]
        assert same_rows([r[2] for r in j], [r[2] for r in t], None), (j, t)


BARRIER_APP = (
    "@app:playback @app:execution('tpu', emit.depth='4') "
    "define stream Txn (card long, amount double); "
    "define table Alerts (card long, amount double); "
    "@info(name='p') from every e1=Txn[amount > 100.0] -> "
    "e2=Txn[card == e1.card and amount > e1.amount] "
    "select e1.card as card, e2.amount as amount insert into Alerts;")


def test_pull_barrier_drains_a_dense_pattern_into_its_table():
    """A dense pattern under ``execution('tpu')`` with queued emits
    writes a table; every pull (FIND, update, delete, update or insert)
    sees what the synchronous path would have written."""
    rng = np.random.default_rng(11)
    steps = []
    t = 1000
    for i in range(120):
        t += int(rng.integers(1, 20))
        steps.append(("send", "Txn", [int(rng.integers(0, 6)),
                                      float(rng.integers(50, 400))], t))
        if i % 17 == 16:
            steps.append(("query", "from Alerts select card, amount;"))
        if i == 60:
            steps.append(("query", "select 1L as card, 999.0 as amount "
                                   "update Alerts set Alerts.amount = amount "
                                   "on Alerts.card == card;"))
        if i == 80:
            steps.append(("query", "select 2L as card delete Alerts "
                                   "on Alerts.card == card;"))
        if i == 100:
            steps.append(("query", "select 77L as card, 1.5 as amount "
                                   "update or insert into Alerts "
                                   "set Alerts.amount = amount "
                                   "on Alerts.card == card;"))
    steps.append(("query", "from Alerts on amount > 200.0 select card, "
                           "sum(amount) as total group by card "
                           "having total > 0.0 order by card;"))
    (jgot, jlow), (tgot, tlow) = both(BARRIER_APP, steps)
    assert tlow == jlow == {"p": "dense"}
    assert_same(jgot, tgot)
    assert any(len(r[1]) for r in tgot if isinstance(r, tuple))


@pytest.mark.parametrize("mode", ["", "@app:execution('tpu') "])
def test_in_table_filters_as_the_reference(mode):
    app = ("@app:playback " + mode +
           "define stream S (sym string, v int); "
           "define stream Ban (sym string); "
           "define stream Lim (v int); "
           "@PrimaryKey('sym') define table Banned (sym string); "
           "define table Limits (v int); "
           "from Ban insert into Banned; from Lim insert into Limits; "
           "@info(name='q') from S[not (sym in Banned)] select sym, v "
           "insert into O; "
           "@info(name='r') from S[(v == Limits.v) in Limits] select sym, v "
           "insert into O;")
    rng = np.random.default_rng(5)
    steps = []
    for i in range(40):
        which = int(rng.integers(0, 3))
        if which == 0:
            steps.append(("send", "Ban", [f"s{int(rng.integers(5))}"], i))
        elif which == 1:
            steps.append(("send", "Lim", [int(rng.integers(0, 6))], i))
        else:
            steps.append(("send", "S", [f"s{int(rng.integers(5))}",
                                        int(rng.integers(0, 6))], i))
    (jgot, jlow), (tgot, tlow) = both(app, steps)
    assert tlow == jlow
    assert_same(jgot, tgot)


def test_store_ref_from_the_config_manager():
    """``@store(ref='store1')``: the type and options from the config
    manager's refs, inline options winning; the same rows read back."""
    system = {"store1": {"type": "memory", "topic": "t1"}}

    def setup(mgr):
        cfg = jconfig if isinstance(mgr, JaxManager) else tconfig
        mgr.set_config_manager(cfg.InMemoryConfigManager({}, system))

    app = ("@app:playback define stream S (v long); "
           "@store(ref='store1') define table T (v long); "
           "from S select v insert into T;")
    steps = [("send", "S", [7], 1), ("send", "S", [9], 2),
             ("query", "from T select v;"),
             ("query", "from T on v > 8L select v;")]
    (jgot, _jlow), (tgot, _tlow) = both(app, steps, setup)
    assert_same(jgot, tgot)
    assert [r[2] for r in tgot[0][1]] == [(7,), (9,)]
