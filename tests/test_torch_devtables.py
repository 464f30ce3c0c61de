"""Device tables (``@app:devtables``) held against the JAX package's.

``tests/test_devtable.py`` runs through both packages by
``test_torch_persistence.py``'s twin runs: each case passes its own
assertions in both (device table against the host table bit for bit,
duplicate keys last-writer-wins in one batch, mutations straddling
probes, crash and journal replay, the async persist of the pinned
revision, compaction then demotion, the annotation's checks, the
record-table cache) and both deliver the same events.

Every case of the file runs: the corpus reads each package's
statistics feed (``rt.statistics()``: the device table's counters, its
fallback reasons) and arms the transient ``ingest.put`` and
``emit.drain`` faults.  What the port holds besides:

- the ineligible table once more on its own: the same WARNING, rows
  and lowering, and the port's ``devtable_fallbacks`` equal to the
  reference's counted reasons;
- the transient-fault app with both feeds' fault counters;
- the port's own: the scatter's last-writer-wins winner against the
  reference's one-hot argmax, the probe's slot against the reference's
  ``[B, C]`` argmax, a scatter leaving the pinned revision's tensors
  as they were (out of place), and an async persist committing the
  revision pinned at its barrier while later batches mutate the table.
"""

from __future__ import annotations

import importlib.util
import logging
import pickle
import threading

import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.devtable import DeviceTable
from siddhi_tpu_torch.devtable.storage import scatter_step
from siddhi_tpu_torch.util.persistence import InMemoryPersistenceStore
from test_torch_device_query import one_torch_thread  # noqa: F401
from test_torch_done_slices import INNER, stand_ins
from test_torch_persistence import TESTS, cases, check_twin

pytestmark = pytest.mark.faults

CASES = cases("test_devtable", {})
INNER_DT = INNER + ("siddhi_tpu.devtable", "siddhi_tpu.durability",
                    "siddhi_tpu.util.persistence")


def _corpus():
    spec = importlib.util.spec_from_file_location(
        "_devtable_apps", TESTS / "test_devtable.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DT = _corpus()


def test_the_corpus_was_read():
    assert len(CASES) == 15


@pytest.mark.parametrize("corpus,cname,mname,k", CASES)
def test_devtable_corpus_as_the_reference(corpus, cname, mname, k, tmp_path,
                                          request):
    check_twin(corpus, cname, mname, k, tmp_path, request, inner=INNER_DT,
               stand_ins=stand_ins)


# -- the twins -----------------------------------------------------------------

INELIGIBLE = (
    "@app:name('dt2') @app:playback @app:execution('tpu') "
    "@app:devtables(capacity='8') "
    "define stream S (sym string, x float); "
    "define stream Ins (sym string, v float); "
    "@PrimaryKey('sym') define table T (sym string, v float); "
    "from Ins insert into T; "
    "@info(name='j') from S join T as t on S.sym == t.sym "
    "select S.sym as sym, t.v as v insert into Out;")


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _ineligible_run(make, logger):
    h = _Warnings()
    log = logging.getLogger(logger)
    log.addHandler(h)
    try:
        m = make()
        rt = m.create_siddhi_app_runtime(INELIGIBLE)
        got = []
        rt.add_callback("Out", lambda evs: got.extend(tuple(e.data)
                                                      for e in evs))
        rt.start()
        table = rt.tables["T"]
        low = rt.lowering()
        rt.get_input_handler("Ins").send(["IBM", 9.0], timestamp=1000)
        rt.get_input_handler("S").send(["IBM", 0.5], timestamp=1010)
        ctx = rt.app_context
        reasons = (dict(ctx.devtable_fallbacks)
                   if hasattr(ctx, "devtable_fallbacks")
                   else dict(ctx.statistics_manager.devtable_fallback_reasons))
        rt.shutdown()
        m.shutdown()
        return table, low, got, h.messages, reasons
    finally:
        log.removeHandler(h)


def test_ineligible_table_as_the_reference():
    jt, jlow, jgot, jwarn, jreasons = _ineligible_run(
        siddhi_tpu.SiddhiManager, "siddhi_tpu")
    pt, plow, pgot, pwarn, preasons = _ineligible_run(
        lambda: siddhi_tpu_torch.SiddhiManager(device="cpu"),
        "siddhi_tpu_torch")
    assert not isinstance(pt, DeviceTable)
    assert plow == jlow and plow["j"] != "devtable"
    assert pgot == jgot == [("IBM", np.float32(9.0))]
    dt = [w for w in jwarn if "devtable" in w or "host-resident" in w]
    assert dt and [w for w in pwarn if w in dt] == dt
    assert preasons == jreasons and preasons


def test_transient_fault_sites_wait_for_item_15b():
    """Its name kept from when the port refused the sites: the corpus's
    device-table app with transient ``ingest.put`` and ``emit.drain``
    faults runs in both packages with the same rows, the same table and
    the same retry counters on both statistics feeds."""
    faults = ("transfer.retry.scale='0.0001', "
              "ingest.put='transient:count=2', "
              "emit.drain='transient:count=2'")
    app = ("@app:name('dt') @app:playback @app:execution('tpu') "
           f"@app:devtables(capacity='64') @app:faults({faults}) " + DT.BODY)
    ops = DT.ops_series(50, seed=29)
    out = []
    for make in (siddhi_tpu.SiddhiManager,
                 lambda: siddhi_tpu_torch.SiddhiManager(device="cpu")):
        m = make()
        rt = m.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback("Out", lambda evs: got.extend(tuple(e.data)
                                                      for e in evs))
        rt.start()
        ts = 1000
        for stream, row in ops:
            rt.get_input_handler(stream).send(list(row), timestamp=ts)
            ts += 10
        rt.drain_device_emits()
        b = rt.tables["T"].rows_batch()
        rows = sorted(tuple(b.columns[nm][i] for nm in b.attribute_names)
                      for i in range(len(b)))
        st = {k.rsplit(".", 1)[1]: v for k, v in rt.statistics().items()
              if ".Faults.injector." in k}
        low = rt.lowering()
        rt.shutdown()
        m.shutdown()
        out.append((got, rows, st, low))
    (jgot, jrows, jst, jlow), (pgot, prows, pst, plow) = out
    assert plow == jlow and plow["j"] == "devtable"
    assert pgot == jgot and prows == jrows
    for key in ("faults_injected", "transfer_retries", "drains_recovered",
                "drains_failed"):
        assert pst[key] == jst[key], key


# -- the scatter and the probe against the reference's formulations -----------

def _onehot_lww(cols, valid, vals, w, k):
    """The reference's scatter body in numpy: an ``[N, C]`` one-hot
    plane, the last writer by argmax over the row order."""
    cap = len(valid)
    lane = np.arange(cap)[None, :]
    w1h = w[:, None] == lane
    touched = w1h.any(axis=0)
    order = np.arange(1, len(w) + 1)[:, None]
    winner = np.argmax(np.where(w1h, order, 0), axis=0)
    out = {nm: (c if nm not in vals else np.where(touched, vals[nm][winner],
                                                  c))
           for nm, c in cols.items()}
    killed = (k[:, None] == lane).any(axis=0)
    return out, (valid | touched) & ~killed


@pytest.mark.parametrize("seed", range(6))
def test_scatter_winner_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    cap, n = 37, 64
    cols = {"v": rng.normal(size=cap).astype(np.float32),
            "k": rng.integers(-9, 9, cap).astype(np.int32)}
    valid = rng.random(cap) < 0.5
    w = rng.integers(-1, cap, n).astype(np.int32)  # -1: inert, many dups
    k = rng.integers(-1, cap, 8).astype(np.int32)
    vals = {"v": rng.normal(size=n).astype(np.float32)}
    want, want_valid = _onehot_lww(cols, valid, vals, w, k)
    t = {nm: torch.from_numpy(c.copy()) for nm, c in cols.items()}
    got, got_valid = scatter_step(
        t, torch.from_numpy(valid.copy()),
        {"v": torch.from_numpy(vals["v"])}, torch.from_numpy(w),
        torch.from_numpy(k))
    for nm in cols:
        assert np.array_equal(got[nm].numpy(), want[nm]), nm
        # out of place: the inputs keep their values
        assert np.array_equal(t[nm].numpy(), cols[nm]), nm
    assert np.array_equal(got_valid.numpy(), want_valid)


def _table(cap, device="cpu"):
    from siddhi_tpu_torch.compiler import SiddhiCompiler

    app = SiddhiCompiler.parse(
        "@PrimaryKey('k') define table T (k int, v float, f bool);")
    return DeviceTable(app.table_definitions["T"], capacity=cap,
                       device=device)


def test_probe_slot_as_the_reference_argmax():
    """The probe's slot and match flag equal the reference's ``[B, C]``
    key match and argmax, over a table with tombstones, reused slots and
    keys on invalid slots."""
    from siddhi_tpu_torch.core.event import EventBatch

    rng = np.random.default_rng(5)
    t = _table(64)
    for i in range(6):
        keys = rng.integers(-40, 40, 24).astype(np.int32)
        t.insert(EventBatch("T", ["k", "v", "f"], {
            "k": keys, "v": rng.normal(size=24).astype(np.float32),
            "f": rng.random(24) < 0.5}, np.full(24, i, dtype=np.int64)))
        t.delete_keys(rng.integers(-40, 40, 10).astype(np.int32))
        t.drain()
    cols, valid, key_index = t.device_state()
    probe_keys = rng.integers(-50, 50, 256).astype(np.int32)
    pk, v = cols["k"].numpy(), valid.numpy()
    oneh = (probe_keys[:, None] == pk[None, :]) & v[None, :]
    want_matched = oneh.any(axis=1)
    want_slot = np.argmax(oneh, axis=1)
    skeys, sslots = key_index
    kk = torch.from_numpy(probe_keys).long()
    pos = torch.searchsorted(skeys, kk).clamp_max(len(skeys) - 1)
    matched = (skeys[pos] == kk).numpy()
    slot = sslots[pos].numpy()
    assert want_matched.any() and not want_matched.all()
    assert np.array_equal(matched, want_matched)
    assert np.array_equal(slot[matched], want_slot[want_matched])


def test_scatter_leaves_the_pinned_revision_as_it_was():
    """Every scatter writes new tensors: the revision pinned at a
    barrier, and the tensors a probe was dispatched against, keep their
    values while later batches mutate the table."""
    from siddhi_tpu_torch.core.event import EventBatch

    t = _table(16)

    def ins(keys, v):
        n = len(keys)
        t.insert(EventBatch("T", ["k", "v", "f"], {
            "k": np.asarray(keys, dtype=np.int32),
            "v": np.full(n, v, dtype=np.float32),
            "f": np.ones(n, dtype=bool)}, np.zeros(n, dtype=np.int64)))

    ins([1, 2, 3], 1.0)
    t.drain()
    pinned = {nm: c for nm, c in t._pinned["cols"].items()}
    before = {nm: c.clone() for nm, c in pinned.items()}
    probed, valid_probed, _ = t.device_state()
    valid_before = valid_probed.clone()
    ins([2, 4], 5.0)
    t.update_keys(np.array([1], dtype=np.int32),
                  {"v": np.array([7.0], dtype=np.float32)})
    t.delete_keys(np.array([3], dtype=np.int32))
    for nm in before:
        assert torch.equal(pinned[nm], before[nm]), nm
        assert torch.equal(probed[nm], before[nm]), nm
    assert torch.equal(valid_probed, valid_before)
    snap = t.snapshot()
    assert sorted(snap["cols"]["v"].tolist()) == [1.0, 1.0, 1.0]
    t.drain()
    assert sorted(t.snapshot()["cols"]["v"].tolist()) == [5.0, 5.0, 7.0]


def test_async_persist_commits_the_barrier_revision():
    """Block the checkpoint writer, persist async, send batches that
    upsert and delete rows, then release the writer: the committed
    table is the one a sync ``snapshot()`` gave at the persist point."""
    app = ("@app:name('dtpin') @app:playback @app:execution('tpu') "
           "@app:devtables(capacity='64') " + DT.BODY)
    ops = DT.ops_series(60, seed=11)
    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    store = InMemoryPersistenceStore()
    m.set_persistence_store(store)
    try:
        rt = m.create_siddhi_app_runtime(app)
        rt.start()
        hs = {s: rt.get_input_handler(s)
              for s in ("S", "Ins", "Del", "Upd", "Ups")}
        ts = 1000
        for stream, row in ops[:30]:
            hs[stream].send(list(row), timestamp=ts)
            ts += 10
        gate = threading.Event()
        writer = rt._durability_writer()
        writer.submit("blocker", lambda: gate.wait(30))
        rev = rt.persist(mode="async")
        at_persist = pickle.loads(rt.snapshot())["tables"]["T"]
        for stream, row in ops[30:]:
            hs[stream].send(list(row), timestamp=ts)
            ts += 10
        after = pickle.loads(rt.snapshot())["tables"]["T"]
        assert after["revision"] > at_persist["revision"]
        gate.set()
        assert rt.wait_for_persist(rev, timeout=30) == "committed"
        committed = pickle.loads(store.load("dtpin", rev))["tables"]["T"]
        assert committed["revision"] == at_persist["revision"]
        assert np.array_equal(committed["ts"], at_persist["ts"])
        for nm in ("k", "v", "f"):
            assert np.array_equal(committed["cols"][nm],
                                  at_persist["cols"][nm]), nm
        rt.shutdown()
    finally:
        m.shutdown()
