"""The port's checkpoint pipeline held against the JAX package's.

Three kinds of case:

- ``tests/test_durability.py`` replayed through both packages by
  ``test_torch_persistence.py``'s twin runs: the async crash matrix
  (every durability step killed, on the device query path, the
  multiplexed tumbling group and the hot-key router) and the sync one, the mid-spill crash, checksummed
  manifests (a flipped byte walks back), async == sync, chain hygiene,
  the bounded store, the writer units, the persist annotation and
  daemon, the service's persist and restore endpoints, the
  durability counters on the statistics feed, and the journal segments
  of the file store; two cases that read the counters are held once
  more below, each package's ``DurabilityStats`` read directly;
- the in-place capture hazard the port has and the reference cannot:
  its steps write the state tensors in place, so an async persist whose
  capture kept them by reference would commit the state of a later
  batch;
- a revision one package writes restoring in the other, for a dense
  pattern app and a device query app.
"""

from __future__ import annotations

import pickle
import threading

import numpy as np
import pytest
import torch

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.durability import (
    DurableFileSystemPersistenceStore as JaxDurableStore,
)
from siddhi_tpu.util.persistence import (
    FileSystemPersistenceStore as JaxFileStore,
)
from siddhi_tpu.util.faults import poison_state as jax_poison_state
from siddhi_tpu.util.faults import state_has_poison as jax_has_poison
from siddhi_tpu.util.persistence import (
    IncrementalFileSystemPersistenceStore as JaxIncrementalStore,
)
from siddhi_tpu_torch import (
    DurableFileSystemPersistenceStore,
    FileSystemPersistenceStore,
    IncrementalFileSystemPersistenceStore,
    InMemoryPersistenceStore,
    SiddhiManager,
)
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.durability import freeze
from siddhi_tpu_torch.util.faults import (
    host_copy,
    poison_state,
    state_has_poison,
)
from test_torch_device_query import one_torch_thread  # noqa: F401
from test_torch_device_query import bound, same_rows
from test_torch_persistence import INNER_IMPORTS, cases, check_twin

pytestmark = pytest.mark.faults

# what waits for a later slice, with its ROADMAP.md item, or is held
# below by the test named beside it
LEFT_OUT_PARAMS = {"sharded": "the sharded engine (item 16)"}
CASES = cases("test_durability", {}, LEFT_OUT_PARAMS)


def test_the_corpus_was_read():
    assert len(CASES) == 39


@pytest.mark.parametrize("corpus,cname,mname,k", CASES)
def test_durability_corpus_as_the_reference(corpus, cname, mname, k,
                                            tmp_path, request):
    check_twin(corpus, cname, mname, k, tmp_path, request,
               inner=INNER_IMPORTS + ("siddhi_tpu.service",))


# -- two corpus cases once more, the counters read directly -------------------

KV_BODY = ("define stream S (k long, v double); "
           "@info(name='q') from S#window.length(4) "
           "select k, sum(v) as s group by k insert into Out;")
HOST_PATTERN = ("define stream S (k long, v double); "
                "@info(name='q') from every e1=S[v > 50.0] "
                "-> e2=S[v > e1.v] within 10 sec "
                "select e1.v as a, e2.v as b insert into Out;")


def kv_series(n, seed):
    """``tests/test_durability.py``'s ``kv_series``."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 3, size=n)
    vals = rng.integers(1, 100, size=n).astype(float)
    ts = 1000 + np.arange(n) * 250
    return [([int(k), float(v)], int(t)) for k, v, t in zip(keys, vals, ts)]


def _manager(port):
    return SiddhiManager(device="cpu") if port else JaxManager()


def _collect(rt, got):
    rt.add_callback("Out", lambda evs: got.extend(tuple(e.data)
                                                  for e in evs))


def test_unfreezable_host_state_falls_back_counted(tmp_path):
    """The host pattern engine's instance lists cannot be frozen: they
    are pickled in the barrier, the async persist still commits, the
    fallback is counted, and restore reproduces the uninterrupted run in
    both packages."""
    sends = kv_series(24, seed=3)
    header = "@app:name('hostpat') @app:playback "
    out = {}
    for port in (False, True):
        m = _manager(port)
        try:
            rt = m.create_siddhi_app_runtime(header + HOST_PATTERN)
            ref = []
            _collect(rt, ref)
            rt.start()
            h = rt.get_input_handler("S")
            for row, ts in sends:
                h.send(list(row), timestamp=ts)
            rt.shutdown()
        finally:
            m.shutdown()
        m = _manager(port)
        store = DurableFileSystemPersistenceStore if port else JaxDurableStore
        m.set_persistence_store(store(str(tmp_path / str(port))))
        app = header + "@app:faults(journal='64') " + HOST_PATTERN
        try:
            rt = m.create_siddhi_app_runtime(app)
            got = []
            _collect(rt, got)
            rt.start()
            h = rt.get_input_handler("S")
            for row, ts in sends[:12]:
                h.send(list(row), timestamp=ts)
            rev = rt.persist(mode="async")
            assert rt.wait_for_persist(rev, timeout=30) == "committed"
            assert rt._durability_stats().capture_fallback_elements > 0
            rt.shutdown()
            rt2 = m.create_siddhi_app_runtime(app)
            _collect(rt2, got)
            rt2.start()
            assert rt2.restore_last_revision() == rev
            h2 = rt2.get_input_handler("S")
            for row, ts in sends[12:]:
                h2.send(list(row), timestamp=ts)
            rt2.shutdown()
        finally:
            m.shutdown()
        assert got == ref and ref
        out[port] = got
    assert out[True] == out[False]


def test_incremental_store_forces_counted_sync(tmp_path):
    """An async persist into an incremental store runs the sync path,
    counted as such; the base then restores to the same rows in both
    packages."""
    sends = kv_series(16, seed=11)
    app = ("@app:name('dur') @app:playback @app:faults(journal='256') "
           "@app:execution('tpu') " + KV_BODY)
    out = {}
    for port in (False, True):
        m = _manager(port)
        store = (IncrementalFileSystemPersistenceStore if port
                 else JaxIncrementalStore)
        m.set_persistence_store(store(str(tmp_path / str(port))))
        try:
            rt = m.create_siddhi_app_runtime(app)
            got = []
            _collect(rt, got)
            rt.start()
            h = rt.get_input_handler("S")
            for row, ts in sends[:8]:
                h.send(list(row), timestamp=ts)
            rt.persist(mode="async")
            assert rt._durability_stats().persists_sync == 1
            assert rt._durability_stats().persists_async == 0
            assert rt.wait_for_persist() == "idle"
            for row, ts in sends[8:12]:
                h.send(list(row), timestamp=ts)
            assert rt.restore_last_revision() is not None
            for row, ts in sends[12:]:
                h.send(list(row), timestamp=ts)
            rt.shutdown()
        finally:
            m.shutdown()
        out[port] = got
    assert same_rows(out[False], out[True], bound(app))
    assert out[True]


# -- the in-place capture hazard ---------------------------------------------

DENSE_APP = (
    "@app:name('inplace') @app:playback "
    "@app:execution('tpu', partitions='16', instances='4') "
    "define stream Txn (key long, v double); "
    "partition with (key of Txn) begin "
    "@info(name='q') from every e1=Txn[v > 1.0] -> e2=Txn[v > 2.0] "
    "-> e3=Txn[v > 3.0] within 10 min select e3.v as v insert into Alerts; "
    "end;")


def txn_batches(EventBatch, n, seed, size=64):
    rng = np.random.default_rng(seed)
    return [EventBatch("Txn", ["key", "v"],
                       {"key": rng.integers(0, 12, size).astype(np.int64),
                        "v": rng.uniform(0.0, 5.0, size)},
                       np.full(size, 1_000 + 10 * i, dtype=np.int64))
            for i in range(n)]


def same_tree(a, b):
    """Equal state trees: the same keys, types and array bits."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_tree(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    return type(a) is type(b) and a == b


def test_async_capture_is_not_overwritten_by_the_next_step():
    """Block the checkpoint writer, persist async (the capture queues
    behind the blocker), send a batch that steps the dense state in
    place, then release the writer: the committed tree is the state at
    the persist point, as a sync ``snapshot()`` taken there gives it."""
    from siddhi_tpu_torch.core.event import EventBatch

    m = SiddhiManager(device="cpu")
    store = InMemoryPersistenceStore()
    m.set_persistence_store(store)
    try:
        rt = m.create_siddhi_app_runtime(DENSE_APP)
        assert rt.lowering(step_kinds=True) == {"q": "dense/batch"}
        rt.start()
        h = rt.get_input_handler("Txn")
        batches = txn_batches(EventBatch, 5, seed=2)
        for b in batches[:4]:
            h.send_batch(b)
        gate = threading.Event()
        writer = rt._durability_writer()
        writer.submit("blocker", lambda: gate.wait(30))
        rev = rt.persist(mode="async")
        at_persist = pickle.loads(rt.snapshot())
        assert writer.status(rev) == "pending"
        h.send_batch(batches[4])
        after = pickle.loads(rt.snapshot())
        dense = ("partitions", "partition_0", "__dense__", "q", "pattern",
                 "dense_state")

        def pick(tree):
            for k in dense:
                tree = tree[k]
            return tree

        assert not same_tree(pick(at_persist), pick(after)), (
            "the last batch must step the state for the test to bite")
        gate.set()
        assert rt.wait_for_persist(rev, timeout=30) == "committed"
        committed = pickle.loads(store.load("inplace", rev))
        for kind in ("queries", "tables", "named_windows", "partitions",
                     "aggregations"):
            assert same_tree(committed[kind], at_persist[kind]), kind
        rt.shutdown()
    finally:
        m.shutdown()


def test_freeze_clones_tensors_and_copies_arrays():
    t = torch.arange(6, dtype=torch.int32)
    a = np.arange(4)
    out = freeze({"t": t, "a": [a], "n": 3})
    t += 10
    a += 10
    assert out["t"].tolist() == list(range(6)) and out["n"] == 3
    assert out["a"][0].tolist() == list(range(4))


def test_host_copy_and_poison_helpers_as_the_reference():
    """``host_copy`` fetches every tensor leaf of a tree to numpy (the
    containers new, other leaves kept); the poison helpers find and make
    NaN in the first float leaf, numpy or tensor, as the JAX package's
    do on numpy trees."""
    tree = {"a": torch.arange(4, dtype=torch.int32),
            "b": [torch.ones(2, 3), np.zeros(2, np.float32)], "n": 7}
    host = host_copy(tree)
    assert host["a"].dtype == np.int32 and host["a"].tolist() == [0, 1, 2, 3]
    assert host["b"][0].shape == (2, 3) and host["b"][1] is tree["b"][1]
    assert host["n"] == 7
    plain = {"i": np.arange(3), "f": [np.ones(3, np.float32)]}
    for pois, has in ((poison_state, state_has_poison),
                      (jax_poison_state, jax_has_poison)):
        assert not has(plain)
        bad = pois(plain)
        assert has(bad) and np.isnan(bad["f"][0]).all()
        assert bad["i"] is plain["i"] and not has(plain)
    bad = poison_state(tree)
    assert torch.isnan(bad["b"][0]).all() and state_has_poison(bad)
    assert not state_has_poison(tree)


# -- one package's revision restores in the other ----------------------------

CROSS_APPS = {
    "dense": (
        "@app:name('cross') @app:playback "
        "@app:execution('tpu', partitions='16', instances='4') "
        "define stream S (k long, v double); "
        "partition with (k of S) begin @info(name='q') from every "
        "a=S[v > 20.0] -> b=S[v > a.v] within 10 sec select a.v as av, "
        "b.v as bv insert into Out; end;"),
    "device_query": (
        "@app:name('cross') @app:playback @app:execution('tpu') "
        "define stream S (k long, v double); "
        "@info(name='q') from S#window.length(4) select k, sum(v) as s "
        "group by k insert into Out;"),
}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", sorted(CROSS_APPS))
def test_revision_restores_in_the_other_package(kind, writer, tmp_path):
    """The writer package persists mid-stream into a
    ``FileSystemPersistenceStore``; the other package's runtime of the
    same app restores the revision from the same directory and takes
    the rest of the stream.  Its rows equal the writer's uninterrupted
    run (float32 device sums within the device-query bound)."""
    app = CROSS_APPS[kind]
    sends = kv_series(40, seed=21)
    lowering = {"dense": {"q": "dense"}, "device_query": {"q": "device"}}
    port_writes = writer == "port"

    ref_m = _manager(port_writes)
    try:
        rt = ref_m.create_siddhi_app_runtime(app)
        ref = []
        _collect(rt, ref)
        rt.start()
        h = rt.get_input_handler("S")
        for row, ts in sends:
            h.send(list(row), timestamp=ts)
        rt.shutdown()
    finally:
        ref_m.shutdown()

    got = []
    m = _manager(port_writes)
    m.set_persistence_store((FileSystemPersistenceStore if port_writes
                             else JaxFileStore)(str(tmp_path)))
    try:
        rt = m.create_siddhi_app_runtime(app)
        assert rt.lowering() == lowering[kind]
        _collect(rt, got)
        rt.start()
        h = rt.get_input_handler("S")
        for row, ts in sends[:20]:
            h.send(list(row), timestamp=ts)
        rev = rt.persist()
        rt.shutdown()
    finally:
        m.shutdown()

    m = _manager(not port_writes)
    m.set_persistence_store((JaxFileStore if port_writes
                             else FileSystemPersistenceStore)(str(tmp_path)))
    try:
        rt = m.create_siddhi_app_runtime(app)
        assert rt.lowering() == lowering[kind]
        _collect(rt, got)
        rt.start()
        assert rt.restore_last_revision() == rev
        h = rt.get_input_handler("S")
        for row, ts in sends[20:]:
            h.send(list(row), timestamp=ts)
        rt.shutdown()
    finally:
        m.shutdown()
    assert len(ref) > 4
    assert same_rows(ref, got, bound(app))


def test_unwired_fault_site_is_refused():
    """``step.shard``, the one site the port does not consult yet (the
    multi-device slice), would arm silently: the annotation raises at
    creation and ``configure`` raises, both naming item 16; every other
    site arms."""
    with pytest.raises(SiddhiAppCreationError, match="item 16"):
        SiddhiManager(device="cpu").create_siddhi_app_runtime(
            "@app:faults(step.shard='crash') " + KV_BODY)
    rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(
        "@app:faults(step.dense='crash') " + KV_BODY)
    fi = rt.app_context.fault_injector
    with pytest.raises(ValueError, match="item 16"):
        fi.configure("step.shard", "transient")
    fi.configure("emit.drain", "transient")
    assert fi.watches("emit.drain")


