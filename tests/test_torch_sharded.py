"""The port's mesh sharding held against the JAX package's.

The JAX package's sharding files run twice a case, by
``test_torch_persistence.py``'s twin runs: once as they are (on the
eight-device virtual CPU mesh of ``conftest.py``), once with the JAX
names they took rebound to the port's (``SiddhiManager`` is
``SiddhiManager(device="cpu")``, whose ``devices='8'`` apps run on the
port's eight-shard CPU mesh), and the modules a test imports inside its
body standing for the port's while it runs.  Both runs must pass the
test's own assertions and deliver the same events:

- ``tests/test_parallel.py``, ``test_device_sharded.py``,
  ``test_sharded_product.py``, ``test_sharded_windows.py``.

In the port's run ``make_mesh``, ``compile_pattern`` and
``compile_query`` take ``device="cpu"`` (the port's entry points
otherwise run on ``cuda``), and ``compile_pattern`` resets on emit, as
the reference's ``compile_pattern`` does (the port's takes the
runtime's choice unless told).  ``n_state_devices``, which reads JAX's
``Array.devices()``, is the port's ``shard_devices``: the shards of a
sharded state, each holding its tensors on its own mesh device.

The cases that read JAX sharding objects inline are left out of the
replay and have port twins here that hold the same fact on the
per-shard devices:

- ``test_parallel.py::TestShardedEngine::test_state_sharding_placement``
  (``Array.sharding.device_set``): ``test_state_sharding_placement_twin``;
- ``test_sharded_product.py::TestShardedProduct::test_state_actually_sharded_over_8_devices``
  and ``::test_snapshot_restore_roundtrip_sharded`` (``Array.devices()``):
  ``test_state_actually_sharded_over_8_shards_twin`` and
  ``test_snapshot_restore_roundtrip_sharded_twin``, each run in both
  packages with the same events.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

import siddhi_tpu_torch.ops.dense_nfa as port_dense_nfa
import siddhi_tpu_torch.ops.device_query as port_device_query
import siddhi_tpu_torch.parallel as port_parallel
from test_torch_device_query import one_torch_thread  # noqa: F401
from test_torch_persistence import (
    INNER_IMPORTS,
    Record,
    cases,
    check_twin,
    load,
)

pytestmark = pytest.mark.faults

INNER = INNER_IMPORTS + ("siddhi_tpu.core.event",)


def _with(fn, **fixed):
    """``fn`` with ``fixed`` as keyword defaults."""
    def call(*a, **kw):
        for k, v in fixed.items():
            kw.setdefault(k, v)
        return fn(*a, **kw)
    return call


def _module(name, base, **over):
    m = types.ModuleType(name)
    m.__dict__.update(vars(base))
    m.__dict__.update(over)
    return m


CPU_MESH = _with(port_parallel.make_mesh, device="cpu")
CPU_PATTERN = _with(port_dense_nfa.compile_pattern, device="cpu",
                    reset_on_emit=True)
CPU_QUERY = _with(port_device_query.compile_query, device="cpu")


def shard_devices(state) -> int:
    """The port's twin of the reference's ``n_state_devices``: the number
    of shards a sharded state spans, each shard holding every one of its
    tensors on its own mesh device (one for an unsharded state)."""
    shards = getattr(state, "shards", None)
    if shards is None:
        return 1
    for sh, dev in zip(shards, state.devices):
        assert all(t.device == dev for t in sh.values())
    return len(shards)


def stand_ins(rec, port):
    if not port:
        return {}
    return {
        "siddhi_tpu.parallel": _module(
            "siddhi_tpu.parallel", port_parallel, make_mesh=CPU_MESH),
        "siddhi_tpu.ops.dense_nfa": _module(
            "siddhi_tpu.ops.dense_nfa", port_dense_nfa,
            compile_pattern=CPU_PATTERN),
        "siddhi_tpu.ops.device_query": _module(
            "siddhi_tpu.ops.device_query", port_device_query,
            compile_query=CPU_QUERY),
    }


def rebind(mod, rec, port):
    if not port:
        return
    for name, obj in (("make_mesh", CPU_MESH), ("compile_query", CPU_QUERY),
                      ("n_state_devices", shard_devices)):
        if hasattr(mod, name):
            setattr(mod, name, obj)


LEFT_OUT = {
    "test_parallel": {
        ("TestShardedEngine", "test_state_sharding_placement"):
            "test_state_sharding_placement_twin",
    },
    "test_sharded_product": {
        ("TestShardedProduct", "test_state_actually_sharded_over_8_devices"):
            "test_state_actually_sharded_over_8_shards_twin",
        ("TestShardedProduct", "test_snapshot_restore_roundtrip_sharded"):
            "test_snapshot_restore_roundtrip_sharded_twin",
    },
}
CORPORA = ("test_parallel", "test_device_sharded", "test_sharded_product",
           "test_sharded_windows")
CASES = [c for corpus in CORPORA
         for c in cases(corpus, LEFT_OUT.get(corpus, {}))]


def test_the_corpora_were_read():
    counts = {}
    for p in CASES:
        counts[p.values[0]] = counts.get(p.values[0], 0) + 1
    assert counts == {"test_parallel": 6, "test_device_sharded": 8,
                      "test_sharded_product": 5, "test_sharded_windows": 14}


@pytest.mark.parametrize("corpus,cname,mname,k", CASES)
def test_sharded_corpus_as_the_reference(corpus, cname, mname, k, tmp_path,
                                         request):
    check_twin(corpus, cname, mname, k, tmp_path, request, inner=INNER,
               stand_ins=stand_ins, rebind=rebind)


# -- port twins of the cases that read JAX sharding objects -------------------


def test_state_sharding_placement_twin():
    """``test_parallel.py``'s placement case: the state spans the eight
    shards, each with 64 partition rows and its scratch row on its own
    device (the CPU's, on the CPU mesh)."""
    sharded = port_parallel.ShardedPatternEngine(
        CPU_PATTERN(load("test_parallel", True, Record()).APP, "f",
                    n_partitions=8 * 64), CPU_MESH(8))
    state = sharded.init_state()
    assert shard_devices(state) == 8
    assert all(sh["active"].shape[0] == 65 for sh in state.shards)
    assert state["active"].shape[0] == 8 * 65  # 64 partitions + scratch


def _product_runs(header, sends, **kw):
    """``test_sharded_product.py``'s ``run`` in both packages: ``[(got,
    runtime, state, blob)]``, the JAX package's first."""
    out = []
    for port in (False, True):
        mod = load("test_sharded_product", port, Record())
        out.append(mod.run(header, sends, **kw))
    return out


def _jax_devices(state) -> int:
    return len({d for arr in state.values() for d in arr.devices()})


def test_state_actually_sharded_over_8_shards_twin():
    mod = load("test_sharded_product", False, Record())
    (jgot, jrt, jstate, _), (pgot, prt, pstate, _) = _product_runs(
        mod.HDR_SHARDED, mod.sends_over_keys(n_keys=16))
    assert pgot == jgot
    assert _jax_devices(jstate) == 8
    assert shard_devices(pstate) == 8
    # keys dealt round-robin: 16 keys over 8 shards = 2 rows a shard
    for rt in (jrt, prt):
        rows = np.fromiter(rt._key_rows.values(), dtype=np.int64)
        shard_of = rows // rt.parts_per_shard
        assert np.bincount(shard_of, minlength=8).tolist() == [2] * 8
        assert rt._key_rows == jrt._key_rows


def test_snapshot_restore_roundtrip_sharded_twin():
    mod = load("test_sharded_product", False, Record())
    sends = mod.sends_over_keys(n_keys=12, seed=7)
    mid = len(sends) // 2
    fulls = _product_runs(mod.HDR_SHARDED, sends)
    heads = _product_runs(mod.HDR_SHARDED, sends[:mid], snapshot_at=mid - 1)
    for port, (full, head) in enumerate(zip(fulls, heads)):
        pmod = load("test_sharded_product", bool(port), Record())
        got_tail, rt2, state2, _ = pmod.run(mod.HDR_SHARDED, sends[mid:],
                                            restore_blob=head[3])
        assert rt2._sharded is not None
        assert head[0] + got_tail == full[0]
        assert (shard_devices(state2) if port
                else _jax_devices(state2)) == 8
    assert fulls[0][0] == fulls[1][0]


# -- the hand-written kernels' paths under a mesh ----------------------------
#
# On the CPU their plain versions run; tests/test_torch_cuda.py holds
# the same apps on the card, where the kernels launch.


def _run_app(port, app, stream, out, batches):
    """``app`` over ``batches`` (``[(cols, ts)]``) in one package on the
    CPU: the callback rows and the runtime's lowering (with step kinds
    in the port)."""
    from siddhi_tpu import SiddhiManager as JaxManager
    from siddhi_tpu.core.event import EventBatch as JaxEventBatch
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.event import EventBatch

    mgr = SiddhiManager(device="cpu") if port else JaxManager()
    cls = EventBatch if port else JaxEventBatch
    try:
        rt = mgr.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback(out, lambda evs: got.append(
            [(e.timestamp, tuple(e.data)) for e in evs]))
        rt.start()
        h = rt.get_input_handler(stream)
        for cols, ts in batches:
            h.send_batch(cls(stream, list(cols), cols, ts))
        lowering = rt.lowering(step_kinds=True) if port else rt.lowering()
        rt.shutdown()
    finally:
        mgr.shutdown()
    return got, lowering


def chain_app(devices=None):
    """A capture-free 4-node every-chain over 64 partitions
    (``devices='N'``: sharded over N)."""
    dev = f", devices='{devices}'" if devices else ""
    states = ["every e1=Txn[v > 1.0]"] + [
        f"e{i}=Txn[v > {float(i)}]" for i in range(2, 5)]
    return ("@app:playback @app:execution('tpu', partitions='64'"
            f"{dev}) define stream Txn (key long, v double); "
            "partition with (key of Txn) begin @info(name='q') from "
            + " -> ".join(states) + " within 10 min select e4.v as v "
            "insert into Alerts; end;")


def chain_batches():
    rng = np.random.default_rng(5)
    return [({"key": rng.integers(0, 64, 256).astype(np.int64),
              "v": rng.uniform(0.0, 8.0, 256)},
             np.full(256, 1_000 + 10 * i, dtype=np.int64))
            for i in range(6)]


def tumbling_app(devices=None):
    """A lengthBatch group-by sum over 64 group rows."""
    dev = f", devices='{devices}'" if devices else ""
    return ("@app:playback @app:execution('tpu', partitions='64'"
            f"{dev}) define stream S (sym int, price float); "
            "@info(name='q0') from S#window.lengthBatch(700) select sym, "
            "sum(price) as total, count() as c group by sym insert into "
            "Out;")


def tumbling_batches():
    """Prices over seven decades, so a sum's association shows in its
    bits."""
    rng = np.random.default_rng(9)
    return [({"sym": rng.integers(0, 24, 512).astype(np.int32),
              "price": (rng.uniform(0.0, 1.0, 512)
                        * 10.0 ** rng.integers(-3, 4, 512))
              .astype(np.float32)},
             1_000 + 512 * i + np.arange(512, dtype=np.int64))
            for i in range(6)]


def test_sharded_capture_free_chain_runs_the_batch_step():
    """A capture-free every-chain under ``devices='4'`` runs the batch
    step (kernel 1's path) once a shard with events and delivers the
    JAX package's sharded events and the port's unsharded ones."""
    batches = chain_batches()
    jgot, _ = _run_app(False, chain_app(4), "Txn", "Alerts", batches)
    one, one_low = _run_app(True, chain_app(), "Txn", "Alerts", batches)
    four, four_low = _run_app(True, chain_app(4), "Txn", "Alerts", batches)
    assert jgot and four == jgot and one == jgot
    assert four_low == one_low == {"q": "dense/batch"}


def test_sharded_tumbling_sums_keep_the_single_device_bits():
    """A lengthBatch group-by under ``devices='4'``: every shard takes
    the segment at its single-device positions, so each float32 sum has
    the bits of the one-device run, and both deliver the JAX package's
    rows (sums within its float32 bound)."""
    batches = tumbling_batches()
    jgot, _ = _run_app(False, tumbling_app(4), "S", "Out", batches)
    one, one_low = _run_app(True, tumbling_app(), "S", "Out", batches)
    four, four_low = _run_app(True, tumbling_app(4), "S", "Out", batches)
    assert one_low == four_low == {"q0": "device"}

    def bits(got):
        return [(t, d[0], np.float64(d[1]).tobytes(), d[2])
                for b in got for t, d in b]

    assert bits(four) == bits(one) and len(bits(one)) > 0
    flat_j = [(t, d) for b in jgot for t, d in b]
    flat_p = [(t, d) for b in four for t, d in b]
    assert [(t, d[0], d[2]) for t, d in flat_p] == \
        [(t, d[0], d[2]) for t, d in flat_j]
    np.testing.assert_allclose([d[1] for _t, d in flat_p],
                               [d[1] for _t, d in flat_j], rtol=1e-4,
                               atol=1e-3)
