"""The port's own points of the operations layer, on the CPU and, for
the cases marked ``cuda``, on the card (this file imports no JAX, so
``python -m pytest --noconftest -m cuda tests/test_torch_ops_port.py``
runs there):

- the NaN/Inf quarantine's restore keeps each lane's dtype and device
  and writes into the live tensors, so a holder sees the restore;
- a retried ``ingest.put`` copies once, and only after its check;
- the degradation ladder takes only its ``fuse`` rung: a dense engine
  stays on the ``dense_batch`` kernel under pressure, and a fused chain
  goes to the junction path and back, each a live re-plan with the
  undisturbed run's rows;
- ``@app:plan`` and a ``shard`` pin are refused, naming their
  ``ROADMAP.md`` items.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import siddhi_tpu_torch
from siddhi_tpu_torch.core.exceptions import (
    SiddhiAppCreationError,
    SiddhiAppRuntimeError,
)


def _devices():
    out = [pytest.param(torch.device("cpu"), id="cpu")]
    out.append(pytest.param(
        torch.device("cuda"), id="cuda",
        marks=[pytest.mark.cuda, pytest.mark.skipif(
            not torch.cuda.is_available(),
            reason="needs a CUDA card; the restore copies on the card")]))
    return out


@pytest.mark.parametrize("device", _devices())
def test_poison_restore_keeps_dtypes_and_holders(device):
    """The quarantine's restore writes the last good state back into the
    live tensors: int32 lanes, a LONG's hi/lo int32 pair and a DOUBLE's
    float32 lane keep their dtype and device, and a holder of a live
    tensor (the persist capture's, a shared bank's) sees the restored
    values, as ``poison_guard`` counts one quarantine."""
    from siddhi_tpu_torch.util import faults

    state = {"cnt": torch.arange(6, dtype=torch.int32, device=device),
             "ts": (torch.full((6,), 7, dtype=torch.int32, device=device),
                    torch.full((6,), 9, dtype=torch.int32, device=device)),
             "sum": torch.linspace(0, 1, 6, dtype=torch.float32,
                                   device=device)}
    holder = state["sum"]
    fi = faults.FaultInjector()
    # armed (the guard runs) but never tripping: the NaN below comes
    # from a step that writes its state in place
    fi.configure("state.poison", "poison", count=0)
    st, good, q = faults.poison_guard(fi, state, None, None)
    assert not q and good["sum"] is not holder
    holder.add_(5.0)
    holder[2] = float("nan")
    st["cnt"].add_(1)
    st, good2, q = faults.poison_guard(fi, st, good, None)
    assert q and good2 is good and fi.stats.poison_quarantines == 1
    for live, orig in ((st["sum"], holder), (st["cnt"], state["cnt"]),
                       (st["ts"][0], state["ts"][0])):
        assert live is orig and live.device.type == device.type
    assert st["sum"].dtype == torch.float32
    assert [t.dtype for t in (st["cnt"], *st["ts"])] == [torch.int32] * 3
    assert torch.equal(st["cnt"].cpu(), torch.arange(6, dtype=torch.int32))
    # the holder of the live tensor sees the restored values
    assert torch.equal(holder.cpu(), torch.linspace(0, 1, 6))
    assert not faults.state_has_poison(st)


@pytest.mark.parametrize("device", _devices())
def test_poison_restore_keeps_a_key_the_good_copy_lacks(device):
    """A state that gained a key after its last good copy keeps that
    key's live leaf through the restore; the keys the copy holds are
    set back."""
    from siddhi_tpu_torch.util import faults

    state = {"cnt": torch.arange(4, dtype=torch.int32, device=device)}
    good = faults.good_copy(state)
    extra = torch.full((3,), 2.5, dtype=torch.float32, device=device)
    state["extra"] = extra
    state["cnt"].add_(7)
    out = faults.restore_good(state, good)
    assert set(out) == {"cnt", "extra"}
    assert out["extra"] is extra
    assert out["cnt"] is state["cnt"]
    assert torch.equal(out["cnt"].cpu(), torch.arange(4, dtype=torch.int32))
    assert torch.equal(out["extra"].cpu(), torch.full((3,), 2.5))


def test_ingest_put_retry_copies_once_after_its_check(monkeypatch):
    """``staged_put`` checks ``ingest.put`` before the copy starts: two
    transient faults retry, then one copy runs; no retry shares a buffer
    with a copy in flight."""
    from siddhi_tpu_torch.core import ingest_stage
    from siddhi_tpu_torch.util.faults import FaultInjector

    fi = FaultInjector()
    fi.transfer_retry_scale = 0.0
    fi.configure("ingest.put", "transient", count=2)
    copies = []
    orig = ingest_stage._put
    tree = (np.arange(4, dtype=np.int32), {"v": np.ones(4, np.float32)})

    def counting(x, device):
        if x is tree:  # the copy's start (it recurses over the leaves)
            copies.append(fi.stats.transfer_retries)
        return orig(x, device)

    monkeypatch.setattr(ingest_stage, "_put", counting)
    stats = ingest_stage.IngestStats()
    out = ingest_stage.staged_put(tree, torch.device("cpu"), stats, fi)
    assert copies == [2]
    assert (fi.stats.transfer_retries, fi.stats.drains_recovered) == (2, 1)
    assert stats.device_puts == 1 and out[0].dtype == torch.int32


KERNEL_APP = (
    "@app:name('krung') @app:playback @app:execution('tpu', "
    "partitions='64', instances='16') @app:kernels @app:devtables "
    "@app:faults(journal='4096') "
    "@app:limits(watchdog='60 sec', ladder='true') "
    "define stream Txn (key long, v double); "
    "partition with (key of Txn) begin "
    "@info(name='q') from every e1=Txn[v > 1.0] -> e2=Txn[v > 2.0] "
    "-> e3=Txn[v > 3.0] within 10 min select e3.v as v insert into "
    "Alerts; end;")

FUSE_APP = (
    "@app:name('frung') @app:playback @app:execution('tpu') @app:fuse "
    "@app:faults(journal='4096') "
    "@app:limits(watchdog='60 sec', ladder='true') "
    "define stream Txn (key int, v float); "
    "define stream Mid (key int, v float); "
    "define stream Win (key int, total double); "
    "@info(name='q1') from Txn[v > 0.5] select key, v insert into Mid; "
    "@info(name='q2') from Mid#window.length(8) "
    "select key, sum(v) as total insert into Win; "
    "@info(name='q3') from Win[total > 20.0] select key, total "
    "insert into Alerts;")


def _rung_sends(n=240, seed=4):
    rng = np.random.default_rng(seed)
    return [([int(rng.integers(0, 16)), float(rng.integers(0, 50)) / 10.0],
             1000 + 5 * i) for i in range(n)]


def _rung_run(device, app, query, steps=None):
    m = siddhi_tpu_torch.SiddhiManager(device=device)
    try:
        rt = m.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback("Alerts", lambda evs: got.extend(
            (e.timestamp, tuple(e.data)) for e in evs))
        rt.start()
        h = rt.get_input_handler("Txn")
        kinds = []
        for i, (row, ts) in enumerate(_rung_sends()):
            if steps and i in steps:
                pressure, ticks = steps[i]
                for _ in range(ticks):
                    rt._ladder.observe(pressure)
                kinds.append(rt.lowering(step_kinds=True)[query])
            h.send(list(row), timestamp=ts)
        rb = rt.app_context.robustness
        rungs = rt._ladder.describe()["rungs"]
        rt.shutdown()
        return got, kinds, rb, rungs
    finally:
        m.shutdown()


def test_ladder_demotes_only_the_fuse_rung():
    """The port's ladder has one rung, ``fuse``: ``apply_degradation``
    leaves ``kernels`` and ``devtables`` on at any level (the
    reference's first two rungs would take a hand-written kernel off
    the path or move tables to the host)."""
    import types

    from siddhi_tpu_torch.robustness import DEMOTE_ORDER, apply_degradation

    assert DEMOTE_ORDER == ("fuse",)
    ctx = types.SimpleNamespace(kernels=True, devtables=True, fuse=True)
    assert apply_degradation(ctx, 3) == ["fuse"]
    assert (ctx.kernels, ctx.devtables, ctx.fuse) == (True, True, False)
    ctx = types.SimpleNamespace(kernels=True, devtables=True, fuse=False)
    assert apply_degradation(ctx, 2) == []
    assert (ctx.kernels, ctx.devtables) == (True, True)


@pytest.mark.parametrize("device", _devices())
def test_ladder_keeps_the_kernels_and_takes_the_fuse_rung(device):
    """An app with ``@app:kernels`` and ``@app:devtables`` and no fused
    chain has a zero-rung ladder: hot ticks move nothing and the dense
    engine stays on the ``dense_batch`` kernel (on the card its launches
    go on).  A fused chain's ``fuse`` rung: three hot ticks demote it to
    the junction path, six cool ticks promote it back, each a counted
    live re-plan, and the rows equal the undisturbed run's."""
    from siddhi_tpu_torch.kernels.dense_batch import batch_step

    ref, _, _, _ = _rung_run(device, KERNEL_APP, "q")
    before = batch_step.launches
    got, kinds, rb, rungs = _rung_run(device, KERNEL_APP, "q", {
        80: (1.0, 3), 160: (0.0, 6)})
    assert rungs == [] and kinds == ["dense/batch", "dense/batch"]
    assert (rb.ladder_demotions, rb.ladder_promotions) == (0, 0)
    assert ref and got == ref
    if device.type == "cuda":
        assert batch_step.launches > before

    ref, _, _, _ = _rung_run(device, FUSE_APP, "q2")
    got, kinds, rb, rungs = _rung_run(device, FUSE_APP, "q2", {
        80: (1.0, 3), 160: (0.0, 6)})
    assert rungs == ["fuse"] and kinds == ["device", "fused"]
    assert (rb.ladder_demotions, rb.ladder_promotions) == (1, 1)
    assert ref and got == ref
    with pytest.raises(SiddhiAppCreationError):
        siddhi_tpu_torch.SiddhiManager(device="cpu") \
            .create_siddhi_app_runtime(FUSE_APP.replace(
                "watchdog='60 sec', ", ""))


def test_plan_annotation_and_shard_pins_are_refused():
    """``@app:plan`` (the cost model's own choice, the plan monitor)
    names item 15d; a replan pin naming ``shard`` names item 16 and is
    counted as a planner fallback, the app left on its plan."""
    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    try:
        with pytest.raises(SiddhiAppCreationError, match="item 15d"):
            m.create_siddhi_app_runtime(
                "@app:execution('tpu') @app:plan(auto='true') "
                "define stream S (v int); from S select v insert into O;")
        rt = m.create_siddhi_app_runtime(
            "@app:name('pins') @app:playback @app:execution('tpu') "
            "@app:faults(journal='64') define stream S (v int); "
            "@info(name='q') from S[v > 1] select v insert into O;")
        rt.start()
        rt.get_input_handler("S").send([3], timestamp=1000)
        with pytest.raises(SiddhiAppRuntimeError, match="item 16"):
            rt.replan({"q": "device+shard"})
        with pytest.raises(SiddhiAppRuntimeError, match="unknown path"):
            rt.replan({"q": "warp"})
        assert rt.lowering() == {"q": "device"}
        st = rt.statistics()
        key = "io.siddhi.SiddhiApps.pins.Siddhi.Queries.pins."
        assert st[key + "plannerFallbacks"] == 2
        assert rt.replan({"q": "host"}) == {"q": "host"}
        rt.shutdown()
    finally:
        m.shutdown()
