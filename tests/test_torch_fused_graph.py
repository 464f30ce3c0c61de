"""Stream-graph fusion (``@app:fuse``) held against the JAX package's.

``tests/test_fused_graph.py`` runs through both packages by
``test_torch_persistence.py``'s twin runs: each case passes its own
assertions in both (fused chains equal to the junction path bit for
bit, lowerings, intermediate junctions at zero dispatches, one fused
step a batch, no ``EventBatch`` on an intermediate stream, crash and
journal replay, persist and restore mid-chain, the truncated prefix, the
``execution('tpu')`` requirement), and both deliver the same events.

What the port holds otherwise, with its ``ROADMAP.md`` item:

- the five fallback cases read ``rt.statistics()`` (item 15c): their
  twins here run the same apps (``@app:statistics`` struck from the
  port's copy) and hold the same ``lowering()`` and the same WARNING,
  and the port's ``fused_fallbacks`` reason equal to the reference's
  ``fusedFallbackReason``;
- the transient-fault case arms ``ingest.put`` and ``emit.drain``, fault
  sites the port does not wire yet (item 15b): its twin holds the
  port's refusal of the app and the same chain without the faults;
- the JAX transfer guard stands for "no host read between stages":
  ``test_fused_chain_fetches_only_through_the_emit_queue`` counts the
  port's ``fetch_coalesced`` calls and ``EventBatch`` builds.
"""

from __future__ import annotations

import importlib.util
import logging
import re

import numpy as np
import pytest

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.core import emit_queue
from siddhi_tpu_torch.core.event import EventBatch as PortBatch
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from test_torch_device_query import one_torch_thread  # noqa: F401
from test_torch_device_query import bound, same_rows
from test_torch_done_slices import INNER, stand_ins
from test_torch_persistence import TESTS, cases, check_twin

LEFT_OUT = {
    ("TestFusedFallback", "test_async_intermediate_falls_back"):
        "test_fallback_as_the_reference[async]",
    ("TestFusedFallback", "test_table_hop_falls_back"):
        "test_fallback_as_the_reference[table]",
    ("TestFusedFallback", "test_multi_consumer_intermediate_falls_back"):
        "test_fallback_as_the_reference[multi_consumer]",
    ("TestFusedFallback", "test_host_only_interior_stage_falls_back"):
        "test_fallback_as_the_reference[string_lane]",
    ("TestFusedFallback",
     "test_unfusable_tail_truncates_chain_prefix_still_fuses"):
        "test_fallback_as_the_reference[group_by_tail]",
    ("TestFusedFaults", "test_transient_ingest_emit_faults_bit_identical"):
        "test_transient_fault_sites_wait_for_item_15b",
}
CASES = cases("test_fused_graph", LEFT_OUT)


def _corpus():
    spec = importlib.util.spec_from_file_location(
        "_fused_graph_apps", TESTS / "test_fused_graph.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FG = _corpus()


def test_the_corpus_was_read():
    assert len(CASES) == 10
    assert len(CASES) + len(LEFT_OUT) == 16


@pytest.mark.parametrize("corpus,cname,mname,k", CASES)
def test_fused_graph_corpus_as_the_reference(corpus, cname, mname, k,
                                             tmp_path, request):
    jax, port = check_twin(corpus, cname, mname, k, tmp_path, request,
                           inner=INNER, stand_ins=stand_ins)
    assert any(port.got.values()) or not jax.got


# -- the fallback cases ---------------------------------------------------------

def _fallback_apps():
    """``(id, app, callback streams, sends, query)`` of each fallback
    case, the app text taken from the corpus test's source."""
    import inspect

    out = []
    for mname, ident, streams, sends, q in (
            ("test_async_intermediate_falls_back", "async", ("Out",),
             None, "q1"),
            ("test_table_hop_falls_back", "table", (), None, "q1"),
            ("test_multi_consumer_intermediate_falls_back",
             "multi_consumer", ("Out", "Out2"), None, "q1"),
            ("test_host_only_interior_stage_falls_back", "string_lane",
             ("Out",), None, "q1"),
            ("test_unfusable_tail_truncates_chain_prefix_still_fuses",
             "group_by_tail", ("Out",), FG._sends(30, 23), "q3")):
        src = inspect.getsource(getattr(FG.TestFusedFallback, mname))
        app = re.search(r'APP = """(.*?)"""', src, re.S).group(1)
        out.append(pytest.param(app, streams, sends, q, id=ident))
    return out


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        if "fused chain unavailable" in record.getMessage():
            self.messages.append(record.getMessage())


def _fallback_run(make, app, streams, sends, logger):
    h = _Warnings()
    log = logging.getLogger(logger)
    log.addHandler(h)
    try:
        m = make()
        rt = m.create_siddhi_app_runtime(app)
        got = {s: [] for s in streams}
        for s in streams:
            rt.add_callback(s, lambda evs, g=got[s]: g.extend(
                (e.timestamp, tuple(e.data)) for e in evs))
        rt.start()
        if sends:
            inp = rt.get_input_handler("SIn")
            for row, ts in sends:
                inp.send(list(row), timestamp=ts)
        low = rt.lowering()
        reasons = dict(getattr(rt.app_context, "fused_fallbacks", {}))
        st = rt.statistics() if hasattr(rt, "statistics") else None
        rt.shutdown()
        m.shutdown()
        return low, h.messages, got, reasons, st
    finally:
        log.removeHandler(h)


@pytest.mark.parametrize("app,streams,sends,q", _fallback_apps())
def test_fallback_as_the_reference(app, streams, sends, q):
    """The corpus's fallback app in both packages: the same lowering,
    the same WARNINGs (the reason word for word), the same rows; the
    port keeps the reason where ``fused_fallbacks`` reads it, equal to
    the reference's counted ``fusedFallbackReason``."""
    jlow, jwarn, jgot, _, jst = _fallback_run(
        siddhi_tpu.SiddhiManager, app, streams, sends, "siddhi_tpu")
    port_app = re.sub(r"@app:statistics\('basic'\)", "", app)
    plow, pwarn, pgot, reasons, _ = _fallback_run(
        lambda: siddhi_tpu_torch.SiddhiManager(device="cpu"), port_app,
        streams, sends, "siddhi_tpu_torch")
    assert plow == jlow
    assert pwarn == jwarn and pwarn
    name = re.search(r"@app:name\('(\w+)'\)", app).group(1)
    pre = f"io.siddhi.SiddhiApps.{name}.Siddhi.Queries.{q}."
    assert reasons[q] == jst[pre + "fusedFallbackReason"]
    tol = bound(app)
    for s in streams:
        assert same_rows(jgot[s], pgot[s], tol), s


# -- the transient-fault case -----------------------------------------------------

def test_transient_fault_sites_wait_for_item_15b():
    """The corpus arms ``ingest.put`` and ``emit.drain``, which the port
    does not wire yet: it refuses the app naming item 15, where the
    reference runs it; the same chain without the faults is held by
    ``test_fused_graph_corpus_as_the_reference`` (three-stage cases)."""
    faults = ("@app:faults(transfer.retry.scale='0.001', "
              "ingest.put='transient:count=3', "
              "emit.drain='transient:count=2') ")
    app = FG.THREE_STAGE.format(tag="T1", fuse="@app:fuse", faults=faults)
    rt = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(app)
    rt.shutdown()
    with pytest.raises(SiddhiAppCreationError, match=r"item 15\b"):
        siddhi_tpu_torch.SiddhiManager(device="cpu") \
            .create_siddhi_app_runtime(app)


# -- the port's own checks -------------------------------------------------------

def test_fused_chain_fetches_only_through_the_emit_queue(monkeypatch):
    """Between stages nothing crosses to the host: the fused run builds
    no ``EventBatch`` for ``Mid`` or ``Win``, and its device-to-host
    copies are the count gates and the matched columns, one
    ``fetch_coalesced`` each a batch at most, where the junction path
    fetches at every hop."""
    calls = []
    orig = emit_queue.fetch_coalesced

    def counting(arrays):
        calls.append(len(arrays))
        return orig(arrays)

    built = []
    orig_init = PortBatch.__init__

    def counting_init(self, stream_id, *a, **k):
        built.append(stream_id)
        orig_init(self, stream_id, *a, **k)

    for mod in ("siddhi_tpu_torch.ops.fused_graph",
                "siddhi_tpu_torch.ops.device_query",
                "siddhi_tpu_torch.core.emit_queue"):
        monkeypatch.setattr(f"{mod}.fetch_coalesced", counting)
    monkeypatch.setattr(PortBatch, "__init__", counting_init)
    sends = FG._sends(40, 5)

    def run(fuse):
        calls.clear()
        built.clear()
        m = siddhi_tpu_torch.SiddhiManager(device="cpu")
        rt = m.create_siddhi_app_runtime(FG.THREE_STAGE.format(
            tag="G", fuse="@app:fuse" if fuse else "", faults=""))
        got = []
        rt.add_callback("Out", FG._collector(got))
        rt.start()
        h = rt.get_input_handler("SIn")
        for row, ts in sends:
            h.send(list(row), timestamp=ts)
        rt.shutdown()
        m.shutdown()
        return got, len(calls), list(built)

    fgot, ffetch, fbuilt = run(True)
    jgot, jfetch, jbuilt = run(False)
    assert fgot == jgot and fgot
    assert "Mid" not in fbuilt and "Win" not in fbuilt
    assert "Mid" in jbuilt and "Win" in jbuilt
    assert ffetch <= 2 * len(sends) < jfetch


def test_fused_dense_tail_steps_each_row():
    """The dense tail takes one general step per event of the batch
    (the junction path's one collision round a row); a dropped row
    steps the scratch row, so the partition's state equals the junction
    path's after every batch."""
    sends = FG._sends(60, 7)
    states = {}
    for fuse in (True, False):
        m = siddhi_tpu_torch.SiddhiManager(device="cpu")
        rt = m.create_siddhi_app_runtime(FG.DENSE_TAIL.format(
            tag="S", fuse="@app:fuse" if fuse else ""))
        rt.start()
        h = rt.get_input_handler("SIn")
        for row, ts in sends:
            h.send(list(row), timestamp=ts)
        rt.drain()
        qr = rt.query_runtimes["q3"]
        if fuse:
            dr = qr.device_runtime
            assert dr.graph.dense_steps == len(sends)
            st = dr.state[-1]
        else:
            st = qr.pattern_processor.state
        states[fuse] = {k: v[0].clone() for k, v in st.items()}
        rt.shutdown()
        m.shutdown()
    for k in states[False]:
        assert np.array_equal(states[True][k].numpy(),
                              states[False][k].numpy()), k


def test_double_passthrough_tail_keeps_its_gate():
    """A DOUBLE input attribute forwarded to the tail's output would be
    rounded on the float32 lane: the chain falls back, as in the
    reference, with the same reason."""
    app = ("@app:execution('tpu') @app:fuse "
           "define stream SIn (sym int, price double); "
           "@info(name='q1') from SIn[price > 1.0] "
           "select sym, price insert into Mid; "
           "@info(name='q2') from Mid[price > 2.0] "
           "select sym, price insert into Out;")
    jlow, jwarn, _, _, _ = _fallback_run(
        siddhi_tpu.SiddhiManager, app, ("Out",), None, "siddhi_tpu")
    plow, pwarn, _, reasons, _ = _fallback_run(
        lambda: siddhi_tpu_torch.SiddhiManager(device="cpu"), app, ("Out",),
        None, "siddhi_tpu_torch")
    assert plow == jlow and "fused" not in plow.values()
    assert pwarn == jwarn and "precision" in reasons["q2"]


@pytest.mark.parametrize("chain,rows,batches", [
    ("THREE_STAGE", 5_000, 3),
    ("DENSE_TAIL", 2_500, 2),
])
def test_fused_batches_past_the_chunk_bound_as_the_reference(chain, rows,
                                                             batches):
    """Junction batches wider than ``MAX_DEVICE_BATCH``: the port runs the
    filter stages once over the batch (here 6,144 and 4,096 lanes wide)
    and the window stage chunk by chunk, the reference every stage chunk
    by chunk; both deliver the same rows."""
    rng = np.random.default_rng(23)
    data = []
    for b in range(batches):
        cols = {"sym": rng.integers(0, 5, rows).astype(np.int32),
                "price": rng.uniform(0, 30, rows).astype(np.float32),
                "vol": rng.integers(1, 100, rows).astype(np.int32)}
        data.append((cols, 1_000 + 10_000 * b + np.arange(rows) * 2))
    app = getattr(FG, chain).format(tag="W", fuse="@app:fuse", faults="")
    got = {}
    for name, make, Batch in (
            ("jax", siddhi_tpu.SiddhiManager, siddhi_tpu.core.event.EventBatch),
            ("port", lambda: siddhi_tpu_torch.SiddhiManager(device="cpu"),
             PortBatch)):
        m = make()
        rt = m.create_siddhi_app_runtime(app)
        rows_out = []
        rt.add_callback("Out", FG._collector(rows_out))
        rt.start()
        h = rt.get_input_handler("SIn")
        for cols, ts in data:
            h.send_batch(Batch("SIn", ["sym", "price", "vol"], dict(cols),
                               ts.astype(np.int64)))
        got[name] = (rows_out, rt.lowering())
        rt.shutdown()
        m.shutdown()
    (jrows, jlow), (prows, plow) = got["jax"], got["port"]
    assert plow == jlow and set(plow.values()) == {"fused"}
    assert prows and same_rows(jrows, prows, bound(app))
