"""The dense emit's compaction on the device, held against a NumPy
selection over the dense banks.

``DeferredDenseEmit.device_arrays()`` compacts each part's matches on
its device after the count gate, so only the matched rows cross.  Every
producer of a ``DeferredDenseEmit`` is a case: a general round with
bank-1 (via-path) lanes, a ``batch_chunk`` part of the capture-free
step, a sharded batch (a part a shard's step), a multiplexed dense
group, a fused chain's dense tail, a part whose matches fill every lane
of bank 0, and a round of one row.  For each,
``materialize(fetch_coalesced(device_arrays()))`` must give what the
selection written here gives from the dense banks: ``np.nonzero`` over
the emit masks, the outputs gathered at the set lanes (integer outputs
re-joined from their hi/lo int32 pair) and the rows ordered by (event,
anchor, lane) with ``np.lexsort``.  The compaction orders and types the
rows on the device: the order tests hold ``compact_matches`` and
``match_order`` (the packed key and its fallback past 63 bits) to that
lexsort, the types tests hold the device's int64 join to ``_i64_join``
and a ``StreamCallback``'s columns to the object matrix's.  The counter
tests hold ``compactedChunks``, ``hostMergedRows`` and ``emitBytes`` of
the runtime's statistics feed to the compacted parts, rows and bytes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from siddhi_tpu_torch.core.emit_queue import fetch_coalesced
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.ops.dense_nfa import (
    _i64_join,
    compact_matches,
    compile_pattern,
    match_order,
)
from siddhi_tpu_torch.parallel import ShardedPatternEngine, make_mesh

# long keys at the edges of int64: the hi/lo join must give them back
EDGE_KEYS = np.array([-2**63, 2**63 - 1, -1, 0, 2**32, -2**31 - 7,
                      2**62 + 12345, 987654321], dtype=np.int64)

KLEENE = ("define stream Login (user long, ok int); "
          "@info(name='bf') "
          "from every f=Login[ok == 0]<3:100> -> s=Login[ok == 1] "
          "within 1 min "
          "select f[0].user as u, s.ok as sk insert into Alerts;")
CHAIN = ("define stream Txn (key long, v double); "
         "@info(name='q') from every e1=Txn[v > 1.0] -> e2=Txn[v > 2.0] "
         "-> e3=Txn[v > 3.0] within 10 min "
         "select {sel} insert into Out;")
PAIR = ("define stream Txn (key long, v double); "
        "@info(name='q') from every e1=Txn[v > 0.0] -> e2=Txn[v > 100.0] "
        "within 10 min "
        "select e1.v as a, e2.key as k, e2.v as b insert into Out;")


def _join(hi: np.ndarray, lo: np.ndarray) -> list:
    """The int64 of each (hi, lo) pair, as Python ints:
    ``prepare_cols`` stores ``hi = v >> 32`` and ``lo = (v & 0xFFFFFFFF)
    - 2**31``."""
    return [(int(h) << 32) + (int(l) + 2**31) for h, l in zip(hi, lo)]


def selection(eng, pending):
    """The matches of ``pending``'s parts selected on the host from
    their dense banks."""
    evs, anchors, lanes_all, cols = [], [], [], []
    for p in pending.parts:
        emit, f, i, anchor = (t.cpu().numpy()
                              for t in (p.emit, p.f, p.i, p.anchor))
        rows, lanes = np.nonzero(emit)
        evs.append(p.ridx[rows].astype(np.int64))
        anchors.append(anchor[rows, lanes].astype(np.int64))
        lanes_all.append(lanes.astype(np.int64))
        out, ii = [], 0
        for oi, is_int in enumerate(eng.out_int):
            if is_int:
                out.append(_join(i[rows, lanes, 2 * ii],
                                 i[rows, lanes, 2 * ii + 1]))
                ii += 1
            else:
                out.append(f[rows, lanes, oi])
        cols.append(out)
    ev = np.concatenate(evs)
    order = np.lexsort((np.concatenate(lanes_all), np.concatenate(anchors),
                        ev))
    out = [sum((c[oi] if isinstance(c[oi], list) else list(c[oi])
                for c in cols), []) for oi in range(len(eng.out_int))]
    return ev[order], [[col[j] for j in order] for col in out]


def check(eng, pending):
    """The compacted path against :func:`selection`: the same events,
    dtypes, order and output values (floats by their bits, longs
    exactly), in the typed columns and in the one matrix ``process``
    returns.  Returns the match count."""
    assert pending is not None and pending.resolve() > 0
    ev, cols = pending.materialize(fetch_coalesced(pending.device_arrays()))
    want_ev, want_cols = selection(eng, pending)
    assert ev.dtype == np.int64 and np.array_equal(ev, want_ev)
    assert len(cols) == len(ev) == pending.resolve()
    for oi, is_int in enumerate(eng.out_int):
        col = cols.column(oi)
        if is_int:
            assert col.dtype == np.int64
            assert [int(x) for x in col] == want_cols[oi]
        else:
            assert col.dtype == np.float32
            want = np.asarray(want_cols[oi], dtype=np.float32)
            assert np.array_equal(col.view(np.int32), want.view(np.int32))
    out = cols.matrix()
    if any(eng.out_int):
        assert out.dtype == object
        for oi, is_int in enumerate(eng.out_int):
            col = out[:, oi]
            if is_int:
                assert all(isinstance(x, (int, np.integer)) for x in col)
                assert [int(x) for x in col] == want_cols[oi]
            else:
                got = np.asarray(col, dtype=np.float64)
                want = np.asarray(want_cols[oi], dtype=np.float32)
                assert np.array_equal(got.view(np.int64),
                                      want.astype(np.float64).view(np.int64))
    else:
        assert out.dtype == np.float32
        want = np.stack([np.asarray(c, dtype=np.float32)
                         for c in want_cols], axis=1)
        assert np.array_equal(out.view(np.int32), want.view(np.int32))
    return len(ev)


def _kleene_batch(rng):
    """Users fail three to five times and then succeed, interleaved, so
    the rounds collide and the open count's clone emits through bank 1;
    each user's ``user`` column is a long at an int64 edge."""
    part, ok = [], []
    for _ in range(6):
        for u in range(8):
            part.append(u)
            ok.append(int(rng.random() < 0.3))
    part, ok = np.asarray(part), np.asarray(ok)
    ts = 1000 + 10 * np.arange(len(part), dtype=np.int64)
    return ("Login", part, {"user": EDGE_KEYS[part], "ok": ok}, ts)


def case_general_via(rng, device="cpu"):
    eng = compile_pattern(KLEENE, "bf", n_partitions=8, device=device)
    assert eng.step_kind == "general"
    _s, pending = eng.process_deferred(eng.init_state(), *_kleene_batch(rng))
    assert pending.resolve() > 0
    assert sum(int(p.emit[:, eng.I:].sum()) for p in pending.parts)
    assert len(pending.parts) > 1
    return eng, pending


def _chain_batch(rng, n, n_parts, keys=EDGE_KEYS):
    part = rng.integers(0, n_parts, n)
    cols = {"key": keys[part % len(keys)], "v": rng.uniform(0.0, 5.0, n)}
    ts = 1000 + np.arange(n, dtype=np.int64)
    return ("Txn", part, cols, ts)


def case_batch_chunk(rng, device="cpu"):
    eng = compile_pattern(CHAIN.format(sel="e3.key as k, e3.v as v"), "q",
                          n_partitions=16, n_instances=8, device=device)
    assert eng.step_kind == "batch"
    _s, pending = eng.process_deferred(eng.init_state(),
                                       *_chain_batch(rng, 200, 16))
    assert len(pending.parts) == 1
    return eng, pending


def case_sharded(rng, device="cpu"):
    eng = compile_pattern(
        CHAIN.format(sel="e1.key as k, e1.v as a, e3.v as v"), "q",
        n_partitions=32, n_instances=4, device=device)
    stepper = ShardedPatternEngine(eng, make_mesh(4, device=device))
    stream, part, cols, ts = _chain_batch(rng, 160, 32)
    _s, pending = stepper.process_deferred(stepper.init_state(), stream,
                                           part, cols, ts)
    # one part a shard's step (the general step's: one a collision round
    # of each shard with events in it), each of one shard's events
    shard = part // stepper.parts_per_shard
    assert all(len(np.unique(shard[p.ridx])) == 1 for p in pending.parts)
    assert len(pending.parts) == sum(
        int(np.bincount(part[shard == s]).max()) for s in np.unique(shard))
    stepped = len(pending.parts)
    assert pending.resolve() > 0
    # a shard's step without a match compacts nothing
    assert 1 < len(pending.parts) < stepped
    return eng, pending


def case_full_lanes(rng, device="cpu"):
    """I arming events a partition, then one that completes all I: the
    last round's every row sets every lane of bank 0."""
    I, P = 4, 6
    eng = compile_pattern(PAIR, "q", n_partitions=P, n_instances=I,
                          device=device)
    part = np.tile(np.arange(P), I + 1)
    v = np.concatenate([rng.uniform(1.0, 99.0, I * P),
                        np.full(P, 200.0)])
    ts = 1000 + np.arange(len(part), dtype=np.int64)
    _s, pending = eng.process_deferred(
        eng.init_state(), "Txn", part,
        {"key": EDGE_KEYS[part % len(EDGE_KEYS)], "v": v}, ts)
    assert pending.resolve() == I * P and len(pending.parts) == 1
    assert bool(pending.parts[0].emit[:, :I].all())
    return eng, pending


def case_one_row(rng, device="cpu"):
    eng = compile_pattern(PAIR, "q", n_partitions=4, n_instances=4,
                          device=device)
    state, first = eng.process_deferred(
        eng.init_state(), "Txn", np.array([2, 2, 1]),
        {"key": EDGE_KEYS[:3], "v": np.array([5.0, 7.0, 9.0])},
        np.array([1000, 1001, 1002], dtype=np.int64))
    assert first.resolve() == 0
    _s, pending = eng.process_deferred(
        state, "Txn", np.array([2]), {"key": EDGE_KEYS[:1],
                                      "v": np.array([150.0])},
        np.array([1003], dtype=np.int64))
    assert pending.resolve() == 2
    assert [p.emit.shape[0] for p in pending.parts] == [1]
    return eng, pending


MUX = ("@app:name('cx{i}') @app:playback @app:execution('tpu') "
       "@app:multiplex(slots='4') "
       "define stream Txn (key long, v double); "
       "@info(name='q') from every e1=Txn[v > 1.0] -> e2=Txn[v > 2.0] "
       "-> e3=Txn[v > 3.0] within 10 min "
       "select e1.key as k, e3.v as v insert into Out;")


def case_multiplex(rng, device="cpu", tenants=3):
    """Tenants of one multiplexed dense group (the general step: ``e1``
    is captured): the group's pendings, recorded as it makes them."""
    from siddhi_tpu_torch import SiddhiManager

    m = SiddhiManager(device=device)
    try:
        rts = []
        for i in range(tenants):
            rt = m.create_siddhi_app_runtime(MUX.format(i=i))
            rt.start()
            rts.append(rt)
        (group,) = m.siddhi_context.multiplex_registry.open_groups()
        eng = group.engine
        assert eng.step_kind == "general"
        made = []
        orig = eng.process_deferred

        def record(*a, **kw):
            state, pending = orig(*a, **kw)
            made.append(pending)
            return state, pending
        eng.process_deferred = record
        for c in range(4):
            for i, rt in enumerate(rts):
                n = 20 + 3 * i
                rt.get_input_handler("Txn").send_batch(EventBatch(
                    "Txn", ["key", "v"],
                    {"key": EDGE_KEYS[rng.integers(0, 8, n)],
                     "v": rng.uniform(0.0, 5.0, n)},
                    1000 + 100 * c + np.arange(n, dtype=np.int64)))
        for rt in rts:
            rt.shutdown()
    finally:
        m.shutdown()
    made = [p for p in made if p is not None and p.resolve()]
    assert made
    return eng, made


FUSED = ("@app:name('fz') @app:playback @app:execution('tpu') @app:fuse "
         "define stream SIn (sym int, price float, vol int); "
         "define stream Mid (sym int, price float, vol int); "
         "define stream Win (sym int, total double); "
         "@info(name='q1') from SIn[price > 5.0] "
         "select sym, price, vol insert into Mid; "
         "@info(name='q2') from Mid#window.length(4) "
         "select sym, sum(price) as total insert into Win; "
         "@info(name='q3') from every e1=Win[total > 30.0] "
         "-> e2=Win[total > e1.total] "
         "select e1.sym as s1, e1.total as t1, e2.total as t2 "
         "insert into Out;")


def case_fused(rng, device="cpu"):
    """A fused chain's dense tail (filter, ``length(4)`` sum, pattern):
    each batch's ``FusedDeferredEmit``, recorded as the chain makes it,
    must give the selection's rows as the tail's typed columns, stamped
    with their events' times; its ``DeferredDenseEmit`` is the case."""
    from siddhi_tpu_torch import SiddhiManager

    m = SiddhiManager(device=device)
    try:
        rt = m.create_siddhi_app_runtime(FUSED)
        rt.start()
        graph = rt.query_runtimes["q3"].device_runtime.graph
        eng = graph.dense
        made = []
        orig = graph.process_batch_deferred

        def record(*a, **kw):
            states, pending = orig(*a, **kw)
            made.append(pending)
            return states, pending
        graph.process_batch_deferred = record
        for i in range(4):
            n = 300 + 37 * i
            rt.get_input_handler("SIn").send_batch(EventBatch(
                "SIn", ["sym", "price", "vol"], {
                    "sym": rng.integers(0, 5, n).astype(np.int32),
                    "price": rng.uniform(0, 30, n).astype(np.float32),
                    "vol": rng.integers(1, 100, n).astype(np.int32)},
                1000 + 10 * i + np.arange(n, dtype=np.int64)))
        rt.shutdown()
    finally:
        m.shutdown()
    made = [p for p in made if p is not None and p.resolve()]
    assert made and all(len(p.dense.parts) == 1 for p in made)
    for p in made:
        cols, ts = p.materialize(fetch_coalesced(p.device_arrays()))
        want_ev, want_cols = selection(eng, p.dense)
        assert np.array_equal(ts, p.ts64[want_ev])
        for oi, nm in enumerate(eng.output_names):
            want = np.asarray(want_cols[oi], dtype=(
                np.int64 if eng.out_int[oi] else np.float32))
            want = want.astype(eng.out_dtypes[oi])
            assert cols[nm].dtype == want.dtype
            assert np.array_equal(cols[nm].view(np.uint8),
                                  want.view(np.uint8))
    return eng, [p.dense for p in made]


CASES = {"general_via": case_general_via, "batch_chunk": case_batch_chunk,
         "sharded": case_sharded, "multiplex": case_multiplex,
         "fused": case_fused, "full_lanes": case_full_lanes,
         "one_row": case_one_row}


@pytest.mark.parametrize("name", list(CASES))
def test_compacted_emit_equals_the_dense_selection(name):
    torch.manual_seed(0)
    eng, pending = CASES[name](np.random.default_rng(7))
    for p in pending if isinstance(pending, list) else [pending]:
        assert check(eng, p) > 0


COUNTED = ("@app:playback @app:statistics('true') "
           "@app:execution('tpu', partitions='8', instances='4') "
           "define stream Txn (key long, v double); "
           "partition with (key of Txn) begin "
           "@info(name='q') from every e1=Txn[v > 0.0] -> e2=Txn[v > 100.0] "
           "within 10 min "
           "select e1.key as k, e1.v as a, e2.v as b insert into Out; "
           "end;")


def test_emit_counters_count_the_compacted_bytes():
    """``compactedChunks`` counts the parts with matches (here one a
    collision round), ``hostMergedRows`` the rows of a batch of several
    rounds and ``emitBytes`` the compacted tensors' bytes (an int64 ``[m,
    1 + n_int]`` and a float32 ``[m, O]`` a part); a batch with no match
    adds to none.  All are in the statistics feed."""
    from siddhi_tpu_torch import SiddhiManager

    m = SiddhiManager(device="cpu")
    try:
        rt = m.create_siddhi_app_runtime(COUNTED)
        got = []
        rt.add_callback("Out", lambda evs: got.extend(evs))
        rt.start()
        h = rt.get_input_handler("Txn")
        proc = rt.partitions["partition_0"].dense_query_runtimes[
            "q"].pattern_processor
        stats = proc.emit_stats

        def send(keys, vs, t0):
            h.send_batch(EventBatch(
                "Txn", ["key", "v"], {"key": np.asarray(keys, np.int64),
                                      "v": np.asarray(vs, np.float64)},
                t0 + np.arange(len(keys), dtype=np.int64)))

        def counters():
            return (stats.compacted_chunks, stats.host_merged_rows,
                    stats.emit_bytes)

        # arming only: no match
        send([5, 6, 5], [1.0, 2.0, 3.0], 1000)
        assert counters() == (0, 0, 0)
        # key 5 collides, so its second event lands in round 2: round 1
        # completes key 5's two instances and key 6's one, round 2 the
        # instance key 5's first event armed
        send([5, 6, 5], [150.0, 150.0, 160.0], 2000)
        eng = proc.engine
        n_int = sum(eng.out_int)
        O = max(len(eng.out_spec), 1)
        assert len(got) == 4
        assert stats.compacted_chunks == 2
        assert stats.host_merged_rows == len(got)
        assert stats.emit_bytes == len(got) * (8 * (1 + n_int) + 4 * O)
        before = counters()
        send([7], [1.0], 3000)
        assert counters() == before
        feed = {k.rsplit(".", 1)[1]: v for k, v in rt.statistics().items()
                if ".Queries.q." in k}
        assert feed["compactedChunks"] == stats.compacted_chunks
        assert "cardOrderedChunks" not in feed
        assert feed["hostMergedRows"] == stats.host_merged_rows
        assert feed["emitBytes"] == stats.emit_bytes
        rt.shutdown()
    finally:
        m.shutdown()


# -- the order on the device ---------------------------------------------

I32_MIN, I32_MAX = -2**31, 2**31 - 1


def _banks(rng, b, L, anchors, n_int=1, O=3, p=0.5):
    """Dense banks ``(emit, f, i, anchor)`` of ``b`` rows and ``L``
    lanes: about ``p`` of the lanes set, anchors drawn from
    ``anchors``."""
    emit = rng.random((b, L)) < p
    emit[0, :] = True  # one row with every lane set
    f = rng.standard_normal((b, L, O)).astype(np.float32)
    i = rng.integers(I32_MIN, I32_MAX, (b, L, 2 * n_int), endpoint=True,
                     dtype=np.int64).astype(np.int32)
    anchor = rng.choice(np.asarray(anchors, dtype=np.int64),
                        (b, L)).astype(np.int32)
    return emit, f, i, anchor


def host_compaction(emit, f, i, anchor, row0):
    """The host's order and values: ``np.nonzero``, then ``np.lexsort``
    over (row, anchor, lane), the integer outputs joined by
    ``_i64_join``."""
    rows, lanes = np.nonzero(emit)
    order = np.lexsort((lanes, anchor[rows, lanes], rows))
    rows, lanes = rows[order], lanes[order]
    sel = i[rows, lanes]
    return (rows + row0, _i64_join(sel[:, 0::2], sel[:, 1::2]),
            f[rows, lanes])


def _anchor_set(kind):
    return {"several_per_event": list(range(1, 200)),
            "equal_anchors": [7, 7, 7, 9],
            "int32_extremes": [I32_MIN, I32_MIN + 1, -1, 0, 1,
                               I32_MAX - 1, I32_MAX]}[kind]


@pytest.mark.parametrize("kind", ["several_per_event", "equal_anchors",
                                  "int32_extremes", "past_63_bits",
                                  "general_rounds", "sharded"])
def test_card_order_equals_the_host_lexsort(kind):
    """The compaction's order on the device is the host's ``np.lexsort``
    over (event, anchor, lane): the same rows, in the same order, with
    the same values; for a shape whose key would pass 63 bits the
    stable sorts give it too; through an engine, a general batch of
    several collision rounds and a sharded round."""
    if kind in ("general_rounds", "sharded"):
        torch.manual_seed(0)
    rng = np.random.default_rng(7)
    if kind == "general_rounds":
        eng, pending = case_general_via(rng)
        assert len(pending.parts) >= 2
        assert check(eng, pending) > 0
        return
    if kind == "sharded":
        eng, pending = case_sharded(rng)
        assert len(pending.parts) >= 2
        assert check(eng, pending) > 0
        return
    if kind == "past_63_bits":
        emit, _f, _i, anchor = _banks(rng, 40, 16, _anchor_set(
            "int32_extremes") + [5, 5, 5])
        rows, lanes = np.nonzero(emit)
        want = np.lexsort((lanes, anchor[rows, lanes], rows))
        r, ln = torch.from_numpy(rows), torch.from_numpy(lanes)
        a = torch.from_numpy(anchor[rows, lanes])
        # a bank of 2**40 rows and 16 lanes: 40 + 32 + 4 bits
        wide = match_order(r, a, ln, 2**40, 16)
        narrow = match_order(r, a, ln, 40, 16)
        assert np.array_equal(wide.numpy(), want)
        assert np.array_equal(narrow.numpy(), want)
        return
    emit, f, i, anchor = _banks(rng, 37, 12, _anchor_set(kind))
    if kind == "several_per_event":
        assert (emit.sum(axis=1) > 1).sum() > 10
    m, row0 = int(emit.sum()), 100
    head, flt = (t.numpy() for t in compact_matches(
        torch.from_numpy(emit), torch.from_numpy(f), torch.from_numpy(i),
        torch.from_numpy(anchor), m, row0))
    want_rows, want_ints, want_f = host_compaction(emit, f, i, anchor, row0)
    assert head.dtype == np.int64 and flt.dtype == np.float32
    assert np.array_equal(head[:, 0], want_rows)
    assert np.array_equal(head[:, 1:], want_ints)
    assert np.array_equal(flt.view(np.int32), want_f.view(np.int32))


# -- the types on the device ---------------------------------------------

JOIN_EDGES = np.array([0, -1, 2**31, -2**63, 2**63 - 1], dtype=np.int64)


def test_card_join_equals_i64_join():
    """The int64 the compaction joins from each hi/lo pair on the device
    is ``_i64_join``'s, and the value ``prepare_cols`` split, at 0, -1,
    2**31, -2**63 and 2**63 - 1."""
    n = len(JOIN_EDGES)
    hi = (JOIN_EDGES >> 32).astype(np.int32)
    lo = ((JOIN_EDGES & 0xFFFFFFFF) - 2**31).astype(np.int32)
    # one lane a value, two integer outputs (the second reversed)
    i = np.stack([hi, lo, hi[::-1], lo[::-1]], axis=1)[:, None, :]
    emit = np.ones((n, 1), dtype=bool)
    f = np.zeros((n, 1, 2), dtype=np.float32)
    anchor = np.ones((n, 1), dtype=np.int32)
    head, _f = (t.numpy() for t in compact_matches(
        torch.from_numpy(emit), torch.from_numpy(f), torch.from_numpy(i),
        torch.from_numpy(anchor), n))
    assert np.array_equal(head[:, 1], _i64_join(hi, lo))
    assert np.array_equal(head[:, 1], JOIN_EDGES)
    assert np.array_equal(head[:, 2], JOIN_EDGES[::-1])


def _bench_config(name):
    import json
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from cepbench.generator import Traffic, merge

    config = json.loads((root / "cepbench" / "configs"
                         / f"{name}.json").read_text())
    config = merge(config, {"sizes": {"partitions": 256, "lanes": 32}})
    spec = merge(json.loads((root / "cepbench" / "traffic"
                             / "txn_hot100k.json").read_text()),
                 {"batch": 512, "columns": {"key": {"high": 64}}})
    return config, Traffic(spec, 2**31 + 29)


@pytest.mark.parametrize("name,route", [("fraud16_1m", "general"),
                                        ("chain16_1m", "batch")])
def test_stream_callback_gets_the_object_matrix_columns(monkeypatch, name,
                                                        route):
    """The benchmark's two queries at 256 partitions: each batch a
    ``StreamCallback`` receives holds the columns the object matrix
    gave before the rows came typed: each output of the dense
    selection boxed as the JAX engine boxes it (exact ints, float64
    values) and cast to its attribute's type, so a long arrives as
    int64 and a double as float64, value for value."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.stream import StreamCallback
    from siddhi_tpu_torch.ops.dense_nfa import DeferredDenseEmit

    config, traffic = _bench_config(name)
    wants = []
    orig = DeferredDenseEmit.materialize

    def spy(self, host):
        got = orig(self, host)
        _ev, cols = selection(self.engine, self)
        mat = np.empty((len(cols[0]), len(cols)), dtype=object)
        for oi, is_int in enumerate(self.engine.out_int):
            mat[:, oi] = (cols[oi] if is_int else
                          np.asarray(cols[oi], np.float32).astype(np.float64))
        wants.append(mat)
        return got
    monkeypatch.setattr(DeferredDenseEmit, "materialize", spy)

    class Keep(StreamCallback):
        def __init__(self):
            self.got = []

        def receive_batch(self, batch):
            self.got.append(batch)

    mgr = SiddhiManager(device="cpu")
    try:
        rt = mgr.create_siddhi_app_runtime(
            config["app"].format(**config["sizes"]))
        keep = Keep()
        rt.add_callback(config["output"], keep)
        rt.start()
        h = rt.get_input_handler(config["input"])
        for b in range(8):
            cols, ts = traffic.batch(b)
            h.send_batch(EventBatch(traffic.stream, traffic.names, cols, ts))
        rt.drain()
        (runtime,) = rt.pattern_runtimes().values()
        assert runtime.engine.step_kind == route
        names = runtime.engine.output_names
        types = dict(zip(names, runtime.engine.out_types))
        rt.shutdown()
    finally:
        mgr.shutdown()
    assert len(keep.got) == len(wants) > 0
    assert sum(len(m) for m in wants) > 0
    for batch, mat in zip(keep.got, wants):
        for oi, nm in enumerate(names):
            got = np.asarray(batch.columns[nm])
            want = mat[:, oi].astype(types[nm].np_dtype)
            assert got.dtype == want.dtype
            assert got.dtype == (np.int64 if nm == "key" else np.float64)
            assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


# -- the counters --------------------------------------------------------

ORDERED = ("@app:playback @app:statistics('true') "
           "@app:execution('tpu', partitions='8', instances='4') "
           "define stream Txn (key long, v double); "
           "partition with (key of Txn) begin "
           "@info(name='q') from every e1=Txn[v > 1.0] -> e2=Txn[v > 2.0] "
           "within 10 min select e2.key as k, e2.v as v insert into Out; "
           "end;")


def test_batch_route_orders_one_chunk_a_batch_on_the_card():
    """The batch route: one ``compactedChunks`` for each batch with
    matches, none for a batch without, and no ``hostMergedRows``, even
    when a key sees several events in a batch."""
    from siddhi_tpu_torch import SiddhiManager

    m = SiddhiManager(device="cpu")
    try:
        rt = m.create_siddhi_app_runtime(ORDERED)
        got = []
        rt.add_callback("Out", lambda evs: got.extend(evs))
        rt.start()
        h = rt.get_input_handler("Txn")
        proc = rt.partitions["partition_0"].dense_query_runtimes[
            "q"].pattern_processor
        assert proc.engine.step_kind == "batch"
        stats = proc.emit_stats
        with_rows = 0
        for c, (keys, vs) in enumerate([
                ([1, 2, 1], [1.5, 1.5, 1.6]),        # arming only
                ([1, 2, 1, 3], [2.5, 2.5, 1.5, 0.5]),  # 1 and 2 complete
                ([3, 3], [0.1, 0.2]),                # nothing
                ([1, 1, 2], [2.2, 2.3, 1.1])]):      # key 1 twice
            before = len(got)
            h.send_batch(EventBatch(
                "Txn", ["key", "v"], {"key": np.asarray(keys, np.int64),
                                      "v": np.asarray(vs, np.float64)},
                1000 * (c + 1) + np.arange(len(keys), dtype=np.int64)))
            with_rows += len(got) > before
            assert stats.compacted_chunks == with_rows
            assert stats.host_merged_rows == 0
        assert with_rows == 2 and len(got) > 2
        feed = {k.rsplit(".", 1)[1]: v for k, v in rt.statistics().items()
                if ".Queries.q." in k}
        assert feed["compactedChunks"] == with_rows
        assert feed["hostMergedRows"] == 0
        rt.shutdown()
    finally:
        m.shutdown()
