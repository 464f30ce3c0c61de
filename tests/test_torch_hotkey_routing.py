"""The port's ``SiddhiManager`` product path against the JAX package's.

The same app string and the same sends go through the JAX package's
``SiddhiManager`` (JAX on the CPU, its dense XLA step and its two-pass
associative scan, which it pins identical to its kernels) and through
the port's ``SiddhiManager(device="cpu")`` (the packed step's and the
fused scan's plain twins).  Callbacks must agree in data, timestamp and
order, batch by batch, and the router's ``hot_metrics()`` must agree,
with promotion counters showing that the scan path engaged.

Sizes follow ``tests/test_hotkey_routing.py``: a few hundred single
sends over 30 keys, or a few small Zipf batches through ``send_batch``.
"""

import numpy as np
import pytest
import torch

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.core.event import EventBatch as JaxEventBatch
from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.core.hotkey_router import HotKeyRouterRuntime

DEFINE = "define stream S (k long, u double, v double); "
TPU = "@app:execution('tpu', instances='16') "
HOTKEYS = "@app:hotkeys(k='4', promote='0.3', demote='0.1') "


def wrap(q):
    return f"partition with (k of S) begin {q} end;"


SHAPES = {
    "pair": (
        "@info(name='q') from every a=S[v > 8.0] -> b=S[v > 12.0] "
        "select b.v as bv insert into Alerts;"),
    "triple": (
        "@info(name='q') from every a=S[v > 4.0] -> b=S[u > 6.0] "
        "-> c=S[v > 10.0] "
        "select c.u as cu, c.v as cv insert into Alerts;"),
    "quad_two_filters": (
        "@info(name='q') from every a=S[u > 3.0 and v > 3.0] "
        "-> b=S[v > 6.0] -> c=S[u > 9.0] -> d=S[v > 12.0] "
        "select d.u as du, d.v as dv insert into Alerts;"),
}

SKEWED = [(400, 7, 0.8)]  # one hot key at 80% of traffic


def gen(seed, phases, dt_max=40):
    """Event stream in phases of (n, hot_key, p_hot), as
    ``tests/test_hotkey_routing.py`` makes it."""
    rng = np.random.default_rng(seed)
    out, t = [], 1000
    for n, hot_key, p_hot in phases:
        for _ in range(n):
            t += int(rng.integers(1, dt_max))
            k = (int(hot_key) if hot_key is not None
                 and rng.random() < p_hot else int(rng.integers(0, 30)))
            out.append(([k, round(float(rng.uniform(0, 20)), 1),
                         round(float(rng.uniform(0, 20)), 1)], t))
    return out


def jax_router(rt):
    for pr in rt.partitions.values():
        for qr in pr.dense_query_runtimes.values():
            return qr.pattern_processor


class Run:
    """One app on one package: sends rows or batches, collects every
    callback batch as [(timestamp, data), ...]."""

    def __init__(self, port, app, header):
        self.mgr = (SiddhiManager(device="cpu") if port else JaxManager())
        self.port = port
        self.rt = self.mgr.create_siddhi_app_runtime(header + DEFINE + app)
        self.got = []
        self.rt.add_callback("Alerts", lambda evs: self.got.append(
            [(e.timestamp, list(e.data)) for e in evs]))
        self.rt.start()
        self.h = self.rt.get_input_handler("S")

    def send(self, sends):
        for row, ts in sends:
            self.h.send(list(row), timestamp=ts)
        return self

    def send_batches(self, batches):
        cls = EventBatch if self.port else JaxEventBatch
        for ks, u, v, ts in batches:
            self.h.send_batch(cls("S", ["k", "u", "v"],
                                  {"k": ks, "u": u, "v": v}, ts))
        return self

    @property
    def router(self):
        if self.port:
            return self.rt.pattern_runtimes().get("q")
        return jax_router(self.rt)

    def finish(self):
        low = self.rt.lowering()
        router = self.router
        hot = router.hot_metrics() if hasattr(router, "hot_metrics") else {}
        self.rt.shutdown()
        self.mgr.shutdown()
        return self.got, low, hot


def both(app, header, sends=None, batches=None):
    out = []
    for port in (False, True):
        r = Run(port, app, header)
        if sends is not None:
            r.send(sends)
        if batches is not None:
            r.send_batches(batches)
        out.append(r.finish())
    return out


def assert_same(jres, tres):
    (jgot, jlow, jhot), (tgot, tlow, thot) = jres, tres
    assert tlow == jlow
    assert thot == jhot
    assert [len(b) for b in tgot] == [len(b) for b in jgot]
    assert tgot == jgot


class TestRoutedDifferential:
    @pytest.mark.parametrize("shape", sorted(SHAPES))
    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_shape_matches_reference(self, shape, seed):
        jres, tres = both(wrap(SHAPES[shape]), "@app:playback " + TPU + HOTKEYS,
                          sends=gen(seed, SKEWED))
        assert_same(jres, tres)
        assert tres[1]["q"] == "hotkey"
        assert tres[2]["hotkeyPromotions"] >= 1, tres[2]
        assert tres[2]["hotkeyRoutedEvents"] > 0
        assert sum(len(b) for b in tres[0]) > 0

    @pytest.mark.parametrize("seed", [11, 12])
    def test_promote_demote_midstream(self, seed):
        sends = gen(seed, [(350, 7, 0.85), (350, None, 0.0)])
        jres, tres = both(wrap(SHAPES["pair"]),
                          "@app:playback " + TPU + HOTKEYS, sends=sends)
        assert_same(jres, tres)
        assert tres[2]["hotkeyPromotions"] >= 1
        assert tres[2]["hotkeyDemotions"] >= 1

    def test_rehot_after_demotion(self):
        sends = gen(21, [(300, 7, 0.85), (250, None, 0.0), (300, 7, 0.85)])
        jres, tres = both(wrap(SHAPES["pair"]),
                          "@app:playback " + TPU + HOTKEYS, sends=sends)
        assert_same(jres, tres)
        assert tres[2]["hotkeyPromotions"] >= 2
        assert tres[2]["hotkeyDemotions"] >= 1

    def test_multiple_hot_keys(self):
        rng = np.random.default_rng(31)
        sends, t = [], 1000
        for _ in range(500):
            t += int(rng.integers(1, 40))
            r = rng.random()
            k = 7 if r < 0.4 else (13 if r < 0.8 else int(rng.integers(0, 30)))
            sends.append(([k, round(float(rng.uniform(0, 20)), 1),
                           round(float(rng.uniform(0, 20)), 1)], t))
        jres, tres = both(wrap(SHAPES["triple"]),
                          "@app:playback " + TPU + HOTKEYS, sends=sends)
        assert_same(jres, tres)
        assert tres[2]["hotkeyPromotions"] >= 2
        assert tres[2]["hotkeyActiveKeys"] >= 2

    def test_deferred_emit_and_ingest_depths(self):
        """emit.depth and ingest.depth defer the count gate and the
        fetch; callbacks stay the same batches in the same order."""
        header = ("@app:playback @app:execution('tpu', instances='16', "
                  "emit.depth='3', ingest.depth='2') " + HOTKEYS)
        app, sends = wrap(SHAPES["pair"]), gen(4, [(300, 7, 0.8)])
        jres = Run(False, app, header).send(sends).finish()
        t = Run(True, app, header).send(sends)
        dense = t.router._dense
        assert dense.emit_queue.depth == 3 and dense.ingest_stage.depth == 2
        # staged puts count every dense round and scan cycle; barriers
        # (handoffs) flush the staging window and drain the emit queue
        ist, est = dense.ingest_stats, dense.emit_stats
        assert ist.device_puts >= ist.staged_batches >= len(sends)
        assert ist.max_staging_depth == 2 and ist.flush_syncs > 0
        assert est.max_pending_depth <= 3 and est.deferred_batches > 0
        assert est.emit_transfers > 0 and est.zero_match_skips > 0
        tres = t.finish()
        assert_same(jres, tres)
        assert tres[2]["hotkeyPromotions"] >= 1

    def test_zipf_batches_as_bench_hot_key(self):
        """bench.py's hot-key app and Zipf(1.2) traffic at a small size:
        whole batches through send_batch, one junction cycle each."""
        rng = np.random.default_rng(23)
        batches = []
        for i in range(4):
            ks = ((rng.zipf(1.2, 256) - 1) % 64).astype(np.int64)
            batches.append((ks, rng.uniform(0.0, 20.0, 256),
                            rng.uniform(0.0, 20.0, 256),
                            np.full(256, 1_000 + i * 10, dtype=np.int64)))
        base = "@app:playback @app:execution('tpu', instances='8') "
        hot = "@app:hotkeys(k='8', promote='0.1', demote='0.04') "
        # the reference runs its XLA steps; in the port @app:kernels
        # switches nothing (its steps are always the kernels' twins here)
        kern = "@app:kernels('nfa,scan') "
        app = wrap(SHAPES["pair"])
        out = {}
        for name, header in (("routed", base + hot), ("dense", base)):
            j = Run(False, app, header).send_batches(batches).finish()
            t = Run(True, app, header + kern).send_batches(batches).finish()
            assert_same(j, t)
            out[name] = t
        assert out["routed"][1] == {"q": "hotkey"}
        assert out["routed"][2]["hotkeyPromotions"] >= 1
        # bench.py's own check: routed rows == dense-only rows
        assert (sum(len(b) for b in out["routed"][0])
                == sum(len(b) for b in out["dense"][0]) > 0)


class TestInstanceCapacity:
    def test_dense_only_drops_where_routed_counts(self):
        """At a small instance capacity the dense-only run drops pending
        chains of the hot key (counted in ``overflow``) that the routed
        run's scan keeps as exact counts, so the routed run emits more
        rows; each drop costs at most one match in this two-node chain.
        Both packages agree on every row of both runs."""
        sends = gen(9, SKEWED)
        app = wrap(SHAPES["pair"])
        base = "@app:playback @app:execution('tpu', instances='2') "
        res = {}
        for name, header in (("routed", base + HOTKEYS), ("dense", base)):
            runs = [Run(port, app, header).send(sends) for port in (False, True)]
            drops = [r.router.overflow_total() for r in runs]
            got = [r.finish() for r in runs]
            assert_same(*got)
            assert drops[0] == drops[1]
            res[name] = (sum(len(b) for b in got[1][0]), drops[1])
        (routed, routed_drops), (dense, dense_drops) = res["routed"], res["dense"]
        assert dense_drops > routed_drops
        assert dense < routed <= dense + (dense_drops - routed_drops)


class TestDenseProductPath:
    @pytest.mark.parametrize("shape", ["pair", "triple"])
    def test_dense_only_matches_reference(self, shape):
        jres, tres = both(wrap(SHAPES[shape]), "@app:playback " + TPU,
                          sends=gen(5, SKEWED))
        assert_same(jres, tres)
        assert tres[1] == {"q": "dense"}
        assert sum(len(b) for b in tres[0]) > 0

    def test_within_chain_matches_reference(self):
        app = wrap("@info(name='q') from every a=S[v > 8.0] -> b=S[v > 12.0] "
                   "within 200 millisec select b.v as bv, b.k as bk "
                   "insert into Alerts;")
        jres, tres = both(app, "@app:playback " + TPU, sends=gen(6, SKEWED))
        assert_same(jres, tres)

    def test_pattern_runtime_snapshot_is_the_reference_tree(self):
        sends = gen(7, SKEWED)
        j = Run(False, wrap(SHAPES["pair"]), "@app:playback " + TPU).send(sends)
        t = Run(True, wrap(SHAPES["pair"]), "@app:playback " + TPU).send(sends)
        jsnap, tsnap = j.router.snapshot(), t.router.snapshot()
        assert sorted(tsnap) == sorted(jsnap)
        for k in ("base_ts", "key_rows", "next_row", "free_rows"):
            assert tsnap[k] == jsnap[k], k
        assert np.array_equal(tsnap["row_last_used"], jsnap["row_last_used"])
        for k, v in jsnap["dense_state"].items():
            if k in ("active", "first_ts", "overflow"):
                assert np.array_equal(tsnap["dense_state"][k], v), k
        j.finish()
        t.finish()


class TestReferenceSnapshotRestore:
    def test_reference_router_snapshot_continues_in_both(self):
        """A JAX run's router snapshot (dense tree + sketch) restores
        into the port; both then continue on the same sends and emit the
        same callbacks, the port re-promoting from the restored sketch."""
        sends = gen(61, SKEWED)
        app = wrap(SHAPES["pair"])
        header = "@app:playback " + TPU + HOTKEYS
        j = Run(False, app, header).send(sends[:250])
        assert j.router.hot_metrics()["hotkeyActiveKeys"] >= 1
        snap = j.router.snapshot()  # demotes every hot key first
        j.got.clear()
        t = Run(True, app, header)
        router = t.router
        assert isinstance(router, HotKeyRouterRuntime)
        router.restore(snap)
        j.send(sends[250:])
        t.send(sends[250:])
        jgot, _, _ = j.finish()
        tgot, _, thot = t.finish()
        assert thot["hotkeyPromotions"] >= 1
        assert len(tgot) > 0 and tgot == jgot

    def test_port_snapshot_round_trip(self):
        """snapshot() demotes into a dense tree; restore rewinds a stray
        event, as the reference's persistence test does."""
        sends = gen(62, SKEWED)
        app = wrap(SHAPES["pair"])
        header = "@app:playback " + TPU + HOTKEYS
        runs = []
        for port in (False, True):
            r = Run(port, app, header).send(sends[:250])
            snap = r.router.snapshot()
            r.h.send([7, 15.0, 15.0], timestamp=sends[249][1] + 5)
            r.router.restore(snap)
            runs.append(r.send(sends[250:]).finish())
        assert_same(*runs)


INELIGIBLE_STAYS_DENSE = {
    "within": (
        "@info(name='q') from every a=S[v > 8.0] -> b=S[v > 12.0] "
        "within 3 sec select b.v as bv insert into Alerts;"),
    "long_filter": (
        "@info(name='q') from every a=S[k > 3] -> b=S[v > 12.0] "
        "select b.v as bv insert into Alerts;"),
    # a select of a non-final node: the general (register-file) step
    "non_final_select": (
        "@info(name='q') from every a=S[v > 8.0] -> b=S[v > 12.0] "
        "select a.v as av, b.v as bv insert into Alerts;"),
}


class TestHotkeyFallback:
    @pytest.mark.parametrize("shape", sorted(INELIGIBLE_STAYS_DENSE))
    def test_ineligible_stays_dense_with_reference_reason(self, shape):
        app = wrap(INELIGIBLE_STAYS_DENSE[shape])
        header = "@app:playback " + TPU + HOTKEYS
        j = Run(False, app, header)
        reasons = [v for k, v in j.rt.statistics().items()
                   if k.endswith("hotkeyFallbackReason")]
        t = Run(True, app, header)
        assert t.rt.app_context.hotkey_fallbacks == {"q": reasons[0]}
        sends = gen(8, SKEWED)
        j.send(sends)
        t.send(sends)
        assert_same(j.finish(), t.finish())

    def test_multi_stream_chain_stays_dense_with_reference_reason(self):
        """A chain over two partitioned streams: both packages keep it
        dense with the same reason and emit the same rows."""
        app = ("define stream T (k long, u double, v double); "
               "partition with (k of S, k of T) begin @info(name='q') "
               "from every a=S[v > 8.0] -> b=T[v > 12.0] "
               "select b.v as bv insert into Alerts; end;")
        rng = np.random.default_rng(3)
        sends = [("S" if rng.random() < 0.5 else "T",
                  [int(7 if rng.random() < 0.8 else rng.integers(0, 30)),
                   1.0, round(float(rng.uniform(0, 20)), 1)], 1000 + 10 * i)
                 for i in range(300)]
        runs = [Run(port, app, "@app:playback " + TPU + HOTKEYS)
                for port in (False, True)]
        reasons = [v for k, v in runs[0].rt.statistics().items()
                   if k.endswith("hotkeyFallbackReason")]
        assert runs[1].rt.app_context.hotkey_fallbacks == {"q": reasons[0]}
        for r in runs:
            for sid, row, ts in sends:
                r.rt.get_input_handler(sid).send(row, timestamp=ts)
        jres, tres = (r.finish() for r in runs)
        assert_same(jres, tres)
        assert tres[1] == {"q": "dense"} and sum(len(b) for b in tres[0]) > 0

    def test_non_final_select_needs_the_general_dense_step(self):
        """The reference keeps this shape dense through its general
        (register-file) step; so does the port, whose engine takes the
        general step for it, fixed at compile time."""
        app = wrap(INELIGIBLE_STAYS_DENSE["non_final_select"])
        r = Run(True, app, "@app:playback " + TPU + HOTKEYS)
        assert r.rt.lowering(step_kinds=True) == {"q": "dense/general"}
        assert "captured attributes" in r.rt.app_context.hotkey_fallbacks["q"]
        r.send(gen(9, SKEWED))
        got, low, hot = r.finish()
        assert low == {"q": "dense"} and hot == {} and got


class TestOutsideTheSlice:
    @pytest.mark.parametrize("app", [
        # a partial-chain group-every: the reference's host engine,
        # ROADMAP.md §1 item 7
        wrap("@info(name='q') from every (a=S[v > 8.0] -> b=S[v > 12.0]) "
             "-> c=S[v > 1.0] select c.v as cv insert into Alerts;"),
        # a non-pattern query inside the partition that the reference
        # runs on per-key host instances (a tumbling window), ROADMAP.md
        # §1 item 7 (filters and sliding windows run on the device query
        # path, tests/test_torch_device_partitioned.py)
        wrap("@info(name='q') from S#window.lengthBatch(3) select v "
             "insert into Alerts;"),
        # a leading absent deadline: the reference's host engine,
        # ROADMAP.md §1 item 7 (other absent nodes run dense,
        # tests/test_torch_absent.py)
        wrap("@info(name='q') from not S[v > 12.0] for 1 sec -> "
             "c=S[v > 1.0] select c.v as cv insert into Alerts;"),
        # an aggregating select with order by: the reference keeps its
        # per-key chunks on host instances (a plain aggregating select
        # runs since the host query runtime came to the port)
        wrap("@info(name='q') from every a=S[v > 8.0] -> b=S[v > 12.0] "
             "select count() as n order by n insert into Alerts;"),
    ], ids=["partial_group_every", "non_pattern", "absent", "aggregating"])
    def test_raises_creation_error(self, app):
        """What the device paths cannot take moves the partition to
        per-key host instances, as in the reference: the same rows and
        ``lowering()`` (the name is the test's from when the port
        refused these apps)."""
        jres, tres = both(app, "@app:playback " + TPU, sends=gen(5, SKEWED))
        assert_same(jres, tres)
        assert set(tres[1].values()) == {"host"} and tres[2] == {}
        assert sum(len(b) for b in tres[0]) > 0

    @pytest.mark.parametrize("app", [
        # a capture in a filter: the general step
        wrap("@info(name='q') from every a=S[v > 8.0] -> b=S[v > a.v] "
             "select b.v as bv insert into Alerts;"),
        # an unpartitioned pattern query: one partition
        SHAPES["pair"],
        # a count: the general step
        wrap("@info(name='q') from every a=S[v > 8.0] -> b=S[v > 12.0]<2> "
             "select b[last].v as bv insert into Alerts;"),
        # a sequence: the general step
        wrap("@info(name='q') from every a=S[v > 8.0], b=S[v > 12.0] "
             "select b.v as bv insert into Alerts;"),
        # an aggregating select: the host selector over the match rows,
        # per key
        wrap("@info(name='q') from every a=S[v > 8.0] -> b=S[v > 12.0] "
             "select count() as n, max(b.v) as m insert into Alerts;"),
    ], ids=["capture", "unpartitioned", "count", "sequence", "aggregating"])
    def test_runs_as_the_reference(self, app):
        """Once refused, these now run: the same rows as the reference."""
        jres, tres = both(app, "@app:playback " + TPU, sends=gen(5, SKEWED))
        assert_same(jres, tres)
        assert sum(len(b) for b in tres[0]) > 0

    def test_partition_needs_tpu_execution(self):
        """Without ``execution('tpu')`` the partition runs on per-key host
        instances, as the reference's default mode does."""
        jres, tres = both(wrap(SHAPES["pair"]), "@app:playback ",
                          sends=gen(5, SKEWED))
        assert_same(jres, tres)
        assert tres[1] == {"q": "host"} and sum(len(b) for b in tres[0])

    @pytest.mark.parametrize("header,match", [
        ("@app:hotkeys(k='4') ", "hotkeys needs"),
        (TPU + "@app:hotkeys(promote='0.2', demote='0.4') ", "demote"),
        (TPU + "@app:hotkeys(k='300') ", "1..256"),
        (TPU + "@app:kernels('nfa,warp') ", "unknown kernel kind"),
        ("@app:kernels ", "needs @app:execution"),
        ("@app:execution('tpu', emit.depth='auto') ", "later slice"),
        ("@app:execution('tpu', partitions='0') ", "positive integer"),
        (TPU + "@app:faults(journal='8') ", "later slice"),
    ])
    def test_annotations_validated_as_reference(self, header, match):
        with pytest.raises(SiddhiAppCreationError, match=match):
            SiddhiManager(device="cpu").create_siddhi_app_runtime(
                header + DEFINE + wrap(SHAPES["pair"]))

    def test_persistence_store_refused(self):
        with pytest.raises(SiddhiAppCreationError, match="later slice"):
            SiddhiManager(device="cpu").set_persistence_store(object())

    def test_manager_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: the default device works")
        with pytest.raises(SiddhiAppCreationError, match="CUDA"):
            SiddhiManager()
