"""Incremental aggregation in the port against the JAX package.

The same app strings and the same seeded events go through the JAX
package's ``SiddhiManager`` and the port's ``SiddhiManager(device="cpu")``
(the bank's plain reduce on the CPU); every pull (``find`` and
``rt.query``) must return the same rows in the same order.

Modes: host (no annotation: numpy only), ``@app:execution('tpu')`` (the
bucket bank; the JAX package's XLA scatter) and ``@app:kernels('bank')``
(the JAX package's Pallas reduce in interpret mode).  The port runs the
same bank in both device modes.

Tolerances: bucket starts, group keys, counts, int and LONG fields,
extrema and host-mode values are exact.  float32 bank sums (and what is
computed from them: avg, stdDev) are held to the reference's contract,
``n * 2^-24`` relative for a bucket of at most ``n`` events (``REL``);
stdDev, which the rewrite computes as sqrt(sumsq/n - mean^2) over those
float32 sums, to the reference test's own ``abs=5e-3, rel=1e-3``.
"""

import math

import numpy as np
import pytest

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.core.event import EventBatch as JaxBatch
from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import (
    SiddhiAppCreationError,
    StoreQueryCreationError,
)

BASE = 1_496_289_777_000  # 2017-06-01 04:02:57 UTC: a minute turns 3 s in
HOST, TPU, KERNEL = "", "@app:execution('tpu') ", (
    "@app:execution('tpu') @app:kernels('bank') ")
MODES = {"host": HOST, "tpu": TPU, "kernel": KERNEL}

TRADE = ("define stream TradeStream (symbol string, price double, "
         "volume long, timestamp long); ")
DOCS = ("@app:name('TradeAgg') @app:playback {mode}" + TRADE +
        "define aggregation TradeAggregation from TradeStream "
        "select symbol, avg(price) as avgPrice, sum(price) as total "
        "group by symbol aggregate by timestamp every sec ... year;")
WIDE = ("@app:name('TradeAggWide') @app:playback {mode}" + TRADE +
        "define aggregation TradeAggregation from TradeStream "
        "select symbol, avg(price) as avgPrice, sum(price) as total, "
        "sum(volume) as vol, min(price) as lo, max(price) as hi, "
        "min(volume) as vlo, max(volume) as vhi, count() as n "
        "group by symbol aggregate by timestamp every sec ... year;")
WITHIN = f"within {BASE - 60_000}, {BASE + 86_400_000}"


def trade_batches(n_symbols=64, n_batches=8, batch=512, seed=29):
    """The docs cell's traffic at a small size: Zipf(1.2) symbols,
    price ~ U(1, 500), volume ~ [1, 10000), a trade every 2 ms (so 500
    per second bucket, and the minute turns 3 s in)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        sym = (rng.zipf(1.2, batch) - 1) % n_symbols
        i = np.arange(b * batch, (b + 1) * batch)
        out.append(("TradeStream", {
            "symbol": np.asarray([f"S{s:04d}" for s in sym], dtype=object),
            "price": rng.uniform(1.0, 500.0, batch),
            "volume": rng.integers(1, 10_000, batch).astype(np.int64),
            "timestamp": (BASE + 2 * i).astype(np.int64)},
            (BASE + 2 * i).astype(np.int64)))
    return out


def rows_of(events):
    return [(e.timestamp, list(e.data)) for e in events]


def find_rows(rt, agg, per, within=None):
    b = rt.aggregations[agg].find(per, within)
    names = b.attribute_names
    return [(int(t), [b.columns[n][i].item()
                      if hasattr(b.columns[n][i], "item") else b.columns[n][i]
                      for n in names])
            for i, t in enumerate(b.timestamps)]


class Run:
    """One app in one package: feed it, pull from it."""

    def __init__(self, pkg, app):
        self.pkg = pkg
        self.mgr = JaxManager() if pkg == "jax" else SiddhiManager(device="cpu")
        self.rt = self.mgr.create_siddhi_app_runtime(app)
        self.rt.start()

    def batch(self, stream, cols, ts):
        cls = JaxBatch if self.pkg == "jax" else EventBatch
        self.rt.get_input_handler(stream).send_batch(
            cls(stream, list(cols), dict(cols), np.asarray(ts, np.int64)))

    def row(self, stream, row, ts=None):
        self.rt.get_input_handler(stream).send(list(row), timestamp=ts)

    def bank(self, agg):
        return self.rt.aggregations[agg]._bank

    def close(self):
        self.rt.shutdown()
        self.mgr.shutdown()


def both(app):
    return Run("jax", app), Run("port", app)


def assert_rows_close(got, want, rel=0.0, abs_=0.0):
    """Same rows in the same order; floats within ``rel``/``abs_``, all
    else exact."""
    assert len(got) == len(want) and want
    for (tg, dg), (tw, dw) in zip(got, want):
        assert tg == tw and len(dg) == len(dw), ((tg, dg), (tw, dw))
        for g, w in zip(dg, dw):
            assert type(g) is type(w), (dg, dw)
            if isinstance(w, float) and (rel or abs_):
                assert g == pytest.approx(w, rel=rel, abs=abs_), (dg, dw)
            else:
                assert g == w or (isinstance(w, float) and math.isnan(g)
                                  and math.isnan(w)), (dg, dw)


# float32 bank sums: a second bucket holds at most 500 trades here
REL = 500 * 2.0**-24


def pulls(run, agg="TradeAggregation", select="symbol, avgPrice, total"):
    """Every pull form of the slice over one aggregation."""
    q = run.rt.query
    return {
        "query_sec": rows_of(q(f"from {agg} {WITHIN} per 'seconds' "
                              f"select {select};")),
        "query_min": rows_of(q(f"from {agg} {WITHIN} per 'minutes' "
                              f"select {select};")),
        "query_wild_hour": rows_of(q(
            f"from {agg} within '2017-06-01 04:**:**' per 'hours' "
            "select *;")),
        "query_order": rows_of(q(
            f"from {agg} {WITHIN} per 'seconds' select symbol, total "
            "order by total desc limit 7 offset 2;")),
        "query_on": rows_of(q(
            f"from {agg} as a on a.symbol == 'S0001' {WITHIN} per 'minutes' "
            "select a.AGG_TIMESTAMP as t, total * 2.0 as twice;")),
        "find_sec": find_rows(run.rt, agg, "seconds"),
        "find_years": find_rows(run.rt, agg, "years", (0, 1 << 62)),
    }


def run_docs(app, pkg, batches):
    run = Run(pkg, app)
    for stream, cols, ts in batches:
        run.batch(stream, cols, ts)
    return run


@pytest.mark.parametrize("mode", sorted(MODES))
def test_docs_app_matches_reference(mode):
    """The Siddhi docs' TradeAggregation at 64 symbols, 8 batches of 512."""
    app = DOCS.format(mode=MODES[mode])
    bs = trade_batches()
    ref, port = (run_docs(app, pkg, bs) for pkg in ("jax", "port"))
    try:
        want, got = pulls(ref), pulls(port)
        for k in want:
            assert_rows_close(got[k], want[k], rel=REL if mode != "host" else 0)
        if mode != "host":
            b, rb = port.bank("TradeAggregation"), ref.bank("TradeAggregation")
            assert b.names == rb.names == ["_SUM0", "_COUNT1"]
            assert rb.use_kernel == (mode == "kernel")
            assert (b.scatters, b.flushes) == (rb.scatters, rb.flushes)
            assert b.scatters == len(bs)
        else:
            assert port.bank("TradeAggregation") is None
    finally:
        ref.close()
        port.close()


def test_wide_variant_matches_reference():
    """Every lane kind through the runtime: f32 sum/count/min/max, the
    LONG-sum pair, LONG-extrema pairs.  Float sums within ``REL``; the
    extrema (``lo``, ``hi``, ``vlo``, ``vhi``), counts and the LONG sum
    exact."""
    app = WIDE.format(mode=TPU)
    bs = trade_batches(seed=31)
    ref, port = (run_docs(app, pkg, bs) for pkg in ("jax", "port"))
    try:
        sel = "symbol, avgPrice, total, vol, lo, hi, vlo, vhi, n"
        want, got = pulls(ref, select=sel), pulls(port, select=sel)
        for k in want:
            assert_rows_close(got[k], want[k], rel=REL)
        for per in ("seconds", "minutes"):
            q = (f"from TradeAggregation {WITHIN} per '{per}' "
                 "select symbol, vol, lo, hi, vlo, vhi, n;")
            assert_rows_close(rows_of(port.rt.query(q)),
                              rows_of(ref.rt.query(q)))
        b, rb = port.bank("TradeAggregation"), ref.bank("TradeAggregation")
        assert b._lanes == rb._lanes and len(b._lanes) == 10
        assert (b.scatters, b.flushes) == (rb.scatters, rb.flushes)
    finally:
        ref.close()
        port.close()


# the apps of tests/test_aggregations.py and tests/test_kernels.py, each
# with its own traffic: (app, value draw, select, tolerance)
AGG_BASE = 1_496_289_720_000


def _sends(seed, n, vals, n_syms, sym_fmt="s{}"):
    rng = np.random.default_rng(seed)
    ts = np.sort(AGG_BASE + rng.integers(0, 5_000, n)).astype(np.int64)
    return [[sym_fmt.format(int(rng.integers(0, n_syms))), vals(rng, j),
             int(ts[j])] for j in range(n)]


APPS = {
    "stddev": (
        "{mode}@app:playback define stream S (sym string, price double, "
        "ts long); define aggregation A from S select sym, "
        "stdDev(price) as sd group by sym aggregate by ts every sec...min;",
        lambda rng, j: float(rng.uniform(1, 100)), 8, "sym, sd",
        {"abs_": 5e-3, "rel": 1e-3}),
    "int_min_max_count": (
        "{mode}@app:playback define stream S (sym string, v int, ts long); "
        "define aggregation A from S select sym, min(v) as lo, "
        "max(v) as hi, count() as n group by sym "
        "aggregate by ts every sec...min;",
        lambda rng, j: int(rng.integers(-(2**31), 2**31 - 1)), 6,
        "sym, lo, hi, n", {}),
    "count_only": (
        "{mode}@app:playback define stream S (sym string, v int, ts long); "
        "define aggregation A from S select sym, count() as n "
        "group by sym aggregate by ts every sec...min;",
        lambda rng, j: int(rng.integers(-100, 100)), 8, "sym, n", {}),
    "long_sum": (
        "{mode}@app:playback define stream S (sym string, v int, ts long); "
        "define aggregation A from S select sym, sum(v) as total, "
        "avg(v) as mean group by sym aggregate by ts every sec...min;",
        lambda rng, j: int(rng.integers(-(2**31), -1)), 6,
        "sym, total, mean", {"rel": 1e-6}),
    "long_extrema_2^40": (
        "{mode}@app:playback define stream S (sym string, v long, ts long); "
        "define aggregation A from S select sym, min(v) as lo, "
        "max(v) as hi group by sym aggregate by ts every sec...min;",
        lambda rng, j: int(rng.integers(-(2**40), 2**40)), 6, "sym, lo, hi",
        {}),
    "long_extrema_neg_2^62": (
        "{mode}@app:playback define stream S (sym string, v long, ts long); "
        "define aggregation A from S select sym, min(v) as lo, "
        "max(v) as hi group by sym aggregate by ts every sec...min;",
        lambda rng, j: int(rng.integers(-(2**62), -1)), 6, "sym, lo, hi", {}),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(APPS))
def test_reference_apps_match(name, mode):
    """Row-at-a-time sends, as the reference's own tests send them."""
    app, draw, n_syms, sel, tol = APPS[name]
    sends = _sends(sorted(APPS).index(name) + 3, 300, draw, n_syms)
    runs = both(app.format(mode=MODES[mode]))
    try:
        for run in runs:
            for row in sends:
                run.row("S", row)
        q = (f"from A within {AGG_BASE - 1000}, {AGG_BASE + 100_000} "
             f"per 'seconds' select {sel};")
        want, got = (rows_of(r.rt.query(q)) for r in runs)
        assert_rows_close(got, want, **tol)
        ref, port = runs
        if mode != "host":
            assert ref.bank("A").names == port.bank("A").names
            assert port.bank("A").scatters == ref.bank("A").scatters > 0
            assert port.bank("A").flushes == ref.bank("A").flushes
    finally:
        for r in runs:
            r.close()


def test_filtered_input():
    """tests/test_conformance_aggregation.py:296: only rows passing the
    input filter aggregate."""
    app = ("@app:playback define stream stockStream (symbol string, "
           "price double, quantity int, timestamp long); "
           "define aggregation A from stockStream[price > 15.0] "
           "select symbol, sum(price) as t "
           "group by symbol aggregate by timestamp every sec...min;")
    t = 1_496_289_950_000
    out = []
    for run in both(app):
        for row, ts in ((["IBM", 10.0, 1, t], t), (["IBM", 20.0, 1, t + 100], t + 100),
                        (["IBM", 30.0, 1, t + 200], t + 200)):
            run.row("stockStream", row, ts)
        out.append(rows_of(run.rt.query(
            f"from A within {t - 1000}, {t + 10_000} per 'seconds' "
            "select symbol, t;")))
        run.close()
    assert out[0] == out[1] and [d for _t, d in out[1]] == [["IBM", 50.0]]


@pytest.mark.parametrize("mode", ["host", "tpu"])
def test_out_of_order_events(mode):
    """Late events below the watermark merge into finished buckets on the
    host; in tpu mode their bank lanes land on the dump row."""
    app = (f"{MODES[mode]}@app:playback define stream S (sym string, "
           "v double, ts long); define aggregation A from S select sym, "
           "sum(v) as total, count() as n group by sym "
           "aggregate by ts every sec, min;")
    rng = np.random.default_rng(4)
    ts = BASE + np.arange(400) * 37
    late = rng.random(400) < 0.15
    ts[late] -= rng.integers(2_000, 20_000, late.sum())
    cols = {"sym": np.asarray([f"k{k}" for k in rng.integers(0, 5, 400)],
                              dtype=object),
            "v": rng.integers(1, 50, 400).astype(np.float64),
            "ts": ts.astype(np.int64)}
    got = []
    for run in both(app):
        for lo in range(0, 400, 50):
            run.batch("S", {k: v[lo:lo + 50] for k, v in cols.items()},
                      cols["ts"][lo:lo + 50])
        got.append((find_rows(run.rt, "A", "seconds"),
                    find_rows(run.rt, "A", "minutes")))
        run.close()
    assert got[0] == got[1] and got[1][0]


def test_day_month_rollup():
    app = ("define stream S (v double, ts long); define aggregation A from S "
           "select sum(v) as total aggregate by ts every day, month;")
    jun1, jul1 = 1_496_275_200_000, 1_498_867_200_000
    out = []
    for run in both(app):
        for v, ts in ((1.0, jun1 + 1000), (2.0, jun1 + 86_400_000),
                      (10.0, jul1 + 5)):
            run.row("S", [v, ts])
        out.append([find_rows(run.rt, "A", p) for p in ("days", "months")])
        run.close()
    assert out[0] == out[1]
    assert [d[-1] for _t, d in out[1][1]] == [3.0, 10.0]


def test_purge():
    """tests/test_aggregations.py's @purge app: second buckets past 120 s
    purge, the minute rollup keeps answering."""
    app = ("@app:playback define stream S (sym string, v long); "
           "@purge(enable='true', interval='1 sec', "
           "@retentionPeriod(sec='120 sec', min='1 day')) "
           "define aggregation Agg from S select sym, sum(v) as total "
           "group by sym aggregate every sec...min;")
    out = []
    for run in both(app):
        for row, ts in ((["A", 1], 1_000), (["A", 2], 600_000),
                        (["B", 5], 600_500)):
            run.row("S", row, ts)
        agg = run.rt.aggregations["Agg"]
        out.append((sorted(agg.stores["seconds"].finished, key=repr),
                    find_rows(run.rt, "Agg", "seconds"),
                    rows_of(run.rt.query("from Agg within 0L, 999999999L "
                                         "per 'minutes' select sym, total"))))
        run.close()
    assert out[0] == out[1] and out[1][2]


@pytest.mark.parametrize("mode", ["tpu", "kernel"])
def test_reference_snapshot_restores_into_port(mode):
    """A JAX snapshot taken mid-stream restores into the port; both then
    go on identically."""
    app = DOCS.format(mode=MODES[mode])
    bs = trade_batches(n_batches=6, seed=41)
    ref, port = both(app)
    try:
        for stream, cols, ts in bs[:3]:
            ref.batch(stream, cols, ts)
        state = ref.rt.aggregations["TradeAggregation"].snapshot()
        port.rt.aggregations["TradeAggregation"].restore(state)
        for stream, cols, ts in bs[3:]:
            ref.batch(stream, cols, ts)
            port.batch(stream, cols, ts)
        want, got = pulls(ref), pulls(port)
        for k in want:
            assert_rows_close(got[k], want[k], rel=REL)
        assert (port.rt.aggregations["TradeAggregation"].snapshot()["watermark"]
                == ref.rt.aggregations["TradeAggregation"].snapshot()["watermark"])
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("query", [
    "from Nope within 0L, 1L per 'seconds' select *;",
    "from TradeAggregation within 0L, 1L per 'seconds' "
    "select symbol, sum(total) as s;",
    "from TradeAggregation within 0L, 1L per 'seconds' select symbol, total "
    "group by symbol;",
    "from TradeAggregation within 0L, 1L per 'seconds' select symbol, total "
    "having total > 1.0;",
    "from TradeAggregation within 0L, 1L per 'seconds' select symbol "
    "delete TradeAggregation on symbol == 'x';",
    "select 'x' as symbol insert into TradeAggregation;",
])
def test_refused_on_demand_forms(query):
    port = Run("port", DOCS.format(mode=TPU))
    try:
        with pytest.raises(StoreQueryCreationError, match="later slice|slice of the port"):
            port.rt.query(query)
    finally:
        port.close()


def test_agg_min_batch_annotation():
    bad = ("@app:execution('tpu', agg.device.min.batch='0') " + TRADE)
    with pytest.raises(SiddhiAppCreationError) as e:
        SiddhiManager(device="cpu").create_siddhi_app_runtime(bad)
    from siddhi_tpu.core.exceptions import SiddhiAppCreationError as JaxError
    with pytest.raises(JaxError) as je:
        JaxManager().create_siddhi_app_runtime(bad)
    assert str(e.value) == str(je.value)
    ok = SiddhiManager(device="cpu").create_siddhi_app_runtime(
        "@app:execution('tpu', agg.device.min.batch='64') " + TRADE)
    assert ok.app_context.tpu_agg_min_batch == 64


def test_shutdown_flushes_the_bank():
    port = run_docs(DOCS.format(mode=TPU), "port", trade_batches(n_batches=2))
    before = find_rows(port.rt, "TradeAggregation", "seconds")
    port.rt.shutdown()
    assert port.bank("TradeAggregation")._arrays is None
    assert find_rows(port.rt, "TradeAggregation", "seconds") == before


@pytest.mark.parametrize("min_batch", [None, "8192"])
def test_batch_past_bank_capacity_reduces_on_device(min_batch):
    """A batch with more running buckets than the bank's 4,096 rows takes
    the host path; its float fields reduce with the device scatter
    (``_device_reduce``) unless the batch is below
    ``agg.device.min.batch``."""
    ann = (TPU if min_batch is None else
           f"@app:execution('tpu', agg.device.min.batch='{min_batch}') ")
    app = DOCS.format(mode=ann)
    rng = np.random.default_rng(13)
    bs = []
    for b in range(2):
        sym = rng.permutation(5000)[:4600]
        ts = np.full(4600, BASE + 1500 * b, dtype=np.int64)
        bs.append(("TradeStream", {
            "symbol": np.asarray([f"S{s:04d}" for s in sym], dtype=object),
            "price": rng.uniform(1.0, 500.0, 4600),
            "volume": rng.integers(1, 10_000, 4600).astype(np.int64),
            "timestamp": ts}, ts))
    ref, port = (run_docs(app, pkg, bs) for pkg in ("jax", "port"))
    try:
        assert port.bank("TradeAggregation").scatters == 0
        assert ref.bank("TradeAggregation").scatters == 0
        want, got = pulls(ref), pulls(port)
        for k in ("query_sec", "query_min", "find_sec"):
            assert_rows_close(got[k], want[k], rel=REL)
    finally:
        ref.close()
        port.close()
