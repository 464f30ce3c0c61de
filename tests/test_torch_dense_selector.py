"""Dense patterns under the host selector and rate limiters, held against
the JAX package's dense path on the CPU.

- The aggregating-selector form: the dense engine emits the raw
  captures and the host ``QuerySelector`` aggregates the match rows;
  partitioned, ONE shared selector keeps per-key state through the
  match rows' partition-key side channel (sums per key, never pooled),
  timer-fired alerts of absent patterns included (the reverse row ->
  key map), and ``@purge`` drops a purged key's selector state.
- Output rate limits on unpartitioned dense queries: the time ones fire
  from the app scheduler through ``_RateLimiterTask``, which drains the
  emit queue first; with ``emit.depth`` above 1 the deferred match
  batches replay the clock of their processing (``emit_now``).
- What stays refused, with the reference's reason and the
  ``ROADMAP.md`` item.

Outputs must be equal in order, with timestamps, floats bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError

TXN = "define stream Txn (card long, amount double); "
TICK = "define stream Tick (x int); "


def key(e):
    return (e.timestamp, e.is_expired,
            tuple(v.hex() if isinstance(v, float) else v for v in e.data))


def run(port, app, sends, out="Alerts", query=None, after=None):
    mgr = SiddhiManager(device="cpu") if port else JaxManager()
    try:
        rt = mgr.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback(out, lambda evs: got.extend(key(e) for e in evs))
        qgot = []
        if query is not None:
            rt.add_callback(query, lambda ts, i, o: qgot.append(
                (ts, [key(e) for e in i or []])))
        rt.start()
        for stream, row, ts in sends:
            rt.get_input_handler(stream).send(list(row), timestamp=ts)
        extra = after(rt) if after is not None else None
        low = rt.lowering()
        rt.shutdown()
        return got, qgot, low, extra
    finally:
        mgr.shutdown()


def assert_same(app, sends, **kw):
    jgot, jq, jlow, _ = run(False, app, sends, **kw)
    tgot, tq, tlow, extra = run(True, app, sends, **kw)
    assert (tgot, tq) == (jgot, jq)
    assert set(jlow.values()) == {"dense"} and tlow == jlow
    return tgot, extra


def txn(seed, n=200, cards=8, step=(1, 60)):
    """Seeded ``Txn`` events: cards uniform, amounts ~ lognormal(4, 1)
    rounded to cents."""
    rng = np.random.default_rng(seed)
    out, t = [], 1000
    for _ in range(n):
        t += int(rng.integers(*step))
        out.append(("Txn", [int(rng.integers(0, cards)),
                            float(np.round(rng.lognormal(4.0, 1.0), 2))], t))
    return out


PB = "@app:playback "


def tpu(p=16, extra=""):
    return f"@app:execution('tpu', partitions='{p}'{extra}) "


def test_unpartitioned_group_by_sum():
    """``tests/test_dense_integration.py``'s unpartitioned form."""
    app = (PB + tpu() + TXN + "@info(name='q') from every a=Txn[amount > "
           "100.0] -> b=Txn[amount > a.amount] within 10 min "
           "select a.amount as base, sum(b.amount) as total "
           "group by a.amount insert into Alerts;")
    sends = [("Txn", [1, 150.0], 1000), ("Txn", [1, 200.0], 2000),
             ("Txn", [1, 300.0], 3000), ("Txn", [1, 120.0], 3500),
             ("Txn", [1, 400.0], 4000)]
    got, _ = assert_same(app, sends)
    assert len(got) == 4


def test_partitioned_sums_stay_per_key():
    """``tests/test_dense_integration.py``'s partitioned form: per-key
    sums, never pooled."""
    app = (PB + tpu(64) + "define stream Txn (card string, amount double); "
           "partition with (card of Txn) begin @info(name='q') "
           "from every a=Txn[amount > 100.0] -> b=Txn[amount > a.amount] "
           "within 10 min select sum(b.amount) as t insert into Alerts; "
           "end;")
    sends = [("Txn", ["c1", 150.0], 1000), ("Txn", ["c2", 500.0], 1100),
             ("Txn", ["c1", 200.0], 2000), ("Txn", ["c2", 600.0], 2100)]
    got, _ = assert_same(app, sends)
    assert [d for _t, _x, d in got] == [((200.0).hex(),), ((600.0).hex(),)]


FRAUD_ROLLUP = (
    "partition with (card of Txn) begin @info(name='fraud') "
    "from every a=Txn[amount > 100.0] -> b=Txn[amount > a.amount]<3:5> "
    "within 10 min select a.card as card, count() as alerts, "
    "max(a.amount) as top, sum(b[last].amount) as spent "
    "having alerts >= 2 insert into Alerts; end;")


@pytest.mark.parametrize("selector", [
    FRAUD_ROLLUP,
    FRAUD_ROLLUP.replace("having alerts >= 2 ", "group by a.card "),
    FRAUD_ROLLUP.replace("count() as alerts", "avg(b[0].amount) as alerts")
    .replace("having alerts >= 2", "having alerts > 150.0"),
    FRAUD_ROLLUP.replace("max(a.amount)", "stdDev(a.amount)")
    .replace("sum(b[last].amount)", "minForever(b[last].amount)"),
], ids=["fraud_rollup", "group_by", "avg_having", "stddev_forever"])
def test_partitioned_aggregating_selector(selector):
    """BASELINE config 2's fraud pattern under a per-card aggregating
    selector (the card's ``fraud_rollup`` cell at a small size): count,
    max and sum per card, having; and other aggregators."""
    app = PB + tpu(16) + TXN + selector
    got, _ = assert_same(app, txn(7, n=400))
    assert got


def test_unpartitioned_aggregating_with_order_by_limit():
    """Unpartitioned, the aggregating selector's order by and limit run
    as the reference's (one chunk is one key's)."""
    app = (PB + tpu() + TXN + "@info(name='q') from every a=Txn[amount > "
           "60.0] -> b=Txn[amount > a.amount] select a.card as card, "
           "sum(b.amount) as s group by a.card order by s desc limit 2 "
           "insert into Alerts;")
    got, _ = assert_same(app, txn(11, cards=4))
    assert got


@pytest.mark.parametrize("rate", [
    "output every 3 events", "output first every 4 events",
    "output last every 3 events", "output all every 1 sec",
    "output first every 1 sec", "output last every 1 sec",
    "output snapshot every 1 sec",
])
def test_rate_limit_on_unpartitioned_dense(rate):
    """Every rate limiter on an unpartitioned dense pattern; the time
    ones fire from the scheduler (the ticks after the last match)."""
    app = (PB + tpu() + TXN + TICK + "@info(name='q') from every "
           "a=Txn[amount > 80.0] -> b=Txn[amount > a.amount] "
           f"select a.amount as base, b.amount as top {rate} "
           "insert into Alerts;")
    sends = txn(len(rate), n=120, step=(10, 120))
    sends += [("Tick", [0], sends[-1][2] + 1500 * i) for i in (1, 2, 3)]
    got, _ = assert_same(app, sends, query="q")
    assert got


def test_group_by_selector_with_output_all_every_2_events():
    app = (PB + tpu() + TXN + "@info(name='q') from every a=Txn[amount > "
           "80.0] -> b=Txn[amount > a.amount] select a.card as card, "
           "count() as n group by a.card output all every 2 events "
           "insert into Alerts;")
    got, _ = assert_same(app, txn(3, n=150, cards=3))
    assert got


@pytest.mark.parametrize("depth", ["emit.depth='4'", "ingest.depth='3', "
                                   "emit.depth='2'"])
def test_time_rate_limit_replays_the_processing_clock(depth):
    """Deferred match batches (emit and ingest depths above 1) feed the
    time rate limiter the ``now`` sampled when their batch was
    processed, and the limiter's task drains the queue first."""
    app = (PB + tpu(1, ", " + depth) + TXN + TICK + "@info(name='q') "
           "from every a=Txn[amount > 80.0] -> b=Txn[amount > a.amount] "
           "select a.amount as base, b.amount as top output last every "
           "500 millisec insert into Alerts;")
    sends = txn(21, n=150, step=(20, 200))
    sends += [("Tick", [0], sends[-1][2] + 700 * i) for i in (1, 2)]
    got, _ = assert_same(app, sends)
    assert got


ABSENT = (
    "define stream Stream1 (symbol string, price float, volume int); "
    "define stream Stream2 (symbol string, price float, volume int); ")


def test_timer_fired_alerts_reach_the_per_key_selector():
    """``TestPartitionedAggregatingAbsent``'s shape: an absent pattern
    under a partitioned ``count()`` selector; the alerts the deadline
    timer fires carry their keys through the reverse row -> key map."""
    app = (PB + tpu(16) + ABSENT + "partition with (symbol of Stream1, "
           "symbol of Stream2) begin @info(name='q') from every "
           "e1=Stream1[price > 20.0] -> not Stream2[price > e1.price] for "
           "1 sec select e1.volume as s, count() as n, sum(e1.price) as t "
           "insert into OutputStream; end;")
    rng = np.random.default_rng(5)
    sends, t = [], 1000
    for _ in range(120):
        t += int(rng.integers(1, 250))
        k = int(rng.integers(0, 4))
        sends.append((("Stream1", "Stream2")[int(rng.random() < 0.4)],
                      ["ABCD"[k], float(np.float32(rng.uniform(0, 60))), k],
                      t))
    sends.append(("Stream1", ["Z", 1.0, 9], t + 5000))
    got, _ = assert_same(app, sends, out="OutputStream")
    counts = {}
    for _ts, _x, (s, n, _t) in got:
        assert n == counts.get(s, 0) + 1  # per key, never pooled
        counts[s] = n
    assert len(counts) > 1


def test_purge_drops_the_selector_state_of_a_key():
    """``@purge`` on a partitioned aggregating query: a purged key's
    count restarts, and its recycled row's new key starts at one (the
    reverse row -> key map of timer-free rows as well)."""
    app = (PB + tpu(4) + TXN + TICK + "@purge(enable='true', "
           "interval='1 sec', idle.period='2 sec') partition with (card of "
           "Txn) begin @info(name='q') from every a=Txn[amount > 10.0] -> "
           "b=Txn[amount > a.amount] select a.card as card, count() as n "
           "insert into Alerts; end;")
    sends = []
    for phase, cards in ((0, (1, 2)), (1, (1, 3, 4)), (2, (2, 5))):
        base = 1000 + phase * 10_000
        for i in range(12):
            sends.append(("Txn", [cards[i % len(cards)],
                                  20.0 + (i * 7) % 13], base + 100 * i))

    def keys(rt):
        proc = rt.pattern_runtimes()["q"]
        return (dict(proc._key_rows), list(proc._free_rows))

    jgot, _, _, _ = run(False, app, sends)
    tgot, _, _, (key_rows, free) = run(True, app, sends, after=keys)
    assert tgot == jgot
    # card 2 was purged after phase 0: its count restarts in phase 2
    twos = [n for _t, _x, (c, n) in tgot if c == 2]
    assert twos and 1 in twos[1:]
    assert set(key_rows) == {2, 5}


@pytest.mark.parametrize("app,reason,item", [
    (tpu(16) + TXN + "partition with (card of Txn) begin @info(name='q') "
     "from every a=Txn[amount > 1.0] -> b=Txn[amount > a.amount] "
     "select a.amount as x output last every 3 events insert into Alerts; "
     "end;", "partitioned queries with output rate limits", 7),
    (tpu(16) + TXN + "partition with (card of Txn) begin @info(name='q') "
     "from every a=Txn[amount > 1.0] -> b=Txn[amount > a.amount] "
     "select a.card as c, count() as n order by n limit 2 "
     "insert into Alerts; end;",
     "partitioned aggregating selectors with order by/limit", 7),
    # a single-stream query the reference's device query path takes,
    # but not in a partition: a tumbling window there goes to per-key
    # host instances
    (tpu(16) + TXN + "partition with (card of Txn) begin @info(name='q') "
     "from Txn#window.lengthBatch(3) select sum(amount) as s "
     "insert into Alerts; end;", "partitioned tumbling windows", 7),
    (tpu(16) + TXN + "@info(name='q') from every a=Txn[amount > 1.0] -> "
     "b=Txn[amount > a.amount] select a.amount * 2 as x insert into Alerts;",
     "select items must be event references", 7),
], ids=["partitioned_rate_limit", "partitioned_order_by",
        "tpu_single_stream", "select_expression"])
def test_refusals(app, reason, item):
    """What stays refused: where the reference uses per-key host
    instances or its host pattern engine, the port raises with the
    reference's reason and the ``ROADMAP.md`` item."""
    with pytest.raises(SiddhiAppCreationError) as info:
        SiddhiManager(device="cpu").create_siddhi_app_runtime(app)
    assert reason in str(info.value)
    assert f"ROADMAP.md §1 item {item}" in str(info.value)
