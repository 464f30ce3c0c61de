"""The traffic generator: deterministic in its seed, distinct where a
mix says so, in the ranges and types the mixes state."""

import numpy as np
import pytest

from _small import ROOT
from cepbench.generator import Traffic
from cepbench.harness import load_json as load_mix

MIXES = ["txn_stride", "txn_hot100k"]
# the kinds no mix of the benchmark uses yet, as a later mix would
SYMBOLS = {"stream": "S", "batch": 512, "warmup_batches": 3,
           "time": {"start_ms": 1000, "events_per_ms": 8},
           "columns": [{"name": "symbol", "kind": "symbol", "prefix": "S",
                        "n": 1200, "cover_warmup": True},
                       {"name": "timestamp", "kind": "event_time"}]}


def mix(name, small=True):
    spec = load_mix(ROOT / "cepbench" / "traffic" / f"{name}.json")
    if small and spec["batch"] > 8192:
        from cepbench.generator import merge
        spec = merge(spec, {"batch": 4096})
    return spec


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_batches(name):
    a, b = Traffic(mix(name), 2**31 + 11), Traffic(mix(name), 2**31 + 11)
    for i in (0, 3, 17):
        ca, ta = a.batch(i)
        cb, tb = b.batch(i)
        assert np.array_equal(ta, tb)
        for k in ca:
            assert np.array_equal(ca[k], cb[k]), k


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_batches(name):
    ca, _ = Traffic(mix(name), 5).batch(4)
    cb, _ = Traffic(mix(name), 6).batch(4)
    assert any(not np.array_equal(ca[k], cb[k]) for k in ca)


@pytest.mark.parametrize("name", MIXES)
def test_batches_own_their_time_span(name):
    t = Traffic(mix(name), 9)
    for i in (0, 1, 25):
        _c, ts = t.batch(i)
        assert (t.batch_of_ts(ts) == i).all()


def test_stride_keys_distinct_within_a_batch():
    t = Traffic(mix("txn_stride", small=False), 2**31 + 3)
    for i in (0, 2, 9):
        assert len(np.unique(t.batch(i)[0]["key"])) == t.B


@pytest.mark.parametrize("name", ["txn_stride", "txn_hot100k"])
def test_values_are_float32_in_range(name):
    t = Traffic(mix(name), 2**31 + 3)
    v = t.batch(2)[0]["v"]
    assert v.dtype == np.float32
    assert v.min() >= 0.0 and v.max() < 20.0
    assert len(np.unique(v)) > 0.9 * t.B


def test_hot_keys_cover_their_range():
    t = Traffic(mix("txn_hot100k", small=False), 2**31 + 4)
    k = t.batch(1)[0]["key"]
    assert k.min() >= 0 and k.max() < 100_000
    assert t.key_space("key") == 100_000
    assert len(np.unique(k)) < t.B  # keys repeat: collision rounds


def test_cover_warmup_touches_every_symbol():
    t = Traffic(SYMBOLS, 21)
    seen = set()
    for i in range(t.warmup):
        seen.update(t.batch(i)[0]["symbol"].tolist())
    assert len(seen) == 1200


def test_symbols_and_event_times_follow_the_seed():
    a, b = Traffic(SYMBOLS, 2**31 + 1), Traffic(SYMBOLS, 2**31 + 1)
    ca, ta, ea = a.batch(5, extras=True)
    cb, tb, _eb = b.batch(5, extras=True)
    assert (ca["symbol"] == cb["symbol"]).all() and (ta == tb).all()
    assert (ca["timestamp"] == ta).all()
    assert (a.batch_of_ts(ta) == 5).all()
    assert (a.symbols("symbol")[ea["ids"]["symbol"]] == ca["symbol"]).all()
