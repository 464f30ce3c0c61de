"""The trace reduction: busy time as a union, idle gaps labelled by what
the host was doing, the marker tying the clocks."""

import pytest

import _small  # noqa: F401  (puts the checkout on the path)
from cepbench import devtrace


def test_union_merges_overlaps():
    assert devtrace.union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]


def test_reduce_shifts_clocks_and_labels_gaps():
    # device clock 100 s = host clock 1 s (the marker first)
    ev = [("marker", 100.0, 100.00001), ("k", 100.002, 100.003),
          ("k", 100.0025, 100.004), ("k", 100.05, 100.06)]
    spans = [("send", 1.0, 1.02), ("ingest", 1.001, 1.005),
             ("step", 1.004, 1.05), ("emit", 1.02, 1.03)]
    r = devtrace.reduce(ev, 1.0, 1.07, spans)
    assert r["busy_s"] == pytest.approx(0.012)
    assert r["window_s"] == pytest.approx(0.07)
    assert r["n_events"] == 3
    labels = [g[0] for g in r["idle_gaps"]]
    lengths = [g[1] for g in r["idle_gaps"]]
    assert lengths == sorted(lengths, reverse=True)
    # 4 ms to 50 ms: send till 20, emit till 30, then the client
    assert labels[0] == "client" and lengths[0] == pytest.approx(0.046)
    assert set(labels) <= {"client", "send", "ingest", "emit"}
    assert r["by_name"]["k"][1] == 3


def test_no_device_activity_reads_nothing():
    assert devtrace.reduce([("marker", 0.0, 0.001)], 0.0, 1.0, []) is None
