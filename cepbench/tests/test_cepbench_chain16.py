"""The ``chain16_1m.capture_free`` cell at a size a test run holds: a
harness run on the CPU, its control, and the roofline's bytes of kernel
1 on hand-made batches."""

import numpy as np
import pytest

import _small  # noqa: F401  (puts the checkout on the path)
from cepbench import control, harness
from cepbench.rooflines import dense_batch as roof

CELL = "chain16_1m.capture_free"
# this cell's small sizes (``_small.SMALL`` holds the cells before it):
# 16 keys, each 16 times a batch, so chains complete within a few
# batches of a short run
SMALL = {"config": {"sizes": {"partitions": 256}},
         "traffic": {"batch": 256, "columns": {"key": {"modulo": 16}}}}


def small_cell():
    return harness.Cell(CELL, overrides=SMALL)


@pytest.mark.parametrize("trace", [False, True])
def test_small_run_is_correct_with_the_result_line_keys(trace):
    cell = small_cell()
    r = harness.run(cell, 2**31 + 3, 1.0, trace, device="cpu")
    assert r.pop("_forbidden") == []
    assert set(r) == {"correct", "attempted", "failed", "metrics", "device",
                      "checks"}
    assert r["correct"], r["checks"]
    assert r["checks"]["rows_compared"]["value"] >= 1
    want = {m["name"] for m in cell.metrics(trace)}
    got = set(r["metrics"])
    # device-trace metrics are read on a card only
    assert got == {m["name"] for m in cell.metrics(trace)
                   if m["source"] != "device_trace"}
    assert got <= want
    if trace:
        assert {"segments_ms.dense_batch",
                "launch_dispatch_ms.dense_batch"} <= got
        # the general step's spans are not this cell's
        assert "step_ms.dense" not in want


def test_control_is_not_correct():
    r = control.readings(small_cell(), 2**31 + 5, 6, "cpu")
    assert not r["correct"], r
    assert r["checks"]["mismatched_rows"] > 0
    assert r["checks"]["rows_compared"] > 0


def test_row_bytes_at_the_cell():
    # 16 nodes x 32 lanes: 64 B of bits, 2,048 of anchors, 4 of overflow
    assert roof.row_bytes(16, 32) == 2116
    # the cell's batch: 131,072 distinct keys, read and written
    keys = np.arange(131072) * 524287 % 1_000_000
    assert roof.batch_bytes(keys, 16, 32) == (2 * 131072 * 2116
                                              + 12 * 131072)


def test_batch_bytes_count_each_distinct_key_once():
    keys = np.array([5, 9, 5, 5, 2, 9])
    assert roof.batch_bytes(keys, 2, 8) == 2 * 3 * (2 + 64 + 4) + 12 * 6
    assert roof.batch_bytes(np.array([], dtype=np.int64), 2, 8) == 0


class _Traffic:
    def __init__(self, batches):
        self.batches = batches

    def batch(self, i):
        return {"key": np.asarray(self.batches[i])}, None


def test_window_bytes_regenerate_the_sub_window():
    tr = _Traffic([[1, 2], [3, 3, 3], [4], [5, 6, 7]])
    ctx = {"profile": {"first_batch": 1, "next_batch": 3},
           "config": {"key": "key", "sizes": {"states": 1, "lanes": 8}},
           "traffic": tr}
    per_row = 2 * (1 + 32 + 4)
    assert roof.window_bytes(ctx) == (per_row + 36) + (per_row + 12)


def test_roofline_reads_kernel_time_by_name():
    ms = harness.load_module("metrics", "kernel_ms.dense_batch")
    share = harness.load_module("metrics", "roofline.dense_batch")
    tr = _Traffic([[1, 2, 3, 4]] * 4)
    ctx = {"config": {"key": "key", "sizes": {"states": 16, "lanes": 32}},
           "traffic": tr,
           "profile": {"batches": 2, "first_batch": 2, "next_batch": 4,
                       "by_name": {"dense_batch_kernel(Plan const*)":
                                   (2e-6, 2), "Memcpy HtoD": (1.0, 4)}}}
    assert ms.read(ctx) == pytest.approx(1e-3)
    want = 2 * (2 * 4 * 2116 + 12 * 4) / roof.PEAK_BYTES_S / 2e-6
    assert share.read(ctx) == pytest.approx(100 * want)
    # where the kernel did not run (or no trace), neither reads
    ctx["profile"]["by_name"] = {"Memcpy HtoD": (1.0, 4)}
    assert ms.read(ctx) is None and share.read(ctx) is None
    assert ms.read({"profile": None}) is None
