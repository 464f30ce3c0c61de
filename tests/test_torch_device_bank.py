"""The port's ``DeviceBucketBank`` against the JAX package's.

Both banks get the same fields, the same seeded batches and the same
barrier logic (the runtime's ``_bank_ingest``: flush on count or LONG
overflow risk, flush and retry when the rows run out, host path when a
batch alone is too hot), with ``cap=16`` so that capacity barriers
fire.  The JAX bank runs both of its formulations: XLA's scatter
(``use_kernel=False``) and the Pallas kernel in interpret mode
(``use_kernel=True``); the port has one, on the CPU here.

Every lane kind rides: FLOAT/DOUBLE sum, min and max (float32 rows), the
count row, the LONG-sum hi/lo pair, the LONG-extrema lexicographic pair
(±2^40 values, and negative-heavy ±2^62 values) and INT extrema.

Tolerances, the reference's contract: every field is exact (Python ints
equal, float32 values equal as floats) except the one DOUBLE sum over
non-integer values, held per row to ``n * 2^-24 * sum|v|`` over the
events it absorbed since the last flush.  The overflow-risk answers and
the ``scatters``/``flushes`` counts must be equal.
"""

import numpy as np
import pytest
import torch

from siddhi_tpu.aggregation.device_bank import DeviceBucketBank as JaxBank
from siddhi_tpu.aggregation.runtime import BaseField as JaxField
from siddhi_tpu.query_api import AttrType as JaxType
from siddhi_tpu_torch.aggregation.device_bank import (
    COUNT_EXACT_MAX,
    DeviceBucketBank,
)
from siddhi_tpu_torch.aggregation.runtime import BaseField
from siddhi_tpu_torch.query_api import AttrType

# (name, op, type): every lane kind of the bank
FIELDS = [
    ("_SUM0", "sum", "DOUBLE"),     # float32 row, quarter-integer values
    ("_SUM1", "sum", "DOUBLE"),     # float32 row, non-integer values
    ("_MIN2", "min", "DOUBLE"),
    ("_MAX3", "max", "FLOAT"),
    ("_COUNT4", "count", "LONG"),   # float32 add row
    ("_SUM5", "sum", "LONG"),       # hi/lo int32 sum pair
    ("_MIN6", "min", "LONG"),       # lexicographic extrema pair
    ("_MAX7", "max", "LONG"),
    ("_MIN8", "min", "INT"),        # native int32 row
    ("_MAX9", "max", "INT"),
]
TOLERANT = "_SUM1"
CAP = 16


def fields(Field, Type):
    return [Field(n, op, None, getattr(Type, t)) for n, op, t in FIELDS]


def batches(seed, long_range, n_batches=14):
    """Seeded batches of (keys per event, {field: values}); buckets move
    on every other batch over 8 symbols, so a cap of 16 rows
    overflows when a bucket turns.  LONG extrema draw from ``long_range``."""
    rng = np.random.default_rng(seed)
    lo, hi = long_range
    out = []
    for b in range(n_batches):
        n = int(rng.integers(20, 90))
        sym = rng.integers(0, 8, n)
        bucket = (b // 2) * 1000 + 1000 * (rng.random(n) < 0.2)
        keys = [(int(t), (f"S{s}",)) for t, s in zip(bucket, sym)]
        v = {
            "_SUM0": rng.integers(-400, 400, n) / 4.0,
            "_SUM1": rng.uniform(-1.0, 1.0, n),
            "_MIN2": rng.uniform(-1e3, 1e3, n),
            "_MAX3": rng.uniform(-1e3, 1e3, n).astype(np.float32),
            "_COUNT4": np.ones(n, dtype=np.int64),
            # one batch fits the sum pair lanes, two may not
            "_SUM5": rng.integers(-(2**40), 2**40, n, dtype=np.int64),
            "_MIN6": rng.integers(lo, hi, n, dtype=np.int64),
            "_MAX7": rng.integers(lo, hi, n, dtype=np.int64),
            "_MIN8": rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32),
            "_MAX9": rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32),
        }
        out.append((keys, v))
    return out


class Drive:
    """One bank under the runtime's barrier logic; records every flush
    and every risk answer, and what each flushed row absorbed."""

    def __init__(self, bank):
        self.bank = bank
        self.flushed = []
        self.risks = []
        self.absorbed = {}  # key -> [events, sum|v|] of TOLERANT

    def flush(self):
        self.flushed.append((self.bank.flush(), self.absorbed))
        self.absorbed = {}

    def ingest(self, keys, fvals):
        bank, n = self.bank, len(keys)
        risks = [bank.count_overflow_risk(n), bank.long_overflow_risk(fvals, n)]
        self.risks.append(risks)
        if risks[0]:
            self.flush()
        if risks[1]:
            self.flush()
            hot = bank.long_overflow_risk(fvals, n)
            self.risks.append([hot])
            if hot:
                return
        uniq = list(dict.fromkeys(keys))
        if not bank.assign(uniq):
            self.flush()
            if not bank.assign(uniq):
                return
        for k, x in zip(keys, fvals[TOLERANT]):
            a = self.absorbed.setdefault(k, [0, 0.0])
            a[0] += 1
            a[1] += abs(float(x))
        rows = np.asarray([bank.rows[k] for k in keys], dtype=np.int32)
        bank.scatter(rows, fvals)


def assert_flushes_agree(port, ref):
    assert len(port.flushed) == len(ref.flushed)
    for (got, absorbed), (want, _) in zip(port.flushed, ref.flushed):
        assert list(got) == list(want)  # same rows, same order
        for key in want:
            for name, _op, _t in FIELDS:
                g, w = got[key][name], want[key][name]
                assert type(g) is type(w), (key, name, g, w)
                if name == TOLERANT:
                    n, s = absorbed[key]
                    assert abs(g - w) <= n * 2.0**-24 * s, (key, g, w)
                else:
                    assert g == w, (key, name, g, w)


RANGES = {"2^40": (-(2**40), 2**40), "neg_2^62": (-(2**62), -1)}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("long_range", sorted(RANGES))
def test_bank_matches_reference_bank(use_kernel, long_range):
    ref = Drive(JaxBank(fields(JaxField, JaxType), cap=CAP,
                        use_kernel=use_kernel))
    port = Drive(DeviceBucketBank(fields(BaseField, AttrType), cap=CAP,
                                  device="cpu"))
    assert port.bank._lanes == ref.bank._lanes
    assert port.bank.long_names == ref.bank.long_names == ["_SUM5"]
    for keys, fvals in batches(7, RANGES[long_range]):
        ref.ingest(keys, fvals)
        port.ingest(keys, fvals)
        assert port.risks == ref.risks
        assert port.bank.rows == ref.bank.rows
        assert port.bank.events_since_flush == ref.bank.events_since_flush
    ref.flush()
    port.flush()
    assert_flushes_agree(port, ref)
    assert port.bank.scatters == ref.bank.scatters > 0
    assert port.bank.flushes == ref.bank.flushes > 2
    # one packed put per scatter
    assert port.bank.ingest.device_puts == port.bank.scatters


def test_count_overflow_barrier_fires_at_the_same_batch():
    f = [("_COUNT0", "count", "LONG")]
    ref = JaxBank([JaxField(n, o, None, JaxType.LONG) for n, o, _ in f])
    port = DeviceBucketBank([BaseField(n, o, None, AttrType.LONG)
                             for n, o, _ in f], device="cpu")
    for bank in (ref, port):
        bank.events_since_flush = COUNT_EXACT_MAX - 10
    for n in (1, 9, 10, 11, 5000):
        assert port.count_overflow_risk(n) == ref.count_overflow_risk(n)
    assert not port.count_overflow_risk(10) and port.count_overflow_risk(11)


@pytest.mark.parametrize("n,values", [
    (32768, [10_000]),             # the wide cell's batch: fits alone
    (32769, [10_000]),             # one more event: the lo lane could wrap
    (8, [2**40, -(2**40)]),
    (1, [2**62, -(2**63)]),        # one batch alone too hot
])
def test_long_overflow_answers_match(n, values):
    ref = JaxBank([JaxField("_SUM0", "sum", None, JaxType.LONG)])
    port = DeviceBucketBank([BaseField("_SUM0", "sum", None, AttrType.LONG)],
                            device="cpu")
    v = np.resize(np.asarray(values, dtype=np.int64), n)
    assert (port.long_overflow_risk({"_SUM0": v}, n)
            == ref.long_overflow_risk({"_SUM0": v}, n))


def test_load_lanes_from_reference_then_continue():
    """A JAX bank's rows and lanes move into the port's bank without a
    flush; both then go on identically."""
    bs = batches(3, RANGES["2^40"], n_batches=10)
    ref = Drive(JaxBank(fields(JaxField, JaxType), cap=CAP))
    # stop at the first batch the bank keeps rows after
    for i, (keys, fvals) in enumerate(bs):
        ref.ingest(keys, fvals)
        if ref.bank.rows:
            break
    assert ref.bank.rows and i < 3
    port = Drive(DeviceBucketBank(fields(BaseField, AttrType), cap=CAP,
                                  device="cpu"))
    port.bank.load_lanes(ref.bank.rows, [np.asarray(a) for a in ref.bank._arrays],
                         ref.bank.events_since_flush, ref.bank._long_hi_used)
    port.absorbed = {k: list(v) for k, v in ref.absorbed.items()}
    ref.flushed.clear()
    for keys, fvals in bs[i + 1:]:
        ref.ingest(keys, fvals)
        port.ingest(keys, fvals)
        assert port.risks == ref.risks[-len(port.risks):]
    ref.flush()
    port.flush()
    assert_flushes_agree(port, ref)


def test_lanes_to_numpy_round_trip():
    bank = DeviceBucketBank(fields(BaseField, AttrType), cap=CAP, device="cpu")
    assert bank.lanes_to_numpy() is None
    d = Drive(bank)
    for keys, fvals in batches(5, RANGES["neg_2^62"], n_batches=2):
        d.ingest(keys, fvals)
    lanes = bank.lanes_to_numpy()
    assert [a.dtype for a in lanes] == [
        np.int32 if kind == "i32" else np.float32 for _op, kind in bank._lanes]
    twin = DeviceBucketBank(fields(BaseField, AttrType), cap=CAP, device="cpu")
    twin.load_lanes(bank.rows, lanes, bank.events_since_flush,
                    bank._long_hi_used)
    assert twin._free == bank._free
    assert all(torch.equal(a, b) for a, b in zip(twin._arrays, bank._arrays))
    assert twin.flush() == bank.flush()


def test_load_lanes_refuses_wrong_shapes():
    bank = DeviceBucketBank(fields(BaseField, AttrType), cap=CAP, device="cpu")
    with pytest.raises(ValueError):
        bank.load_lanes({}, [np.zeros(CAP)] * len(bank._lanes))
