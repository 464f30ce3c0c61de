"""The port's segmented reduce against the JAX package's.

The JAX package's ``kernels/bank_scatter.segmented_reduce`` runs its
Pallas kernel in interpret mode on the CPU (a few shapes: it is slow),
and its bank's other formulation is XLA's ``.at[rows].add/min/max``
scatter; the port's ``segmented_reduce`` on a CPU tensor runs the
kernel's plain torch version.  All get the same inputs, made from one
numpy seed and padded as the bank pads them (events past ``n`` on the
dump row, carrying the op's identity).

Tolerances, the reference's contract (``bank_scatter.py:11-16``):

- int32 lanes (sum, min, max), float32 min/max and count lanes, and
  float32 sums of integer values below 2^24: bit-exact (NaN compared as
  NaN);
- other float32 sums: per row of ``n`` events, ``|got - want| <=
  n * 2^-24 * sum|v|`` (the two may associate differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siddhi_tpu.kernels import bank_scatter as jax_bank_scatter
from siddhi_tpu_torch.kernels import bank_scatter

I32 = np.iinfo(np.int32)
IDENT = {"float32": {"sum": 0.0, "count": 0.0, "min": np.inf, "max": -np.inf},
         "int32": {"sum": 0, "count": 0, "min": int(I32.max),
                   "max": int(I32.min)}}
OPS = ("sum", "count", "min", "max")


def padded(rows, vals, n_pad, dump, op, dtype):
    """Pad ``(rows, vals)`` to ``n_pad`` events on ``dump`` with identities."""
    n = len(rows)
    r = np.full(n_pad, dump, dtype=np.int32)
    r[:n] = rows
    v = np.full(n_pad, IDENT[dtype][op], dtype=dtype)
    v[:n] = vals
    return r, v


def port(rows, vals, r_pad, op, dtype):
    out = bank_scatter.segmented_reduce(
        torch.from_numpy(rows), torch.from_numpy(vals), r_pad, op,
        IDENT[dtype][op])
    assert out.dtype == torch.from_numpy(vals).dtype and out.shape == (r_pad,)
    return out.numpy()


def pallas(rows, vals, r_pad, op, dtype):
    return np.asarray(jax_bank_scatter.segmented_reduce(
        jnp.asarray(rows), jnp.asarray(vals), r_pad, op, IDENT[dtype][op],
        True))


def xla(rows, vals, r_pad, op, dtype):
    a = jnp.full(r_pad, IDENT[dtype][op], dtype=dtype)
    at = a.at[jnp.asarray(rows)]
    v = jnp.asarray(vals)
    out = at.add(v) if op in ("sum", "count") else (
        at.min(v) if op == "min" else at.max(v))
    return np.asarray(out)


def exact_contract(op, dtype, vals) -> bool:
    finite = vals[np.isfinite(vals)] if dtype == "float32" else vals
    integral = (dtype == "int32"
                or (np.all(finite == np.round(finite))
                    and np.abs(finite).sum() < 2**24))
    return op in ("min", "max") or integral


def assert_agrees(got, want, rows, vals, r_pad, op, dtype):
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact_contract(op, dtype, vals):
        if dtype == "float32":
            nan = np.isnan(want)
            assert np.array_equal(np.isnan(got), nan)
            assert np.array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))
        else:
            assert np.array_equal(got, want)
        return
    n_r = np.bincount(rows, minlength=r_pad)
    abs_r = np.bincount(rows, weights=np.abs(vals.astype(np.float64)),
                        minlength=r_pad)
    bound = n_r * 2.0**-24 * abs_r
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert np.all(err <= bound), float((err - bound).max())


def random_case(n_pad, r_pad, op, dtype, seed):
    """Skewed rows over ``r_pad - 1`` rows (the last is the dump row),
    a ragged real length, values of the lane's kind."""
    rng = np.random.default_rng(seed)
    n = int(n_pad - rng.integers(0, n_pad // 4))
    rows = ((rng.zipf(1.3, n) - 1) % (r_pad - 1)).astype(np.int32)
    if op == "count":
        vals = np.ones(n)
    elif dtype == "float32":
        vals = rng.uniform(-500.0, 500.0, n)
    elif op == "sum":
        vals = rng.integers(-(1 << 20), 1 << 20, n)
    else:
        vals = rng.integers(I32.min, I32.max, n, endpoint=True)
    return padded(rows, vals.astype(dtype), n_pad, r_pad - 1, op, dtype)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n_pad,r_pad", [(256, 256), (1024, 256),
                                         (256, 4352), (1024, 4352)])
def test_plain_matches_pallas_and_xla(n_pad, r_pad, op, dtype):
    rows, vals = random_case(n_pad, r_pad, op, dtype, seed=n_pad + r_pad)
    got = port(rows, vals, r_pad, op, dtype)
    assert_agrees(got, pallas(rows, vals, r_pad, op, dtype), rows, vals,
                  r_pad, op, dtype)
    assert_agrees(got, xla(rows, vals, r_pad, op, dtype), rows, vals, r_pad,
                  op, dtype)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("op", OPS)
def test_all_events_on_row_zero(op, dtype):
    """bench.py:1189's worst case: every event on one row."""
    rng = np.random.default_rng(5)
    n_pad, r_pad = 1024, 4352
    vals = (np.ones(n_pad) if op == "count"
            else rng.integers(0, 100, n_pad)).astype(dtype)
    rows = np.zeros(n_pad, dtype=np.int32)
    got = port(rows, vals, r_pad, op, dtype)
    assert_agrees(got, pallas(rows, vals, r_pad, op, dtype), rows, vals,
                  r_pad, op, dtype)
    assert_agrees(got, xla(rows, vals, r_pad, op, dtype), rows, vals, r_pad,
                  op, dtype)


@pytest.mark.parametrize("op", OPS)
def test_float_sums_of_integers_are_exact(op):
    """Integer-valued float32 lanes below 2^24 (counts, small sums) are
    held bit-exact, whatever the association."""
    rng = np.random.default_rng(8)
    rows = rng.integers(0, 40, 900).astype(np.int32)
    vals = (np.ones(900) if op == "count" else rng.integers(-2000, 2000, 900)
            ).astype(np.float32)
    rows, vals = padded(rows, vals, 1024, 255, op, "float32")
    want = xla(rows, vals, 256, op, "float32")
    got = port(rows, vals, 256, op, "float32")
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("op", OPS)
def test_dump_row_absorbs_padding_and_late_events(op, dtype):
    """The bank sends padding (identities) and out-of-order events (real
    values) to its dump row; every other row is untouched by them."""
    rng = np.random.default_rng(12)
    dump = 16  # the bank's cap; r_pad = pad_rows(cap + 1) = 256
    rows = rng.integers(0, dump, 300).astype(np.int32)
    rows[rng.random(300) < 0.3] = dump
    vals = (np.ones(300) if op == "count"
            else rng.integers(-50, 50, 300)).astype(dtype)
    rows, vals = padded(rows, vals, 512, dump, op, dtype)
    got = port(rows, vals, 256, op, dtype)
    assert_agrees(got, xla(rows, vals, 256, op, dtype), rows, vals, 256, op,
                  dtype)
    # rows past the dump row keep the identity
    assert np.all(got[dump + 1:] == np.asarray(IDENT[dtype][op], dtype=dtype))


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_int32_extremes(op):
    """int32 sums wrap as XLA's do; extrema reach the type's bounds."""
    n = 256
    rows = np.repeat(np.arange(4, dtype=np.int32), n // 4)
    vals = np.tile(np.asarray([I32.max, I32.min, I32.max, -1], np.int32),
                   n // 4)
    got = port(rows, vals, 256, op, "int32")
    want = xla(rows, vals, 256, op, "int32")
    assert np.array_equal(got, want)
    assert np.array_equal(got, pallas(rows, vals, 256, op, "int32"))


SPECIALS = np.asarray([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -2.5],
                      dtype=np.float32)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_nan_inf_and_signed_zero(op):
    """NaN propagates through min/max (jnp.minimum/maximum, not
    fmin/fmax), -0.0 orders below +0.0, infinities are values; rows
    cover every pair of specials in both orders."""
    pairs = [(a, b) for a in SPECIALS for b in SPECIALS]
    rows = np.repeat(np.arange(len(pairs), dtype=np.int32), 2)
    vals = np.asarray([x for p in pairs for x in p], dtype=np.float32)
    rows, vals = padded(rows, vals, 256, 255, op, "float32")
    got = port(rows, vals, 256, op, "float32")
    for want in (xla(rows, vals, 256, op, "float32"),
                 pallas(rows, vals, 256, op, "float32")):
        nan = np.isnan(want)
        assert np.array_equal(np.isnan(got), nan)
        assert np.array_equal(got[~nan].view(np.int32),
                              want[~nan].view(np.int32))


@pytest.mark.parametrize("op", ["min", "max"])
def test_combine_matches_jnp_elementwise(op):
    """The bank's ``a ⊕ d`` on float lanes: every pair of specials."""
    a = np.repeat(SPECIALS, len(SPECIALS))
    d = np.tile(SPECIALS, len(SPECIALS))
    want = np.asarray((jnp.minimum if op == "min" else jnp.maximum)(
        jnp.asarray(a), jnp.asarray(d)))
    got = bank_scatter.combine_(torch.from_numpy(a.copy()),
                                torch.from_numpy(d), op).numpy()
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def test_pad_rows_matches_reference():
    for r in (1, 17, 255, 256, 257, 4096, 4097, 10_000):
        assert bank_scatter.pad_rows(r) == jax_bank_scatter.pad_rows(r)
    assert bank_scatter.pad_rows(4097) == 4352


@pytest.mark.parametrize("bad", ["n", "r_pad", "dtype", "op", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    rows = torch.zeros(256, dtype=torch.int32)
    vals = torch.zeros(256, dtype=torch.float32)
    r_pad, op = 256, "sum"
    if bad == "n":
        rows, vals = rows[:200], vals[:200]
    elif bad == "r_pad":
        r_pad = 300
    elif bad == "dtype":
        vals = vals.double()
    elif bad == "op":
        op = "last"
    else:
        rows, vals = rows.to("meta"), vals.to("meta")
    with pytest.raises(ValueError):
        bank_scatter.segmented_reduce(rows, vals, r_pad, op, 0.0)


def test_cpu_calls_count_no_launch():
    before = bank_scatter.segmented_reduce.launches
    rows, vals = random_case(256, 256, "sum", "float32", seed=1)
    port(rows, vals, 256, "sum", "float32")
    assert bank_scatter.segmented_reduce.launches == before


# -- accumulate_: the bank's a ⊕ d in place --------------------------------


def reference_upd(acc, rows, vals, op, dtype):
    """The reference bank's ``upd`` (``siddhi_tpu/aggregation/
    device_bank.py``, kernel branch): ``a + d``, ``jnp.minimum(a, d)`` or
    ``jnp.maximum(a, d)`` with ``d`` from the Pallas kernel in interpret
    mode over ``pad_rows(R)`` rows, cut to ``R``."""
    R = len(acc)
    d = jax_bank_scatter.segmented_reduce(
        jnp.asarray(rows), jnp.asarray(vals), jax_bank_scatter.pad_rows(R),
        op, IDENT[dtype][op], True)[:R]
    a = jnp.asarray(acc)
    out = a + d if op in ("sum", "count") else (
        jnp.minimum(a, d) if op == "min" else jnp.maximum(a, d))
    return np.asarray(out)


def port_accumulate(acc, rows, vals, op):
    got = torch.from_numpy(acc.copy())
    out = bank_scatter.accumulate_(got, torch.from_numpy(rows),
                                   torch.from_numpy(vals), op)
    assert out is got  # in place
    return got.numpy()


def assert_accumulates(got, want, rows, vals, op, dtype):
    """Exact (NaN as NaN), but for float32 sums of non-integers: there the
    two deltas may differ by ``n * 2^-24 * sum|v|`` per row (the
    reference's contract) and each side's final ``a + d`` rounds once
    more, by at most ``2^-24`` of its result."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact_contract(op, dtype, vals):
        if dtype == "float32":
            nan = np.isnan(want)
            assert np.array_equal(np.isnan(got), nan)
            assert np.array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))
        else:
            assert np.array_equal(got, want)
        return
    R = len(want)
    n_r = np.bincount(rows, minlength=R)
    abs_r = np.bincount(rows, weights=np.abs(vals.astype(np.float64)),
                        minlength=R)
    g, w = got.astype(np.float64), want.astype(np.float64)
    bound = n_r * 2.0**-24 * abs_r + 2.0**-24 * (np.abs(g) + np.abs(w))
    assert np.all(np.abs(g - w) <= bound), float((np.abs(g - w) - bound).max())


def random_acc(R, op, dtype, seed):
    """A live accumulator: earlier batches' sums, counts or extrema."""
    rng = np.random.default_rng(seed)
    if op == "count":
        acc = rng.integers(0, 1000, R)
    elif dtype == "float32":
        acc = rng.uniform(-2000.0, 2000.0, R)
    elif op == "sum":
        acc = rng.integers(-(1 << 24), 1 << 24, R)
    else:
        acc = rng.integers(I32.min, I32.max, R, endpoint=True)
    return acc.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n_pad,R,hot", [(256, 4097, False), (1024, 17, False),
                                         (1024, 4097, True)])
def test_accumulate_plain_matches_reference_upd(n_pad, R, hot, op, dtype):
    """Every op and dtype, at the bank's 4,097 rows (not a multiple of
    256) and at 17, spread or with every event on row 0."""
    rows, vals = random_case(n_pad, R, op, dtype, seed=n_pad + R)
    if hot:
        rows[:] = 0
    acc = random_acc(R, op, dtype, seed=R)
    got = port_accumulate(acc, rows, vals, op)
    assert_accumulates(got, reference_upd(acc, rows, vals, op, dtype), rows,
                       vals, op, dtype)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_accumulate_nan_inf_and_signed_zero(op):
    """Every pair of specials (NaN, ±inf, ±0.0 and two finite values) as
    (accumulator, event), one event a row, exact against the reference;
    the rows past the pairs keep their specials."""
    pairs = [(a, v) for a in SPECIALS for v in SPECIALS]
    R = len(pairs) + len(SPECIALS) + 1  # the last row is the dump row
    acc = np.resize(SPECIALS, R).astype(np.float32)
    acc[:len(pairs)] = [a for a, _v in pairs]
    rows = np.arange(len(pairs), dtype=np.int32)
    vals = np.asarray([v for _a, v in pairs], dtype=np.float32)
    rows, vals = padded(rows, vals, 256, R - 1, op, "float32")
    got = port_accumulate(acc, rows, vals, op)
    want = reference_upd(acc, rows, vals, op, "float32")
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_accumulate_int32_extremes(op):
    """int32 sums wrap from a live accumulator as the reference's do."""
    rows = np.repeat(np.arange(4, dtype=np.int32), 64)
    vals = np.tile(np.asarray([I32.max, I32.min, I32.max, -1], np.int32), 64)
    acc = np.asarray([I32.max, I32.min, -7, 0, 5], dtype=np.int32)
    got = port_accumulate(acc, rows, vals, op)
    assert np.array_equal(got, reference_upd(acc, rows, vals, op, "int32"))


@pytest.mark.parametrize("bad", ["dtype", "acc_dtype", "device", "n",
                                 "length", "contiguous", "empty"])
def test_accumulate_refuses_what_the_kernel_does_not_take(bad):
    acc = torch.zeros(4097, dtype=torch.float32)
    rows = torch.zeros(256, dtype=torch.int32)
    vals = torch.zeros(256, dtype=torch.float32)
    if bad == "dtype":
        vals, acc = vals.double(), acc.double()
    elif bad == "acc_dtype":
        acc = acc.to(torch.int32)
    elif bad == "device":
        acc = acc.to("meta")
    elif bad == "n":
        rows, vals = rows[:200], vals[:200]
    elif bad == "length":
        vals = torch.zeros(512, dtype=torch.float32)
    elif bad == "contiguous":
        acc = torch.zeros(8194, dtype=torch.float32)[::2]
    else:
        acc = acc[:0]
    with pytest.raises(ValueError):
        bank_scatter.accumulate_(acc, rows, vals, "sum")


def test_cpu_accumulate_counts_no_launch():
    before = (bank_scatter.accumulate_.launches,
              bank_scatter.segmented_reduce.launches)
    rows, vals = random_case(256, 256, "sum", "float32", seed=1)
    port_accumulate(np.zeros(256, np.float32), rows, vals, "sum")
    assert (bank_scatter.accumulate_.launches,
            bank_scatter.segmented_reduce.launches) == before
