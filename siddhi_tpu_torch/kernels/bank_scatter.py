"""Segmented reduce for the aggregation device bank.

Port of the JAX package's ``kernels/bank_scatter.py``.  The bank adds a
micro-batch into its accumulator rows as ``a ⊕ segmented_reduce(rows,
vals)``: the per-row sum, count, min or max of ``(rows [n], vals [n])``
against the op's identity.

Three pieces:

- ``csrc/bank_scatter.cu``: the CUDA kernel, launched for CUDA tensors
  by two entries.  ``segmented_reduce(rows, vals, r_pad, op, identity)``
  keeps the JAX contract (the delta, ``[r_pad]`` wide);
  ``accumulate_(acc, rows, vals, op)`` folds the reduction into ``acc``
  in place, ``acc[r] = acc[r] ⊕ x[r]``, the bank's ``a ⊕ d`` with no
  delta in memory.  The kernel replaces the Pallas kernel
  ``siddhi_tpu/kernels/bank_scatter.py`` (``_build`` via
  ``segmented_reduce``).  A grid of row slices × event chunks covers the
  card; warp-private accumulators in shared memory, lanes of one row
  combined through ``__match_any_sync``, every combine in an order fixed
  by the shapes: deterministic, and a hot key does not serialise (the
  source says how).  One launch a call.  Bound on the H100: bytes,
  279,552 B for the delta and 294,920 B for the accumulate entry at the
  bank's shape, under 0.1 us; launch cost dominates.  Each entry counts
  its launches (``segmented_reduce.launches``, ``accumulate_.launches``).
- ``segmented_reduce_plain`` and ``accumulate_plain``:
  ``scatter_combine_`` into a row of identities, and ``combine_`` of
  that delta into ``acc``.  The entries use them for CPU tensors only;
  ``chip_smoke.py`` holds the kernel against them.

Contract, the reference's: int32 lanes, min/max lanes and count lanes
(integer-valued float32 below 2^24) are bit-exact; float32 sums may
associate differently, within ``n * 2^-24 * sum|v|`` for a row of ``n``
events.  Float min/max follow ``jnp.minimum``/``jnp.maximum``: NaN
propagates and -0.0 orders below +0.0.  int32 sums wrap.
"""

from __future__ import annotations

import ctypes
import math
import struct

import torch

from siddhi_tpu_torch.kernels import build

ROW_BLOCK = 256

_OPS = {"sum": 0, "count": 0, "min": 1, "max": 2}
_DTYPES = {torch.float32: 0, torch.int32: 1}
# the bank's identity of each op, per lane dtype (accumulate_ starts its
# rows' reductions from it)
_IDENTITY = {
    torch.float32: {"sum": 0.0, "count": 0.0, "min": math.inf,
                    "max": -math.inf},
    torch.int32: {"sum": 0, "count": 0, "min": 2**31 - 1, "max": -(2**31)},
}


def pad_rows(r: int) -> int:
    """Round a row count up to a whole number of row blocks."""
    return max(ROW_BLOCK, ((r + ROW_BLOCK - 1) // ROW_BLOCK) * ROW_BLOCK)


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """float32 → int32 keys in the float order, -0.0 below +0.0 (NaNs
    land at the ends; callers mask them).  Its own inverse."""
    b = x.view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _float_extrema(acc, key, nan):
    """Write the floats of ordered ``key`` into ``acc``, NaN where ``nan``."""
    out = _ordered(key).view(torch.float32)
    return acc.copy_(torch.where(nan, float("nan"), out))


def combine_(acc: torch.Tensor, delta: torch.Tensor, op: str) -> torch.Tensor:
    """``acc ⊕= delta`` elementwise, in place, as ``a + d`` /
    ``jnp.minimum(a, d)`` / ``jnp.maximum(a, d)`` compute it."""
    if op in ("sum", "count"):
        return acc.add_(delta)
    pick = torch.minimum if op == "min" else torch.maximum
    if acc.dtype != torch.float32:
        return pick(acc, delta, out=acc)
    nan = torch.isnan(acc) | torch.isnan(delta)
    return _float_extrema(acc, pick(_ordered(acc), _ordered(delta)), nan)


def scatter_combine_(acc: torch.Tensor, rows: torch.Tensor,
                     vals: torch.Tensor, op: str) -> torch.Tensor:
    """``acc ⊕= vals`` at ``rows``, in place, as XLA's
    ``acc.at[rows].add/min/max(vals)`` computes it."""
    idx = rows.long()
    if op in ("sum", "count"):
        return acc.index_add_(0, idx, vals)
    red = "amin" if op == "min" else "amax"
    if acc.dtype != torch.float32:
        return acc.scatter_reduce_(0, idx, vals, reduce=red, include_self=True)
    key = _ordered(acc).scatter_reduce_(0, idx, _ordered(vals), reduce=red,
                                        include_self=True)
    hits = torch.zeros(acc.shape, dtype=torch.int32, device=acc.device)
    hits.index_add_(0, idx, torch.isnan(vals).to(torch.int32))
    return _float_extrema(acc, key, torch.isnan(acc) | (hits > 0))


def segmented_reduce_plain(rows, vals, r_pad: int, op: str, identity):
    """Plain torch version of the segmented reduce (same contract as the
    kernel): ``rows [n]`` int32, ``vals [n]`` → ``[r_pad]``."""
    out = torch.full((r_pad,), identity, dtype=vals.dtype, device=vals.device)
    return scatter_combine_(out, rows, vals, op)


def accumulate_plain(acc, rows, vals, op: str):
    """Plain torch version of ``accumulate_``: ``acc ⊕= `` the per-row
    reduction of ``(rows, vals)``, as the reference's bank computes
    ``a ⊕ segmented_reduce(...)``.  Every row lies in
    ``[0, acc.numel())``."""
    d = segmented_reduce_plain(rows, vals, acc.numel(), op,
                               _IDENTITY[vals.dtype][op])
    return combine_(acc, d, op)


def _check_events(rows, vals, op, who):
    n = rows.numel()
    if rows.dtype != torch.int32 or vals.dtype not in _DTYPES:
        raise ValueError(f"{who}: rows must be int32 and vals float32 or "
                         f"int32, got {rows.dtype}, {vals.dtype}")
    if rows.dim() != 1 or vals.shape != rows.shape:
        raise ValueError(f"{who}: rows {tuple(rows.shape)} and vals "
                         f"{tuple(vals.shape)} must be [n]")
    if not (rows.is_contiguous() and vals.is_contiguous()):
        raise ValueError(f"{who}: inputs must be contiguous")
    if rows.device != vals.device:
        raise ValueError(f"{who}: inputs lie on different devices")
    if n < 256 or n & (n - 1):
        raise ValueError(f"{who}: n={n} must be a power of two >= 256")
    if op not in _OPS:
        raise ValueError(f"{who}: unknown op {op!r}")


def _bits(identity, dtype) -> int:
    """The identity's 32-bit pattern."""
    if dtype == torch.int32:
        return int(identity)
    return struct.unpack("<i", struct.pack("<f", float(identity)))[0]


class _Plan(ctypes.Structure):
    """``struct Plan`` of ``csrc/bank_scatter.cu``, field for field: what a
    launch takes besides its tensors."""

    _fields_ = [("partial", ctypes.c_void_p), ("arrivals", ctypes.c_void_p),
                ("n", ctypes.c_int), ("n_rows", ctypes.c_int),
                ("dtype", ctypes.c_int), ("op", ctypes.c_int),
                ("accumulate", ctypes.c_int), ("ident_bits", ctypes.c_int)]


# (device, stream, shape, dtype, op, mode, identity) -> (plan address,
# plan, scratch, counters): made once, kept alive here
_PLANS: dict = {}


def _plan(dev, stream: int, n: int, n_rows: int, dtype, op: str,
          accumulate: int, identity) -> int:
    """The host address of the launch plan for this shape, op and mode on
    ``stream``, with its chunk-partial scratch and arrival counters
    (zeroed once; every launch leaves them zero; the stream orders the
    launches that share them)."""
    # copysign tells -0.0 from 0.0, which compare and hash equal
    key = (dev.index, stream, n, n_rows, dtype, op, accumulate, identity,
           math.copysign(1.0, identity))
    hit = _PLANS.get(key)
    if hit is None:
        words = build.entry("bank_scatter", "bank_scatter_scratch")(n, n_rows)
        if words < 0:
            raise ValueError(f"bank_scatter: n={n}, rows={n_rows} too large")
        slices = build.entry("bank_scatter", "bank_scatter_slices")(n_rows)
        part = torch.empty(words, dtype=torch.int32, device=dev)
        arrivals = torch.zeros(slices, dtype=torch.int32, device=dev)
        plan = _Plan(part.data_ptr() if words else None, arrivals.data_ptr(),
                     n, n_rows, _DTYPES[dtype], _OPS[op], accumulate,
                     _bits(identity, dtype))
        hit = _PLANS[key] = (ctypes.addressof(plan), plan, part, arrivals)
    return hit[0]


def _launch(rows, vals, out, n_rows: int, op: str, accumulate: int,
            identity):
    dev = rows.device
    # by index: the cheaper of the public reads (chip_smoke.py host_split)
    stream = torch.cuda.current_stream(dev.index).cuda_stream
    plan = _plan(dev, stream, rows.numel(), n_rows, vals.dtype, op,
                 accumulate, identity)
    err = build.entry("bank_scatter", "bank_scatter_launch")(
        rows.data_ptr(), vals.data_ptr(), out.data_ptr(), plan, stream)
    if err != 0:
        raise RuntimeError(f"bank_scatter kernel launch failed: CUDA error "
                           f"{err}")


def segmented_reduce(rows, vals, r_pad: int, op: str, identity):
    """Per-row reduction delta: (``rows [n]``, ``vals [n]``) → ``[r_pad]``:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    ``n`` is a power of two >= 256, padded by the caller with events on a
    dump row that carry ``identity``; every row lies in ``[0, r_pad)``."""
    _check_events(rows, vals, op, "segmented_reduce")
    if r_pad != pad_rows(r_pad):
        raise ValueError(f"segmented_reduce: r_pad={r_pad} must be a "
                         f"multiple of {ROW_BLOCK}")
    dev = rows.device
    if dev.type == "cpu":
        return segmented_reduce_plain(rows, vals, r_pad, op, identity)
    if dev.type != "cuda":
        raise ValueError(f"segmented_reduce: unsupported device {dev}")
    out = torch.empty(r_pad, dtype=vals.dtype, device=dev)
    _launch(rows, vals, out, r_pad, op, 0, identity)
    segmented_reduce.launches += 1
    return out


segmented_reduce.launches = 0


def accumulate_(acc, rows, vals, op: str):
    """``acc[r] = acc[r] ⊕ (⊕ of vals[e] with rows[e] == r)`` in place,
    for ``acc [R]`` of the values' dtype: the CUDA kernel for CUDA
    tensors (one launch, no delta tensor), the plain version for CPU
    tensors.  ``n`` is a power of two >= 256; every row lies in
    ``[0, R)``.  Returns ``acc``."""
    _check_events(rows, vals, op, "accumulate_")
    if (acc.dtype != vals.dtype or acc.dim() != 1 or not acc.numel()
            or not acc.is_contiguous()):
        raise ValueError(f"accumulate_: acc must be a contiguous non-empty "
                         f"[R] tensor of {vals.dtype}, got {acc.dtype} "
                         f"{tuple(acc.shape)}")
    dev = rows.device
    if acc.device != dev:
        raise ValueError("accumulate_: acc and the events lie on different "
                         "devices")
    if dev.type == "cpu":
        return accumulate_plain(acc, rows, vals, op)
    if dev.type != "cuda":
        raise ValueError(f"accumulate_: unsupported device {dev}")
    _launch(rows, vals, acc, acc.numel(), op, 1, _IDENTITY[vals.dtype][op])
    accumulate_.launches += 1
    return acc


accumulate_.launches = 0
