"""Segmented reduce for the aggregation device bank.

Port of the JAX package's ``kernels/bank_scatter.py``.  The bank adds a
micro-batch into its accumulator rows as ``a ⊕ segmented_reduce(rows,
vals)``: the per-row sum, count, min or max of ``(rows [n], vals [n])``
against the op's identity, ``[r_pad]`` wide.

Two pieces:

- ``csrc/bank_scatter.cu``: the CUDA kernel, launched by
  ``segmented_reduce`` for CUDA tensors.  It replaces the Pallas kernel
  ``siddhi_tpu/kernels/bank_scatter.py`` (``_build`` via
  ``segmented_reduce``).  Warp-private accumulators in shared memory,
  lanes of one row combined through ``__match_any_sync``, every combine
  in an order fixed by the shapes: deterministic, and a hot key does not
  serialise (the source says how).  One launch a call.  Bound on the
  H100: bytes, 279,552 B at the bank's default shape, under 0.1 us;
  launch cost dominates.  ``segmented_reduce.launches`` counts its
  launches.
- ``segmented_reduce_plain``: ``scatter_combine_`` into a row of
  identities.  ``segmented_reduce`` uses it for CPU tensors only;
  ``chip_smoke.py`` holds the kernel against it.

Contract, the reference's: int32 lanes, min/max lanes and count lanes
(integer-valued float32 below 2^24) are bit-exact; float32 sums may
associate differently, within ``n * 2^-24 * sum|v|`` for a row of ``n``
events.  Float min/max follow ``jnp.minimum``/``jnp.maximum``: NaN
propagates and -0.0 orders below +0.0.  int32 sums wrap.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from siddhi_tpu_torch.kernels import build

ROW_BLOCK = 256

_OPS = {"sum": 0, "count": 0, "min": 1, "max": 2}
_DTYPES = {torch.float32: 0, torch.int32: 1}


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


def _check_inputs(rows, vals, r_pad, op):
    n = rows.numel()
    if rows.dtype != torch.int32 or vals.dtype not in _DTYPES:
        raise ValueError(f"segmented_reduce: rows must be int32 and vals "
                         f"float32 or int32, got {rows.dtype}, {vals.dtype}")
    if rows.dim() != 1 or tuple(vals.shape) != (n,):
        raise ValueError(f"segmented_reduce: rows {tuple(rows.shape)} and "
                         f"vals {tuple(vals.shape)} must be [n]")
    if not (rows.is_contiguous() and vals.is_contiguous()):
        raise ValueError("segmented_reduce: inputs must be contiguous")
    if rows.device != vals.device:
        raise ValueError("segmented_reduce: inputs lie on different devices")
    if n < 256 or n & (n - 1) or r_pad != pad_rows(r_pad):
        raise ValueError(f"segmented_reduce: n={n} must be a power of two "
                         f">= 256 and r_pad={r_pad} a multiple of "
                         f"{ROW_BLOCK}")
    if op not in _OPS:
        raise ValueError(f"segmented_reduce: unknown op {op!r}")


def _bits(identity, dtype) -> int:
    if dtype == torch.float32:
        return struct.unpack("<i", struct.pack("<f", float(identity)))[0]
    return int(identity)


_ARRIVALS: dict = {}


def _arrivals(dev, stream: int, tiles: int) -> torch.Tensor:
    """The kernel's per-tile arrival counters for launches on ``stream``:
    zeroed once, and left zero by every launch."""
    key = (dev.index, stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < tiles:
        buf = _ARRIVALS[key] = torch.zeros(tiles, dtype=torch.int32,
                                           device=dev)
    return buf


def segmented_reduce(rows, vals, r_pad: int, op: str, identity):
    """Per-row reduction delta: (``rows [n]``, ``vals [n]``) → ``[r_pad]``:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    ``n`` is a power of two >= 256, padded by the caller with events on a
    dump row that carry ``identity``; every row lies in ``[0, r_pad)``."""
    _check_inputs(rows, vals, r_pad, op)
    dev = rows.device
    if dev.type == "cpu":
        return segmented_reduce_plain(rows, vals, r_pad, op, identity)
    if dev.type != "cuda":
        raise ValueError(f"segmented_reduce: unsupported device {dev}")
    lib = build.load("bank_scatter")
    for name in ("bank_scatter_chunks", "bank_scatter_tiles"):
        getattr(lib, name).argtypes = [ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
    n = rows.numel()
    out = torch.empty(r_pad, dtype=vals.dtype, device=dev)
    n_chunks = lib.bank_scatter_chunks(n)
    partial = (torch.empty((n_chunks, r_pad), dtype=vals.dtype, device=dev)
               if n_chunks > 1 else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    arrivals = _arrivals(dev, stream, lib.bank_scatter_tiles(r_pad))
    fn = lib.bank_scatter_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(rows.data_ptr(), vals.data_ptr(), out.data_ptr(),
             partial.data_ptr() if partial is not None else None,
             arrivals.data_ptr(), n, r_pad, _DTYPES[vals.dtype], _OPS[op],
             _bits(identity, vals.dtype), stream)
    if err != 0:
        raise RuntimeError(f"bank_scatter kernel launch failed: CUDA error "
                           f"{err}")
    segmented_reduce.launches += 1
    return out


segmented_reduce.launches = 0
