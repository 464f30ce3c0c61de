"""Batch dense-NFA step: one launch walks a whole batch, partition by
partition, with each partition's state row updated in place.

Port of the JAX package's packed step (``kernels/dense_step.py``
``build_packed_nfa`` → ``_pallas_call``) *together with* the engine's
collision-round loop around it (``ops/dense_nfa.py`` ``process`` and
``_collision_rounds``).  The packed step is row-independent and the
rounds keep each partition's event order, so walking each partition's
events in batch order, one after another, gives the same state and the
same emits as the rounds, bit for bit.

The batch comes sorted stably by partition:

- ``order [N]`` int32: batch-row indices grouped by partition, batch
  order within a partition;
- ``seg_start [K+1]`` int32: segment ``k`` is ``order[seg_start[k]:
  seg_start[k+1]]``;
- ``seg_part [K]`` int32: the state row of each segment, each row at
  most once;
- ``ok [N, S]`` bool: each node's filter AND on-stream, per batch row
  (event-major, so one event's flags are one contiguous read);
- ``ts [N]`` int32: relative ms per batch row.

The state dict holds the engine's tensors in their layout:
``active [P+1, S, I]`` bool, ``first_ts [P+1, S, I]`` int32 and
``overflow [P+1]`` int32, updated in place.  Returns ``emit [N, 2I]``
bool and ``emit_anchor [N, 2I]`` int32 by batch row (the second bank
is all zero in this class) and ``n_emit``, an int32 0-d tensor.

Three pieces:

- ``csrc/dense_batch.cu``: the CUDA kernel, launched by ``batch_step``
  for CUDA tensors (one launch a batch; ``batch_step.launches`` counts
  them).  Its source note gives the design and the bound.
- ``batch_step_plain``: the same function in torch ops, one vector
  step per occurrence rank (the rounds).  ``batch_step`` uses it for CPU
  tensors only; ``chip_smoke.py`` holds the kernel against it.
- ``step_rows_plain``: the per-row program on gathered rows, the
  unpacked form of ``dense_step.packed_step_plain``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from siddhi_tpu_torch.kernels import build

MAX_NODES = 32
# a node's instance lanes are one uint32 bitmask in the kernel
MAX_INSTANCES = 32


def step_rows_plain(active, first, ok, ts, within: Optional[int]):
    """The packed step's per-row program on ``b`` independent rows:
    ``active [b, S, I]`` bool, ``first [b, S, I]`` int32, ``ok [b, S]``
    bool, ``ts [b]`` int32.  Returns ``(active', first', emit [b, I],
    anchor [b, I], overflow delta [b])``; the inputs are not changed."""
    b, S, I = active.shape
    i32 = torch.int32
    dev = ts.device
    t = ts[:, None]  # [b, 1]
    a = [active[:, s] for s in range(S)]
    f = [first[:, s] for s in range(S)]
    if within is not None:
        for s in range(S):
            # int32 wrap-around subtraction, as in the reference step
            expired = (f[s] > 0) & ((t - f[s]) > within)
            a[s] = a[s] & ~expired
            f[s] = torch.where(expired, 0, f[s])
    lane0 = torch.zeros(I, dtype=torch.bool, device=dev)
    lane0[0] = True
    emit = torch.zeros((b, I), dtype=torch.bool, device=dev)
    anch = torch.zeros((b, I), dtype=i32, device=dev)
    ovf = torch.zeros(b, dtype=i32, device=dev)
    for s in reversed(range(S)):
        pend = a[s] | lane0 if s == 0 else a[s]
        fire = pend & ok[:, s:s + 1]
        if s == 0:
            f[0] = torch.where(fire, t, f[0])  # fresh arming: this event
        else:
            f[s] = torch.where(fire & (f[s] == 0), t, f[s])
            a[s] = a[s] & ~fire
        anchor = torch.where(f[s] > 0, f[s], t)
        if s == S - 1:
            emit = fire
            anch = torch.where(fire, anchor, 0)
            continue
        # rank-matched placement into node s+1: the k-th fired lane takes
        # the k-th free lane; the rest overflow
        free = ~a[s + 1]
        src_rank = torch.cumsum(fire.to(i32), dim=1) - 1
        free_rank = torch.cumsum(free.to(i32), dim=1) - 1
        n_free = free.to(i32).sum(dim=1, keepdim=True)
        placed = fire & (src_rank < n_free)
        ovf = ovf + (fire & ~placed).to(i32).sum(dim=1)
        assign = (placed[:, :, None] & free[:, None, :]
                  & (src_rank[:, :, None] == free_rank[:, None, :]))
        got = assign.any(dim=1)  # [b, I] target lanes
        moved = torch.where(assign, anchor[:, :, None], 0).sum(dim=1)
        a[s + 1] = a[s + 1] | got
        f[s + 1] = torch.where(got, moved.to(i32), f[s + 1])
    return (torch.stack(a, dim=1), torch.stack(f, dim=1), emit,
            anch.to(i32), ovf)


def batch_step_plain(state: Dict[str, torch.Tensor], order, seg_start,
                     seg_part, ok, ts, n_inst: int, within: Optional[int]):
    """Plain torch version of the batch step (same contract as the
    kernel): rank ``r`` steps the ``r``-th event of every segment longer
    than ``r`` at once, which is a collision round."""
    N, I = ok.shape[0], n_inst
    dev = ts.device
    active, first, overflow = (state["active"], state["first_ts"],
                               state["overflow"])
    emit = torch.zeros((N, 2 * I), dtype=torch.bool, device=dev)
    anchor = torch.zeros((N, 2 * I), dtype=torch.int32, device=dev)
    starts = seg_start[:-1].long()
    seg_len = seg_start[1:].long() - starts
    parts = seg_part.long()
    n_ranks = int(seg_len.max()) if seg_len.numel() else 0
    for r in range(n_ranks):
        live = torch.nonzero(seg_len > r).flatten()
        ev = order[starts[live] + r].long()
        p = parts[live]
        a2, f2, em, an, ov = step_rows_plain(
            active[p], first[p], ok[ev], ts[ev], within)
        active[p] = a2
        first[p] = f2
        overflow[p] += ov
        emit[ev, :I] = em
        anchor[ev, :I] = an
    return emit, anchor, emit.sum(dtype=torch.int32)


def _check_inputs(state, order, seg_start, seg_part, ok, ts, n_inst, within):
    who = "batch_step"
    N = ts.numel()
    K = seg_part.numel()
    tensors = {"order": order, "seg_start": seg_start, "seg_part": seg_part,
               "ts": ts, "ok": ok, "active": state.get("active"),
               "first_ts": state.get("first_ts"),
               "overflow": state.get("overflow")}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{who}: {name} is missing")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
        if t.device != ts.device:
            raise ValueError(f"{who}: inputs lie on different devices")
    want_dtype = {"order": torch.int32, "seg_start": torch.int32,
                  "seg_part": torch.int32, "ts": torch.int32,
                  "ok": torch.bool, "active": torch.bool,
                  "first_ts": torch.int32, "overflow": torch.int32}
    for name, dt in want_dtype.items():
        if tensors[name].dtype != dt:
            raise ValueError(f"{who}: {name} must be {dt}, got "
                             f"{tensors[name].dtype}")
    active = state["active"]
    if active.dim() != 3:
        raise ValueError(f"{who}: active must be [P+1, S, I], got "
                         f"{tuple(active.shape)}")
    P1, S, I = active.shape
    want_shape = {"order": (N,), "seg_start": (K + 1,), "seg_part": (K,),
                  "ts": (N,), "ok": (N, S), "first_ts": (P1, S, I),
                  "overflow": (P1,)}
    for name, shape in want_shape.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{who}: {name} has shape "
                             f"{tuple(tensors[name].shape)}, expected {shape}")
    if not (1 <= S <= MAX_NODES and 1 <= n_inst <= MAX_INSTANCES
            and I == n_inst):
        raise ValueError(f"{who}: S={S}, I={I}, n_inst={n_inst} out of range "
                         f"(1 <= S <= {MAX_NODES}, 1 <= I <= {MAX_INSTANCES})")
    if K > N or (N and K < 1):
        raise ValueError(f"{who}: {N} events in {K} segments")
    if within is not None and not 0 <= within < 2**31:
        raise ValueError(f"{who}: within={within} outside int32")


class _Plan(ctypes.Structure):
    """``struct Plan`` of ``csrc/dense_batch.cu``, field for field: the
    launch's shape constants, filled once by ``dense_batch_plan``."""

    _fields_ = [("S", ctypes.c_int), ("I", ctypes.c_int),
                ("has_within", ctypes.c_int), ("within", ctypes.c_int),
                ("warps", ctypes.c_int), ("smem", ctypes.c_int)]


# (device index, S, I, within) -> (plan address, plan): made once
_PLANS: dict = {}


def _plan(dev, S: int, I: int, within: Optional[int]) -> int:
    key = (dev.index, S, I, within)
    hit = _PLANS.get(key)
    if hit is None:
        plan = _Plan()
        with torch.cuda.device(dev):
            err = build.entry("dense_batch", "dense_batch_plan")(
                ctypes.addressof(plan), S, I, int(within is not None),
                int(within or 0))
        if err != 0:
            raise RuntimeError(f"dense_batch plan for S={S}, I={I} failed: "
                               f"CUDA error {err}")
        hit = _PLANS[key] = (ctypes.addressof(plan), plan)
    return hit[0]


def batch_step(state: Dict[str, torch.Tensor], order, seg_start, seg_part,
               ok, ts, *, n_inst: int, within: Optional[int]):
    """One batch of the dense NFA: the CUDA kernel for CUDA tensors (one
    launch), the plain version for CPU tensors.  Updates ``state`` in
    place; returns ``(emit [N, 2I] bool, emit_anchor [N, 2I] int32,
    n_emit)``.  Shapes and dtypes are in the module docstring.

    The kernel (``csrc/dense_batch.cu``) replaces the JAX package's
    Pallas kernel ``siddhi_tpu/kernels/dense_step.py`` ``_pallas_call``
    and the collision rounds around it.  At 1 M partitions (131,072
    one-event segments, S=16, I=4) it is bound by about 95 MB of device
    memory traffic, about 28 us at 3.35 TB/s; with a long segment (the
    skew-routed batch's hot cold key) by that segment's serial chain."""
    _check_inputs(state, order, seg_start, seg_part, ok, ts, n_inst, within)
    dev = ts.device
    if dev.type == "cpu":
        return batch_step_plain(state, order, seg_start, seg_part, ok, ts,
                                n_inst, within)
    if dev.type != "cuda":
        raise ValueError(f"batch_step: unsupported device {dev}")
    N, K = ts.numel(), seg_part.numel()
    emit = torch.empty((N, 2 * n_inst), dtype=torch.bool, device=dev)
    anchor = torch.empty((N, 2 * n_inst), dtype=torch.int32, device=dev)
    if N == 0:  # nothing to walk: no launch
        return emit, anchor, torch.zeros((), dtype=torch.int32, device=dev)
    n_emit = torch.empty((), dtype=torch.int32, device=dev)
    S = ok.shape[1]
    plan = _plan(dev, S, n_inst, within)
    stream = torch.cuda.current_stream(dev.index).cuda_stream
    err = build.entry("dense_batch", "dense_batch_launch")(
        plan, state["active"].data_ptr(), state["first_ts"].data_ptr(),
        state["overflow"].data_ptr(), order.data_ptr(), seg_start.data_ptr(),
        seg_part.data_ptr(), ok.data_ptr(), ts.data_ptr(), emit.data_ptr(),
        anchor.data_ptr(), n_emit.data_ptr(), K, N, stream)
    if err != 0:
        raise RuntimeError(f"dense_batch kernel launch failed: CUDA error "
                           f"{err}")
    batch_step.launches += 1
    return emit, anchor, n_emit


batch_step.launches = 0
