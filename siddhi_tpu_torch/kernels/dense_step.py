"""Packed dense-NFA step for the capture-free every-chain class.

Port of the JAX package's ``kernels/dense_step.py``.  The eligible class
(gated in ``planner/kernels.py``) is the capture-free every-start chain:
plain stream nodes (``min == max == 1``), no sequences, no group-every,
no absent deadlines, no register slots.  In that class the step's carry
shrinks to node activity and the within anchor, and activity packs 32
batch rows per int32 word (bit ``b`` of word ``w`` is batch row
``w*32 + b``; collision rounds upstream make a batch row a partition).
``counts``/``regs`` are constant in this class and are not touched.

Off the main path: the engine's ``process_deferred`` runs the batch
step (``kernels/dense_batch.py``), which walks each partition's events
in order and needs no rounds, packing or gathers.  This module stays as
the interface-level twin of the Pallas kernel, pinned to it by
``tests/test_torch_dense_step.py``, and ``chip_smoke.py`` still holds
its kernel against its plain version.  Its retirement is an open
question.

Three pieces:

- ``csrc/dense_step.cu``: the CUDA kernel for the packed step, launched
  by ``packed_step`` for CUDA tensors.  It replaces the Pallas kernel
  ``build_packed_nfa -> _pallas_call`` of the JAX package; its source
  note says how it maps to the card and what bounds it (bytes).
- ``packed_step_plain``: the same function on whole tensors, a torch
  transcription of the Pallas body.  ``packed_step`` uses it for CPU
  tensors only; ``chip_smoke.py`` holds the kernel against it.
- ``build_packed_nfa``: the step around the kernel (lane-uniform filter
  rows, gather by ``part_idx``, padding to 32-row words and 1024-row
  blocks, packing, output columns, state write-back).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from siddhi_tpu_torch.kernels import build
from siddhi_tpu_torch.kernels.plane_pack import pack_bits, unpack_bits
from siddhi_tpu_torch.planner.expr import N_KEY, TS_KEY
from siddhi_tpu_torch.query_api import AttrType

_INT_TYPES = (AttrType.INT, AttrType.LONG)

# single-block ceiling: batches up to this size pad to whole words only;
# larger batches pad to whole 1024-row blocks, as in the JAX package
MAX_SINGLE_BLOCK = 1024
# instance lanes the kernel holds per node (register arrays, csrc/)
MAX_INSTANCES = 16


def _batch_blocks(B: int) -> Tuple[int, int, int]:
    """(padded batch, total words, words per block) for a batch of B."""
    Bp = ((B + 31) // 32) * 32
    if Bp <= MAX_SINGLE_BLOCK:
        return Bp, Bp // 32, Bp // 32
    Bp = ((Bp + MAX_SINGLE_BLOCK - 1) // MAX_SINGLE_BLOCK) * MAX_SINGLE_BLOCK
    return Bp, Bp // 32, MAX_SINGLE_BLOCK // 32


def packed_step_plain(ok_pk, a_pk, first_t, ts, n_inst: int,
                      within: Optional[int]):
    """Plain torch version of the packed step (same contract as the
    kernel).  Returns ``(A', first', emit [I, W], anch [I, Bp],
    ovf [1, Bp])``."""
    S, I = ok_pk.shape[0], n_inst
    W = ok_pk.shape[1]
    Bp = ts.shape[1]
    i32 = torch.int32
    a = {s: a_pk[s * I:(s + 1) * I, :] for s in range(S)}
    first = {s: first_t[s * I:(s + 1) * I, :] for s in range(S)}

    if within is not None:
        for s in range(S):
            fs = first[s]
            expired = (fs > 0) & ((ts - fs) > within)
            a[s] = a[s] & ~pack_bits(expired)
            first[s] = torch.where(expired, 0, fs)

    # the standing virgin: instance lane 0 of node 0, every row
    lane0_pk = torch.zeros((I, W), dtype=i32, device=ts.device)
    lane0_pk[0] = -1

    emit_pk = torch.zeros((I, W), dtype=i32, device=ts.device)
    anch = torch.zeros((I, Bp), dtype=i32, device=ts.device)
    ovf = torch.zeros((1, Bp), dtype=i32, device=ts.device)
    for s in reversed(range(S)):
        pend = a[s] | lane0_pk if s == 0 else a[s]
        fire_pk = pend & ok_pk[s:s + 1, :]
        fire = unpack_bits(fire_pk)  # [I, Bp]
        if s == 0:
            # fresh arming each event: anchor is THIS event
            first[0] = torch.where(fire, ts, first[0])
        else:
            first[s] = torch.where(fire & (first[s] == 0), ts, first[s])
            a[s] = a[s] & ~fire_pk
        anchor = torch.where(first[s] > 0, first[s], ts)  # [I, Bp]
        if s == S - 1:
            emit_pk = emit_pk | fire_pk
            anch = torch.where(fire, anchor, anch)
            continue
        # rank-matched placement into node s+1: free lanes are the
        # inactive ones (counts are 0 in this class)
        free = unpack_bits(~a[s + 1])  # [I, Bp]
        src_rank = torch.cumsum(fire.to(i32), dim=0) - 1
        free_rank = torch.cumsum(free.to(i32), dim=0) - 1
        n_free = free.to(i32).sum(dim=0, keepdim=True)  # [1, Bp]
        placed = fire & (src_rank < n_free)
        ovf = ovf + (fire & ~placed).to(i32).sum(dim=0, keepdim=True)
        assign = (placed[:, None, :] & free[None, :, :]
                  & (src_rank[:, None, :] == free_rank[None, :, :]))
        got = assign.any(dim=0)  # [I, Bp] target lanes
        moved = torch.where(assign, anchor[:, None, :], 0).sum(dim=0)
        a[s + 1] = a[s + 1] | pack_bits(got)
        first[s + 1] = torch.where(got, moved.to(i32), first[s + 1])

    return (torch.cat([a[s] for s in range(S)], dim=0),
            torch.cat([first[s] for s in range(S)], dim=0),
            emit_pk, anch, ovf.to(i32))


def _check_inputs(ok_pk, a_pk, first_t, ts, n_inst, within):
    S, W = ok_pk.shape if ok_pk.dim() == 2 else (0, 0)
    Bp = W * 32
    want = {"ok_pk": (S, W), "a_pk": (S * n_inst, W),
            "first_t": (S * n_inst, Bp), "ts": (1, Bp)}
    got = {"ok_pk": ok_pk, "a_pk": a_pk, "first_t": first_t, "ts": ts}
    for name, t in got.items():
        if t.dtype != torch.int32:
            raise ValueError(f"packed_step: {name} must be int32, got {t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"packed_step: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"packed_step: {name} must be contiguous")
        if t.device != ok_pk.device:
            raise ValueError("packed_step: inputs lie on different devices")
    if not (1 <= S <= 32 and W >= 1 and 1 <= n_inst <= MAX_INSTANCES):
        raise ValueError(f"packed_step: S={S}, W={W}, I={n_inst} out of range")
    if within is not None and not 0 <= within < 2**31:
        raise ValueError(f"packed_step: within={within} outside int32")


def packed_step(ok_pk, a_pk, first_t, ts, *, n_inst: int,
                within: Optional[int]):
    """One packed dense-NFA step: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Off the main path (see the module
    docstring).  Shapes: ``ok_pk [S, W]``,
    ``a_pk [S*I, W]``, ``first_t [S*I, 32W]``, ``ts [1, 32W]``, all
    int32 and contiguous.

    The kernel (``csrc/dense_step.cu``) replaces the JAX package's
    Pallas kernel ``siddhi_tpu/kernels/dense_step.py`` ``_pallas_call``.
    It is bound by device-memory bytes: at S=16, I=4, B=131072 it reads
    and writes 33.5 MB of anchors each way plus about 5.6 MB of packed
    planes, ts, anchors out and overflow, 72.7 MB in all, which is
    21.7 us at the H100's 3.35 TB/s."""
    _check_inputs(ok_pk, a_pk, first_t, ts, n_inst, within)
    dev = ok_pk.device
    if dev.type == "cpu":
        return packed_step_plain(ok_pk, a_pk, first_t, ts, n_inst, within)
    if dev.type != "cuda":
        raise ValueError(f"packed_step: unsupported device {dev}")
    S, W = ok_pk.shape
    Bp = W * 32
    a_out = torch.empty_like(a_pk)
    first_out = torch.empty_like(first_t)
    emit_out = torch.empty((n_inst, W), dtype=torch.int32, device=dev)
    anch_out = torch.empty((n_inst, Bp), dtype=torch.int32, device=dev)
    ovf_out = torch.empty((1, Bp), dtype=torch.int32, device=dev)
    fn = build.entry("dense_step", "dense_step_launch")
    stream = torch.cuda.current_stream(dev.index).cuda_stream
    err = fn(ok_pk.data_ptr(), a_pk.data_ptr(), first_t.data_ptr(),
             ts.data_ptr(), a_out.data_ptr(), first_out.data_ptr(),
             emit_out.data_ptr(), anch_out.data_ptr(), ovf_out.data_ptr(),
             S, n_inst, W, int(within is not None), int(within or 0), stream)
    if err != 0:
        raise RuntimeError(f"dense_step kernel launch failed: CUDA error {err}")
    packed_step.launches += 1
    return a_out, first_out, emit_out, anch_out, ovf_out


packed_step.launches = 0


# smallest normal float32: below it, XLA on the CPU flushes to zero
F32_MIN_NORMAL = 2.0 ** -126


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """A float32 lane as the reference's XLA on the CPU reads it: a
    subnormal is a zero of its sign (NaN and infinities pass)."""
    return torch.where(x.abs() < F32_MIN_NORMAL, x * 0.0, x)


def candidate_env(stream_def, cols, ts):
    """Filter env of one stream's nodes: the event's lane columns
    (``[B, 1]``) under ``__cand.<attr>`` keys, integer attrs as their
    hi/lo pair, float attrs with subnormals flushed
    (``flush_subnormals``: filters compare as the reference does;
    captures read ``cols``, whose bits stay)."""
    env = {}
    for attr in stream_def.attributes:
        if attr.type in _INT_TYPES:
            hk, lk = f"{attr.name}|hi", f"{attr.name}|lo"
            if hk in cols:
                env[f"__cand.{attr.name}|hi"] = cols[hk][:, None]
                env[f"__cand.{attr.name}|lo"] = cols[lk][:, None]
        elif attr.name in cols:
            env["__cand." + attr.name] = flush_subnormals(
                cols[attr.name])[:, None]
    env[TS_KEY] = ts[:, None]
    env[N_KEY] = ts.shape[0]
    return env


def build_packed_nfa(engine, stream_key: str):
    """The packed step for one collision round of ``stream_key`` (off
    the main path: ``DensePatternEngine.make_step`` returns it; the
    engine's ``process_deferred`` runs ``dense_batch.batch_step``).

    step(state, part_idx[B] i64, cols {key: [B]}, ts[B] i32 relative ms,
         valid[B] bool) -> (state, emit[B, 2I] bool,
         {"f": [B, 2I, O] f32, "i": [B, 2I, 2*n_int_out] i32},
         emit_anchor[B, 2I] i32, n_emit scalar)

    Same returns as the JAX package's step; the second emit bank (the
    via-path of open counts) is all zero in this class.
    """
    S, I = engine.S, engine.I
    nodes = engine.nodes
    node_filters = engine.node_filters
    within = engine.within_ms
    out_spec = engine.out_spec
    out_int = engine.out_int
    O = max(len(out_spec), 1)
    n_iout = sum(out_int)
    on_stream = [n.specs[0].stream_key == stream_key for n in nodes]
    int_out_idx: Dict[int, int] = {}
    for _oi, _isint in enumerate(out_int):
        if _isint:
            int_out_idx[_oi] = len(int_out_idx)

    def step(state, part_idx, cols, ts, valid):
        B = part_idx.shape[0]
        dev = ts.device
        Bp, W, _WB = _batch_blocks(B)

        # lane-uniform candidate filters: one eligibility row per node,
        # pre-ANDed with the valid mask (off-stream nodes never fire)
        ok_mat = torch.zeros((S, Bp), dtype=torch.bool, device=dev)
        cenv = None  # one env for every node on this stream
        for s in range(S):
            if not on_stream[s]:
                continue
            f = node_filters[s][0]
            if f is None:
                ok_mat[s, :B] = valid
            else:
                if cenv is None:
                    cenv = candidate_env(nodes[s].specs[0].stream_def, cols,
                                         ts)
                okb = torch.as_tensor(f.fn(cenv), device=dev)
                ok_mat[s, :B] = okb.to(torch.bool).broadcast_to((B, 1))[:, 0] & valid

        # gather the round's rows (copies) before anything is written
        a_old = state["active"][part_idx]        # [B, S, I]
        first_old = state["first_ts"][part_idx]  # [B, S, I]
        ovf_old = state["overflow"][part_idx]    # [B]

        a = torch.zeros((Bp, S, I), dtype=torch.bool, device=dev)
        a[:B] = a_old
        first = torch.zeros((Bp, S, I), dtype=torch.int32, device=dev)
        first[:B] = first_old
        ts_p = torch.zeros((1, Bp), dtype=torch.int32, device=dev)
        ts_p[0, :B] = ts

        a_pk = pack_bits(a.permute(1, 2, 0).reshape(S * I, Bp))
        first_t = first.permute(1, 2, 0).reshape(S * I, Bp).contiguous()
        ok_pk = pack_bits(ok_mat)

        a_o, first_o, emit_o, anch_o, ovf_o = packed_step(
            ok_pk, a_pk, first_t, ts_p, n_inst=I, within=within)

        a_new = unpack_bits(a_o).reshape(S, I, Bp).permute(2, 0, 1)[:B]
        first_new = first_o.reshape(S, I, Bp).permute(2, 0, 1)[:B]
        emit_b0 = unpack_bits(emit_o).t()[:B]  # [B, I]
        anch_b0 = anch_o.t()[:B]
        ovf_delta = ovf_o[0, :B]

        emit = torch.cat(
            [emit_b0, torch.zeros((B, I), dtype=torch.bool, device=dev)], 1)
        emit_anchor = torch.cat(
            [anch_b0, torch.zeros((B, I), dtype=torch.int32, device=dev)], 1)

        # output columns: candidate selects at the emitting lanes of
        # bank 0 (the eligible class has no via-path)
        out_vals = torch.zeros((B, 2 * I, O), dtype=torch.float32, device=dev)
        out_ivals = torch.zeros((B, 2 * I, 2 * n_iout), dtype=torch.int32,
                                device=dev)
        for oi, (_name, src) in enumerate(out_spec):
            ii = int_out_idx.get(oi)
            if ii is not None:
                hk, lk = f"{src[1]}|hi", f"{src[1]}|lo"
                if hk not in cols:
                    continue
                out_ivals[:, :I, 2 * ii] = torch.where(
                    emit_b0, cols[hk][:, None], 0)
                out_ivals[:, :I, 2 * ii + 1] = torch.where(
                    emit_b0, cols[lk][:, None], 0)
                continue
            val = cols.get(src[1])
            if val is None:
                continue
            out_vals[:, :I, oi] = torch.where(
                emit_b0, val.to(torch.float32)[:, None], 0.0)

        # write the rows back in place (the JAX step donates its state
        # instead).  Rows are unique within a collision round; padding
        # rows all point at the scratch row P and write back its own old
        # value, so their duplicate writes agree.
        v1 = valid[:, None, None]
        state["active"].index_put_(
            (part_idx,), torch.where(v1, a_new, a_old))
        state["first_ts"].index_put_(
            (part_idx,), torch.where(v1, first_new, first_old))
        state["overflow"].index_put_(
            (part_idx,), torch.where(valid, ovf_old + ovf_delta, ovf_old))
        n_emit = (emit & valid[:, None]).sum()
        return (state, emit, {"f": out_vals, "i": out_ivals},
                emit_anchor, n_emit)

    return step
