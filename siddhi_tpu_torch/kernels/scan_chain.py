"""Fused hot-key scan: the max-plus and counting chains in one pass.

Port of the JAX package's ``kernels/scan_chain.py``.  For each hot-key
slot ``h`` the kernel walks that slot's ``n`` events in order, carrying
the ``[S]`` youngest-start vector ``v`` (max-plus) and the ``[S]``
pending-chain count vector ``c``.  Event ``e`` emits ``c[S-1]`` copies
when its final-node filter ``F[e, S]`` holds and lane ``S-1`` is live
(``v[S-1] > NEG/2``), read from the vectors BEFORE the event's update.
Lane 0 is the constant lane (v = 0, c = 1).

Two pieces:

- ``csrc/scan_chain.cu``: the CUDA kernel, launched by ``fused_scan``
  for CUDA tensors.  It replaces the Pallas kernel
  ``siddhi_tpu/kernels/scan_chain.py`` (``_build`` via ``fused_scan``).
  One warp per slot, lane ``i`` holding ``v[i]`` and ``c[i]`` (S <= 32).
  Bound on the H100: the serial chain, not the bytes.  At H=8, n=2048,
  S=2 the kernel moves 0.33 MB (0.1 us at 3.35 TB/s), but each slot's
  2048 events are a dependent chain: per event a warp shuffle and about
  five dependent f32 operations, each waiting at least 4 cycles for the
  one before, so n x 24 cycles, about 25 us at 1.98 GHz.  ``chip_smoke.py``
  works both terms out from the shapes and the card's clock.
  ``fused_scan.launches`` counts its launches.
- ``fused_scan_plain``: a torch loop over ``n``, vectorized over
  ``[H, S]``, transcribing the Pallas body.  ``fused_scan`` uses it for
  CPU tensors only; ``chip_smoke.py`` holds the kernel against it.

Both compute what the Pallas body computes, in the same order of f32
operations, so they agree bit for bit on every lane, dead lanes
included.  Counts are integer-valued f32 adds, exact below 2^24.
"""

from __future__ import annotations

import torch

from siddhi_tpu_torch.kernels import build

# the reference's weakly typed python float: every use rounds it to
# float32 (-1e30f), and NEG / 2 to -5e29f
NEG = -1e30
MAX_NODES = 32
MAX_SLOTS = 256


def fused_scan_plain(F, ts_rel, v, c):
    """Plain torch version of the fused scan (same contract as the
    kernel): ``F [H, n, S+1]``, ``ts_rel [H, n]``, ``v, c [H, S]``, all
    float32 → ``(v' [H, S], c' [H, S], emit [H, n])``."""
    H, n, Sp1 = F.shape
    S = Sp1 - 1
    dev = F.device
    lane = torch.arange(S, device=dev)[None, :]
    lane0 = lane == 0
    lane1 = lane == 1
    zero1 = torch.zeros((H, 1), dtype=torch.float32, device=dev)
    one1 = torch.ones((H, 1), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG, dtype=torch.float32, device=dev)
    emit = torch.empty((H, n), dtype=torch.float32, device=dev)
    f_all = F > 0.5
    for e in range(n):
        f = f_all[:, e, :]  # [H, S+1]
        tse = ts_rel[:, e:e + 1]  # [H, 1]
        fi = f[:, 0:S]  # lane i: filter F_i (lane 0 unused)
        fip1 = f[:, 1:S + 1]  # lane i: filter F_{i+1}
        # emission is decided on the PRE-update vectors
        live_last = v[:, S - 1:S] > NEG / 2
        emit[:, e:e + 1] = torch.where(f[:, S:S + 1] & live_last,
                                       c[:, S - 1:S], 0.0)
        v_sh = torch.cat([zero1, v[:, :S - 1]], dim=1)
        c_sh = torch.cat([one1, c[:, :S - 1]], dim=1)
        # lane i advance-in term: F_i ? (i==1 ? ts : v[i-1]) : NEG+v[i-1]
        t1_true = torch.where(lane1, tse, v_sh)
        term1 = torch.where(fi, t1_true, NEG + v_sh)
        # lane i keep term: F_{i+1} ? NEG+v[i] : v[i]
        term2 = torch.where(fip1, NEG + v, v)
        nv = torch.maximum(torch.maximum(term1, term2), neg)
        v = torch.where(lane0, 0.0, nv)
        nc = torch.where(fi, c_sh, 0.0) + torch.where(fip1, 0.0, c)
        c = torch.where(lane0, 1.0, nc)
    return v, c, emit


def _check_inputs(F, ts_rel, v, c):
    if F.dim() != 3:
        raise ValueError(f"fused_scan: F must be [H, n, S+1], got "
                         f"{tuple(F.shape)}")
    H, n, Sp1 = F.shape
    S = Sp1 - 1
    want = {"F": (H, n, S + 1), "ts_rel": (H, n), "v": (H, S), "c": (H, S)}
    for name, t in (("F", F), ("ts_rel", ts_rel), ("v", v), ("c", c)):
        if t.dtype != torch.float32:
            raise ValueError(f"fused_scan: {name} must be float32, got "
                             f"{t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"fused_scan: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"fused_scan: {name} must be contiguous")
        if t.device != F.device:
            raise ValueError("fused_scan: inputs lie on different devices")
    if not (2 <= S <= MAX_NODES and 1 <= H <= MAX_SLOTS
            and n >= 16 and n & (n - 1) == 0):
        raise ValueError(f"fused_scan: H={H}, n={n}, S={S} out of range "
                         f"(2 <= S <= {MAX_NODES}, H <= {MAX_SLOTS}, n a "
                         "power of two >= 16)")


def fused_scan(F, ts_rel, v, c):
    """One fused scan cycle: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  ``F [H, n, S+1]`` (0/1), ``ts_rel [H, n]``,
    ``v, c [H, S]``, all float32 and contiguous → ``(v', c', emit)``."""
    _check_inputs(F, ts_rel, v, c)
    dev = F.device
    if dev.type == "cpu":
        return fused_scan_plain(F, ts_rel, v, c)
    if dev.type != "cuda":
        raise ValueError(f"fused_scan: unsupported device {dev}")
    H, n, Sp1 = F.shape
    S = Sp1 - 1
    v_out = torch.empty_like(v)
    c_out = torch.empty_like(c)
    emit = torch.empty((H, n), dtype=torch.float32, device=dev)
    fn = build.entry("scan_chain", "scan_chain_launch")
    stream = torch.cuda.current_stream(dev.index).cuda_stream
    err = fn(F.data_ptr(), ts_rel.data_ptr(), v.data_ptr(), c.data_ptr(),
             v_out.data_ptr(), c_out.data_ptr(), emit.data_ptr(), H, n, S,
             stream)
    if err != 0:
        raise RuntimeError(f"scan_chain kernel launch failed: CUDA error {err}")
    fused_scan.launches += 1
    return v_out, c_out, emit


fused_scan.launches = 0
