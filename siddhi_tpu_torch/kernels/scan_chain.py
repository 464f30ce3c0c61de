"""Fused hot-key scan: the max-plus and counting chains in one pass.

Port of the JAX package's ``kernels/scan_chain.py``.  For each hot-key
slot ``h`` the scan walks that slot's ``n`` events in order, carrying
the ``[S]`` youngest-start vector ``v`` (max-plus) and the ``[S]``
pending-chain count vector ``c``.  Event ``e`` emits ``c[S-1]`` copies
when its final-node filter ``F[e, S]`` holds and lane ``S-1`` is live
(``v[S-1] > NEG/2``), read from the vectors BEFORE the event's update.
Lane 0 is the constant lane (v = 0, c = 1).

Two pieces:

- ``csrc/scan_chain.cu``: the CUDA kernel, launched by ``fused_scan``
  for CUDA tensors.  It replaces the Pallas kernel
  ``siddhi_tpu/kernels/scan_chain.py`` (``_build`` via ``fused_scan``).
  Lanes in order, events in parallel: one block a slot, each thread
  ``kE = 16`` consecutive events of a tile of up to 2,048; lane ``i``
  given lane ``i-1``'s pre-update values is a segmented max-scan and a
  segmented sum-scan, done as one block-wide scan a lane, each lane's
  value carried from tile to tile.  Bound on the H100: the bytes (F,
  ts and emit once: 0.33 MB at H=8, n=2048, S=2; 147 MB, 44 us at
  3.35 TB/s, at H=256, n=4096, S=32).  ``fused_scan.launches`` counts
  its launches.
- ``fused_scan_plain``: a torch loop over ``n``, vectorized over
  ``[H, S]``, transcribing the Pallas body.  ``fused_scan`` uses it for
  CPU tensors only; ``chip_smoke.py`` holds the kernel against it.

The plain version does the Pallas body's float32 operations in the same
order, so it agrees with the Pallas kernel bit for bit on every lane,
dead lanes included.  The kernel evaluates the same recurrence in tree
order and agrees with both bit for bit on the engine's domain: ``F`` in
{0, 1}; ``ts`` finite, no -0.0, below 2^24; live ``v`` finite, no
-0.0, below 2^24 in magnitude; dead ``v`` finite and <= NEG/2; ``c``
integer-valued in [0, 2^24), with every count the walk reaches below
2^24.  The engine stays there: each step floors at NEG and ``rebase``
keeps relative times small.  There max is an exact selection, ``NEG +
x == NEG`` for every live ``x``, and counts are exact integer sums in
any order.  NaN lies outside: the sequential body keeps a NaN on its
lane for good (``NEG + NaN``), the kernel drops it at the lane's next
reset (``F[e, i+1]``); ``tests/test_torch_cuda.py`` pins what it does.
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
    # the kernel reads F and ts as 16-byte vectors; a fresh allocation is
    # aligned, a view into one may not be
    F, ts_rel = (t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (F, ts_rel))
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
