#!/usr/bin/env python3
"""Times the fused hot-key scan kernel over slots, events and chain length.

    python3 scan_sweep.py

Needs one CUDA card.  For each shape (H slots, n events a slot, S chain
nodes) it holds ``kernels.scan_chain.fused_scan`` bit for bit against
``fused_scan_plain`` on ``chip_smoke.py``'s seeded inputs and prints one
JSON line with the kernel's times (``ms`` by CUDA events, ``host_us``,
``device_us`` under ``torch.profiler``) and its byte bound.  With one
block a slot, H = 66 and 132 leave each block an SM of its own, which
separates a block's own path from the card's memory rate; S and n set
the number of lane scans and tiles a block walks.  The card's name and
power limit come first.
"""

from __future__ import annotations

import json
import sys

import chip_smoke as cs

SHAPES = ((8, 2048, 2), (66, 4096, 32), (132, 4096, 32), (256, 4096, 32),
          (132, 2048, 32), (132, 8192, 32), (132, 4096, 2), (132, 4096, 8),
          (132, 4096, 16))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("scan_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    from siddhi_tpu_torch.kernels import scan_chain

    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    for H, n, S in SHAPES:
        ins = cs.scan_inputs(torch, H, n, S, seed=H * n + S, device=dev)
        got = scan_chain.fused_scan(*ins)
        want = scan_chain.fused_scan_plain(*ins)
        torch.cuda.synchronize()
        if not cs.bits_equal(torch, got, want):
            raise AssertionError(f"scan_chain differs at H={H}, n={n}, S={S}")
        print(json.dumps({
            "H": H, "n": n, "S": S, "bit_exact": True,
            **cs.call_times(torch, lambda: scan_chain.fused_scan(*ins), 50, 10),
            **cs.scan_bound(H, n, S)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
