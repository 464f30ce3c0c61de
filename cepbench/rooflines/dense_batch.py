"""Kernel 1 of the port, ``dense_batch_kernel`` (the dense batch step):
its device time from the traced sub-window, and the work of its batches
in bytes, for its roofline: what a batch must move at the least,
whatever the kernel's layout.

Per distinct key of a batch its state row is read and written once, at
the engine's pinned lane layout: ``S·I/8`` bytes of activity bits (one
bit a lane), ``S·I·4`` of int32 anchors and 4 of overflow (2,116 B at
S = 16, I = 32).  Per event 12 bytes are read: its state row, its time
and its value (int32, int32, float32).  The outputs are left out, so
the bound is a lower one.  No operation count: the step is a few
integer operations a lane, far below the card's rate, so bytes bound
it.
"""

import numpy as np

KERNEL = "dense_batch_kernel"
# NVIDIA H100 SXM, HBM3: the published peak (bytes a second)
PEAK_BYTES_S = 3.35e12
EVENT_BYTES = 12


def kernel_s(ctx):
    """The kernel's summed device seconds over the sub-window (matched
    by name in ``profile["by_name"]``), or None where it did not run."""
    p = ctx.get("profile")
    if not p or not p["batches"]:
        return None
    hits = [s for name, (s, _n) in p["by_name"].items() if KERNEL in name]
    return sum(hits) if hits else None


def row_bytes(S: int, I: int) -> int:
    """One key's state row at the pinned layout."""
    return S * I // 8 + S * I * 4 + 4


def batch_bytes(keys: np.ndarray, S: int, I: int) -> int:
    """The least bytes a batch with partition keys ``keys`` moves: each
    distinct key's row read and written, and each event read."""
    distinct = len(np.unique(np.asarray(keys)))
    return 2 * distinct * row_bytes(S, I) + EVENT_BYTES * len(keys)


def window_bytes(ctx) -> int:
    """The bytes of every batch of the traced sub-window, regenerated
    from the seed (``profile["first_batch"]`` to ``["next_batch"]``)."""
    p, config, traffic = ctx["profile"], ctx["config"], ctx["traffic"]
    S, I = int(config["sizes"]["states"]), int(config["sizes"]["lanes"])
    return sum(batch_bytes(traffic.batch(i)[0][config["key"]], S, I)
               for i in range(p["first_batch"], p["next_batch"]))
