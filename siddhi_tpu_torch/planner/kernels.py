"""Step routing and gates for the port's kernels.

Port of the JAX package's ``planner/kernels.py``:

- ``route_dense_step``: picks each dense engine's step at compile time,
  by class.  A capture-free ``every`` chain of plain stream nodes with
  at most 32 instance lanes and no reset on emit runs the batch-step
  kernel (``kernels/dense_batch.py``, one launch a batch); every other
  pattern the dense engine takes (captures and the register file,
  counts and Kleene closures, logical ``and``/``or`` nodes, sequences,
  non-every heads, whole-chain group-every, absent nodes and ``and
  not`` sides with their deadline timers, more lanes, reset on emit)
  takes the general step in torch ops (``ops/dense_nfa.py``
  ``make_general_step``, and ``make_time_step`` for the deadlines).
  That is a plan-time choice, never a fallback.  The shapes the
  reference itself sends to its host engine are refused earlier, by
  the engine's constructor.
- ``check_scan_kernel_available``: the hot-key scan's only step is the
  fused scan kernel; on a card it needs the probe to pass and raises
  otherwise.
- ``check_bank_kernel_available``: the same for the aggregation bank's
  segmented-reduce kernel (the reference's ``try_enable_bank_kernel``).

The reference's ``try_enable_*`` hooks swap a kernel in under
``@app:kernels`` and count a fallback to XLA when it cannot; the port
always runs its kernels on the card and counts no fallback, and its
degradation ladder has no ``kernels`` rung (``robustness/ladder.py``).
"""

from __future__ import annotations

from siddhi_tpu_torch.core.exceptions import KernelUnavailableError
from siddhi_tpu_torch.kernels import probe
from siddhi_tpu_torch.kernels.dense_batch import MAX_INSTANCES


def route_dense_step(engine) -> str:
    """``"batch"`` or ``"general"``: the step that runs ``engine``.

    The batch step takes capture-free every-chains of plain stream nodes
    (one filter bit per node and event, no register file, no counts)
    with at most ``dense_batch.MAX_INSTANCES`` lanes, the standing
    virgin at node 0 and no reset on emit; the general step takes
    everything else the engine admits, absent nodes and sides
    included."""
    plain = all(node.kind == "stream" and node.min_count == 1
                and node.max_count == 1 for node in engine.nodes)
    if (plain and engine.every_start and not engine.group_every
            and not engine.is_sequence and not engine.alloc.slots
            and not engine.reset_on_emit and engine.I <= MAX_INSTANCES):
        return "batch"
    return "general"


def check_scan_kernel_available(scan) -> None:
    """The fused scan kernel builds and launches on the scan engine's
    card (the probe builds every kernel library, this one included);
    raises ``KernelUnavailableError`` with the reason if not.  CPU
    engines run the plain version and pass."""
    if scan.device.type == "cpu":
        return
    ok, reason = probe.kernels_available(scan.device)
    if not ok:
        raise KernelUnavailableError(f"scan kernel: {reason}")


def check_bank_kernel_available(bank) -> None:
    """The segmented-reduce kernel builds and launches on the bank's card
    (the probe builds every kernel library, this one included); raises
    ``KernelUnavailableError`` with the reason if not.  CPU banks run
    the plain version and pass."""
    if bank.device.type == "cpu":
        return
    ok, reason = probe.kernels_available(bank.device)
    if not ok:
        raise KernelUnavailableError(f"bank kernel: {reason}")
