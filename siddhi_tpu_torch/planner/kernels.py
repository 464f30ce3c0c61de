"""Gates for the port's kernels.

Port of the JAX package's ``planner/kernels.py``:

- ``check_dense_kernel_eligible``: the packed step is the port's only
  dense step so far, so there is no fallback: a pattern outside its
  class is refused with ``SiddhiAppCreationError``, naming the general
  dense step that a later slice of the port adds (ROADMAP.md).
- ``check_scan_kernel_available``: the hot-key scan's only step is the
  fused scan kernel; on a card it needs the probe to pass and raises
  otherwise.
- ``check_bank_kernel_available``: the same for the aggregation bank's
  segmented-reduce kernel (the reference's ``try_enable_bank_kernel``).

The reference's ``try_enable_*`` hooks swap a kernel in under
``@app:kernels`` and count a fallback to XLA when it cannot; the port
has no XLA path, always runs its kernels on the card and counts no
fallback.
"""

from __future__ import annotations

from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.kernels import probe

_LATER = ("; the port runs only the packed capture-free every-chain step "
          "so far — the general dense step is a later slice of the port")


def check_dense_kernel_eligible(engine) -> None:
    """The packed step covers the every-headed simple-chain class only
    (one candidate plane bit per row, no counting/capture machinery).
    Raises with a distinct reason outside it."""
    if engine.is_sequence:
        raise SiddhiAppCreationError(
            "nfa kernel: sequence semantics (strict contiguity masks) are "
            "not in the packed-plane step" + _LATER)
    if not engine.every_start:
        raise SiddhiAppCreationError(
            "nfa kernel: a non-every head needs reset-on-emit plane clears"
            + _LATER)
    if engine.group_every:
        raise SiddhiAppCreationError(
            "nfa kernel: grouped-every restart masks are not in the "
            "packed-plane step" + _LATER)
    if engine.has_deadlines:
        raise SiddhiAppCreationError(
            "nfa kernel: absent/deadline nodes need per-chain timers" + _LATER)
    for node in engine.nodes:
        if not (node.kind == "stream"
                and node.min_count == 1 and node.max_count == 1):
            raise SiddhiAppCreationError(
                "nfa kernel: counting/logical/absent nodes need the "
                "counts/register planes" + _LATER)
    if engine.alloc.slots:
        raise SiddhiAppCreationError(
            "nfa kernel: captured attributes need the register file" + _LATER)


def check_scan_kernel_available(scan) -> None:
    """The fused scan kernel builds and launches on the scan engine's
    card (the probe builds every kernel library, this one included);
    raises ``SiddhiAppCreationError`` with the reason if not.  CPU
    engines run the plain version and pass."""
    if scan.device.type == "cpu":
        return
    ok, reason = probe.kernels_available(scan.device)
    if not ok:
        raise SiddhiAppCreationError(f"scan kernel: {reason}")


def check_bank_kernel_available(bank) -> None:
    """The segmented-reduce kernel builds and launches on the bank's card
    (the probe builds every kernel library, this one included); raises
    ``SiddhiAppCreationError`` with the reason if not.  CPU banks run
    the plain version and pass."""
    if bank.device.type == "cpu":
        return
    ok, reason = probe.kernels_available(bank.device)
    if not ok:
        raise SiddhiAppCreationError(f"bank kernel: {reason}")
