"""host-sync-hazard: no stray synchronous device→host transfers.

The async emit pipeline's contract is that step outputs leave the
device ONLY through the sanctioned drain path (``core/emit_queue.py``
``fetch_coalesced`` / ``EmitQueue.drain``) or an explicit barrier
(snapshot/restore, timer steps).  An edit that sneaks a ``.item()`` /
``.tolist()`` / ``.cpu()`` onto the hot batch path re-introduces the
per-batch transfer stall the pipeline removed — and does so silently,
because results stay correct.

The port's materializers are eager PyTorch's:

- tensor methods ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``
  and ``.to("cpu")`` (a ``"cpu"`` first argument or ``device="cpu"``);
- ``torch.cuda.synchronize()``;
- ``np.asarray`` / ``np.array``, which copy a CPU tensor and refuse a
  CUDA one — on the card they stand for a ``.cpu()`` someone forgot.

A method call's receiver type is unknown statically, and the port's
host code calls ``.tolist()`` and ``.item()`` on numpy arrays too, so
the rule matches the method name on any receiver chain
(``self.state["x"].sum().item()`` included) and the host-side scopes
that call them on genuine numpy values are allowlisted by bucket in
``allowlists.py``: a NEW call site still trips the rule.

The rule scans the device runtime modules and reports every
materializing call whose enclosing function is not allowlisted.
``analysis/sync_guard.py`` holds the same contract dynamically on the
card (``torch.cuda.set_sync_debug_mode``), as the JAX package's
``jax.transfer_guard('disallow')`` does on its device.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from ..framework import Finding, Rule, register
from ..index import ModuleIndex

#: the modules owning device-resident state; everything else in the
#: package is host-side and free to use numpy
SCANNED = (
    "siddhi_tpu_torch/core/emit_queue.py",
    "siddhi_tpu_torch/core/device_single.py",
    "siddhi_tpu_torch/core/dense_pattern.py",
    "siddhi_tpu_torch/ops/device_query.py",
    "siddhi_tpu_torch/ops/dense_nfa.py",
    "siddhi_tpu_torch/parallel/device_shard.py",
    "siddhi_tpu_torch/parallel/mesh.py",
    "siddhi_tpu_torch/ops/fused_graph.py",
    "siddhi_tpu_torch/core/fused_graph.py",
    "siddhi_tpu_torch/ops/hotkey_scan.py",
    "siddhi_tpu_torch/core/hotkey_router.py",
    # durability: frozen device-tensor references may only materialize
    # through util.faults.host_copy (the injector-aware D2H choke point)
    # on the checkpoint writer thread — never inline under the barrier
    "siddhi_tpu_torch/durability/capture.py",
    "siddhi_tpu_torch/durability/writer.py",
    "siddhi_tpu_torch/durability/store.py",
    "siddhi_tpu_torch/durability/spill.py",
    # observability: span hooks ride the ingest/step/emit hot path —
    # they may timestamp and append to the ring, never materialize a
    # device tensor (a tracer that fetches would reintroduce the stall
    # it exists to measure)
    "siddhi_tpu_torch/observability/trace.py",
    "siddhi_tpu_torch/observability/recorder.py",
    "siddhi_tpu_torch/observability/histograms.py",
    "siddhi_tpu_torch/observability/prometheus.py",
    # CUDA kernel wrappers: the hottest device code in the tree — a
    # materialization inside a wrapper would sync every step
    "siddhi_tpu_torch/kernels/probe.py",
    "siddhi_tpu_torch/kernels/plane_pack.py",
    "siddhi_tpu_torch/kernels/bank_scatter.py",
    "siddhi_tpu_torch/kernels/scan_chain.py",
    "siddhi_tpu_torch/kernels/dense_step.py",
    "siddhi_tpu_torch/kernels/dense_batch.py",
    "siddhi_tpu_torch/kernels/build.py",
    # device tables: columnar device storage + join probes — mutations
    # may only touch the device through staged_put and leave it through
    # the count-gated fetch_coalesced drain (demotion rebuilds included)
    "siddhi_tpu_torch/devtable/__init__.py",
    "siddhi_tpu_torch/devtable/storage.py",
    "siddhi_tpu_torch/devtable/join.py",
    "siddhi_tpu_torch/devtable/planner.py",
)

#: dotted calls that materialize (or wait for) device values
MATERIALIZERS = {"np.asarray", "numpy.asarray", "np.array", "numpy.array",
                 "torch.cuda.synchronize"}

#: tensor methods that copy to the host, on any receiver chain
MATERIALIZING_METHODS = {"item", "tolist", "cpu", "numpy"}


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")`` as a literal."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and node.args and \
            isinstance(node.args[0], ast.Constant):
        return node.args[0].value == "cpu"
    return False


def materializer_name(index: ModuleIndex, call: ast.Call) -> Optional[str]:
    """How ``call`` materializes a device value, or None."""
    name = index.dotted(call.func)
    if name in MATERIALIZERS:
        return name
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr in MATERIALIZING_METHODS:
        return f".{f.attr}()"
    if f.attr == "to":
        dev = call.args[0] if call.args else next(
            (k.value for k in call.keywords if k.arg == "device"), None)
        if dev is not None and _is_cpu(dev):
            return '.to("cpu")'
    return None


@register
class HostSyncHazardRule(Rule):
    name = "host-sync-hazard"
    description = (
        "device→host materialization outside the sanctioned count-gated "
        "emit drain / barrier paths in the device runtime modules")

    def begin(self):
        self._seen: set = set()

    def check(self, index: ModuleIndex) -> Iterable[Finding]:
        if index.rel not in SCANNED:
            return
        self._seen.add(index.rel)
        for call in index.calls():
            name = materializer_name(index, call)
            if name is not None:
                yield Finding(
                    rule=self.name,
                    rel=index.rel,
                    line=call.lineno,
                    scope=index.qualname(call),
                    message=(
                        f"synchronous {name} outside the sanctioned "
                        "async-emit drain path — route it through the "
                        "runtime's EmitQueue, or allowlist it WITH a "
                        "bucket justification"),
                )

    def finish(self) -> Iterable[Finding]:
        out: List[Finding] = []
        for rel in SCANNED:
            if rel not in self._seen:
                out.append(Finding(
                    rule=self.name, rel=rel, line=0, scope="<module>",
                    message=("scanned-module list is stale: file moved "
                             "or was not analyzed"),
                    key=f"{rel}:<missing>"))
        return out
