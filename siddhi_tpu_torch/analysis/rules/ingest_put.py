"""ingest-put-bypass: every ingest-path H2D transfer goes through staging.

The ingest pipeline's contract is that host→device puts of BATCH data
happen ONLY through ``core/ingest_stage.py`` ``staged_put`` (and its
leaf copier ``_put``) — the one wrapper that arms the ``ingest.put``
fault-injection site (bounded retry-with-backoff, crash-journal
semantics) and counts ``IngestStats.device_puts``.  A direct put on a
batch path silently bypasses both the fault harness and the staging
counters: chaos runs stop covering that transfer and the overlap
evidence under-reports.

The port's put forms are eager PyTorch's, on any receiver chain:

- ``.to(<device>)`` — a first argument that is neither ``"cpu"`` nor a
  dtype (``torch.int32``, ``x.dtype``), or a ``device=`` keyword other
  than ``"cpu"``;
- ``.cuda()``;
- ``torch.as_tensor(..., device=)`` / ``torch.tensor(..., device=)``;
- ``.copy_(<host>)`` — an in-place copy from a value built on the host
  (``torch.from_numpy``, ``torch.as_tensor``/``torch.tensor`` without a
  device, ``np.*``).

Allocations with ``device=`` (``torch.zeros``, ``full``, ``empty``,
``arange``...) create on the device and move no host data: they are not
transfers.  The rule scans the whole package and reports every put
whose enclosing function is not allowlisted (buckets: staging / mesh /
state, see ``allowlists.py``).
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Optional

from ..framework import Finding, Rule, register
from ..index import ModuleIndex, dotted_name
from .host_sync import _is_cpu

#: leaves of a ``.to()`` argument that name a dtype, not a device
_DTYPES = {
    "bool", "uint8", "int8", "int16", "int32", "int64", "long", "int",
    "float16", "half", "bfloat16", "float32", "float", "float64",
    "double", "uint16", "uint32", "uint64", "complex64", "complex128"}
_DTYPE_ALIAS_RE = re.compile(r"^_?(?:[fiu](?:8|16|32|64)|bf16)$", re.I)
_TENSOR_CTORS = {"torch.as_tensor", "torch.tensor"}
_HOST_BUILDERS = {"torch.from_numpy", "torch.as_tensor", "torch.tensor"}


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    return next((k.value for k in call.keywords if k.arg == name), None)


def _is_dtype(node: ast.AST) -> bool:
    """``torch.int32``, ``x.dtype``, or a dtype alias (``i32``, ``_F32``)."""
    name = dotted_name(node)
    if name is None:
        return False
    leaf = name.split(".")[-1]
    return leaf in _DTYPES or "dtype" in leaf.lower() or \
        _DTYPE_ALIAS_RE.match(leaf) is not None


def _is_host_value(node: ast.AST) -> bool:
    """A value built on the host: ``torch.from_numpy(...)``, a tensor
    constructor without a device, or any ``np.*`` call."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func) or ""
    if name in _HOST_BUILDERS:
        return _kw(node, "device") is None
    return name.split(".")[0] in ("np", "numpy")


def put_form(index: ModuleIndex, call: ast.Call) -> Optional[str]:
    """How ``call`` puts host data on a device, or None."""
    name = index.dotted(call.func)
    if name in _TENSOR_CTORS:
        dev = _kw(call, "device")
        return f"{name}(device=)" if dev is not None and \
            not _is_cpu(dev) else None
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr == "cuda":
        return ".cuda()"
    if f.attr == "to":
        dev = _kw(call, "device")
        if dev is None and call.args:
            dev = call.args[0]
            if _is_dtype(dev) or isinstance(dev, ast.Constant) and \
                    dev.value is None:
                return None
        return ".to(<device>)" if dev is not None and \
            not _is_cpu(dev) else None
    if f.attr == "copy_" and call.args and _is_host_value(call.args[0]):
        return ".copy_(<host>)"
    return None


@register
class IngestPutBypassRule(Rule):
    name = "ingest-put-bypass"
    description = (
        "direct host→device put outside the sanctioned staging/mesh/state "
        "sites — batch ingest must go through core/ingest_stage.staged_put")

    def check(self, index: ModuleIndex) -> Iterable[Finding]:
        for call in index.calls():
            form = put_form(index, call)
            if form is not None:
                yield Finding(
                    rule=self.name,
                    rel=index.rel,
                    line=call.lineno,
                    scope=index.qualname(call),
                    message=(
                        f"direct {form} — route batch ingest through "
                        "core/ingest_stage.staged_put (fault site + "
                        "counters), or allowlist it WITH a bucket "
                        "justification"),
                )
