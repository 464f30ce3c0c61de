"""Structural query fingerprints for multiplex grouping.

Port of the JAX package's ``multiplex/fingerprint.py``.

Two queries may share one device engine iff compiling either of them
would produce exactly the same device steps: same pattern skeleton /
window kind + size, same filter tree (constants included — they are
baked into the compiled expression), same aggregator set and output
lanes, same input stream attribute layout (names, types → dtype
lanes), and the same engine-shaping knobs (partitions / instances /
slot count).  The fingerprint is a sha256 over a canonical recursive
encoding of those parts; equality of fingerprints is the grouping key.

What is deliberately EXCLUDED so distinct apps can still group:
query name, app name, ``@info``/other annotations, and the output
stream TARGET (each tenant keeps its own output stream + callbacks;
only the output ``event_type`` shapes the engine).

The port's ``query_api`` keeps the reference's class and field names, so
a query's digest here equals the reference's for the same text.

The query_api tree is all plain dataclasses (``query_api/execution.py``,
``query_api/expression.py``) with no volatile derived fields stored, so
a ``dataclasses.fields()`` walk is canonical by construction.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
from typing import Iterable, Optional

from siddhi_tpu_torch.query_api.execution import Query
from siddhi_tpu_torch.query_api.expression import FunctionCall

# Builtins whose compiled value depends on the engine's private time
# anchor or the host clock at evaluation time (planner/expr.py lowers
# eventTimestamp() to the RELATIVE device timestamp lane, which is
# measured against the engine's base_ts — a shared group anchor would
# change the values a tenant observes vs its dedicated engine).
_CLOCK_FNS = frozenset({"eventTimestamp", "currentTimeMillis"})


def _canon(node):
    """Canonical JSON-encodable form of a query_api subtree."""
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    if isinstance(node, enum.Enum):
        return [type(node).__name__, node.name]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [
            type(node).__name__,
            [
                [f.name, _canon(getattr(node, f.name))]
                for f in dataclasses.fields(node)
                if f.name != "annotations"
            ],
        ]
    if isinstance(node, (list, tuple)):
        return [_canon(x) for x in node]
    if isinstance(node, dict):
        return [[_canon(k), _canon(v)] for k, v in sorted(node.items(), key=repr)]
    # Unknown leaf (should not happen for query_api trees): fall back to
    # a type-tagged repr so it at least hashes deterministically.
    return [type(node).__name__, repr(node)]


def query_fingerprint(query: Query, definitions, knobs: dict) -> str:
    """sha256 hex fingerprint of ``query``'s engine-relevant shape.

    ``definitions`` is an iterable of the resolved input
    ``StreamDefinition`` objects (attribute names + types fix the dtype
    lanes); ``knobs`` carries the engine-shaping app knobs
    (partitions / instances / multiplex slots).
    """
    payload = {
        "input": _canon(query.input_stream),
        "selector": _canon(query.selector),
        "out_event_type": getattr(query.output_stream, "event_type", "current"),
        "defs": [_canon(d) for d in definitions],
        "knobs": sorted((str(k), str(v)) for k, v in knobs.items()),
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def reads_clock(node) -> Optional[str]:
    """Name of the first clock/anchor-reading builtin in the tree, or None.

    Expressions calling these cannot multiplex: their compiled value is
    relative to the engine's private ``base_ts`` anchor (or the host
    clock), which a shared group engine does not preserve per tenant.
    """
    if isinstance(node, FunctionCall) and node.name in _CLOCK_FNS:
        return node.name
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        it: Iterable = (
            getattr(node, f.name)
            for f in dataclasses.fields(node)
            if f.name != "annotations"
        )
    elif isinstance(node, (list, tuple)):
        it = node
    else:
        return None
    for child in it:
        hit = reads_clock(child)
        if hit is not None:
            return hit
    return None
