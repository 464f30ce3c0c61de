"""bounded-queue-discipline: hot-path buffers carry an explicit bound.

An unbounded queue between a producer and a slower consumer is the
canonical overload failure: memory grows until the process dies,
usually long after the real problem started.  The engine's ingest and
transport layers (``core/``, ``transport/``, ``robustness/``) are
exactly where load arrives faster than it drains — every buffer there
must state its bound at the construction site:

- ``collections.deque(...)`` needs a ``maxlen=`` keyword (or the
  second positional argument) that is not the literal ``None``;
- ``queue.Queue`` / ``LifoQueue`` / ``PriorityQueue`` need a
  ``maxsize=`` keyword (or the first positional argument) that is not
  the literal ``0`` or ``None`` — 0 is the stdlib's spelling of
  "infinite";
- ``queue.SimpleQueue`` is unbounded by construction and is always a
  finding.

A bound passed as a variable or expression is accepted: the rule
enforces that a bound was CHOSEN, not what its value is.  Buffers that
are genuinely unbounded by design belong in the allowlist with a
justification (analysis/allowlists.py).
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..framework import Finding, Rule, register
from ..index import ModuleIndex

_SCOPES = ("siddhi_tpu_torch/core/", "siddhi_tpu_torch/transport/",
           "siddhi_tpu_torch/robustness/")

#: ctor dotted name -> (bound kwarg, positional index of the bound)
_BOUNDED_CTORS = {
    "deque": ("maxlen", 1),
    "collections.deque": ("maxlen", 1),
    "queue.Queue": ("maxsize", 0),
    "Queue": ("maxsize", 0),
    "queue.LifoQueue": ("maxsize", 0),
    "LifoQueue": ("maxsize", 0),
    "queue.PriorityQueue": ("maxsize", 0),
    "PriorityQueue": ("maxsize", 0),
}

_ALWAYS_UNBOUNDED = {"queue.SimpleQueue", "SimpleQueue"}


def _is_unbounded_literal(node: ast.AST) -> bool:
    """The stdlib's 'no limit' spellings: ``None`` (deque) / ``0``
    (queue.Queue family)."""
    return isinstance(node, ast.Constant) and (
        node.value is None or node.value == 0)


@register
class BoundedQueueRule(Rule):
    name = "bounded-queue-discipline"
    description = (
        "deque/Queue in core/, transport/ or robustness/ without an "
        "explicit bound (maxlen=/maxsize=)")

    def check(self, index: ModuleIndex) -> Iterable[Finding]:
        if not index.rel.startswith(_SCOPES):
            return
        for site in index.calls():
            name = index.dotted(site.func)
            if name in _ALWAYS_UNBOUNDED:
                yield self._finding(
                    index, site,
                    f"{name}() is unbounded by construction — use "
                    "queue.Queue(maxsize=N), or allowlist with a "
                    "justification")
                continue
            spec = _BOUNDED_CTORS.get(name)
            if spec is None:
                continue
            kwarg, pos = spec
            bound = None
            for kw in site.keywords:
                if kw.arg == kwarg:
                    bound = kw.value
                    break
            if bound is None and len(site.args) > pos:
                bound = site.args[pos]
            if bound is not None and not _is_unbounded_literal(bound):
                continue
            yield self._finding(
                index, site,
                f"{name}() without an explicit bound — pass "
                f"{kwarg}=N at the construction site (ingest/transport "
                "buffers must not grow without limit under overload), "
                "or allowlist with a justification")

    def _finding(self, index: ModuleIndex, site: ast.Call,
                 message: str) -> Finding:
        return Finding(
            rule=self.name,
            rel=index.rel,
            line=site.lineno,
            scope=index.qualname(site),
            message=message,
        )
