"""broad-except-swallow: no fault may vanish without a log line or counter.

The fault-injection work replaced every silent ``except Exception:
pass`` swallow on the processing path with handlers that log, count, or
route through the @OnError machinery.  This rule scans
``siddhi_tpu_torch/core/`` and ``siddhi_tpu_torch/transport/`` (the layers events
and faults actually traverse) and reports a handler catching
``Exception`` (or a bare ``except:``) whose body is only ``pass``/a
constant — the signature of a fault disappearing without trace.

Narrow handlers (``except queue.Empty: pass``) are fine: swallowing a
SPECIFIC expected condition is control flow, not fault masking.  A
genuinely sanctioned broad swallow goes in the allowlist with a
justification — the rule keeps the decision visible in review.
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..framework import Finding, Rule, register
from ..index import ModuleIndex

SCANNED_DIRS = ("siddhi_tpu_torch/core/", "siddhi_tpu_torch/transport/",
                "siddhi_tpu_torch/durability/", "siddhi_tpu_torch/observability/",
                "siddhi_tpu_torch/kernels/", "siddhi_tpu_torch/devtable/")

BROAD = {"Exception", "BaseException"}


def is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:  # bare `except:`
        return True
    if isinstance(t, ast.Name):
        return t.id in BROAD
    if isinstance(t, ast.Tuple):
        return any(isinstance(e, ast.Name) and e.id in BROAD for e in t.elts)
    return False


def is_silent(handler: ast.ExceptHandler) -> bool:
    return all(
        isinstance(s, ast.Pass)
        or (isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant))
        for s in handler.body)


@register
class BroadExceptSwallowRule(Rule):
    name = "broad-except-swallow"
    description = (
        "silent `except Exception: pass` on the processing path — faults "
        "must leave a log line, a counter, or an @OnError route")

    def check(self, index: ModuleIndex) -> Iterable[Finding]:
        if not index.rel.startswith(SCANNED_DIRS):
            return
        for node in ast.walk(index.tree):
            if isinstance(node, ast.ExceptHandler) and is_broad(node) \
                    and is_silent(node):
                yield Finding(
                    rule=self.name,
                    rel=index.rel,
                    line=node.lineno,
                    scope=index.qualname(node),
                    message=(
                        "silent broad except — faults must leave a log "
                        "line, a counter, or an @OnError route (or be "
                        "allowlisted with a justification)"),
                )
