"""fallback-discipline: graceful fallbacks are logged AND counted.

The planner's contract since the sharded/fused/kernel work: when an
eligibility gate rejects a query — ``SiddhiAppCreationError`` raised by
a probe, the dense/device/multiplex path declined — the engine falls
back silently in terms of RESULTS but never in terms of OBSERVABILITY.
Every such gate must reach, on the fallback path, both

1. a ``log.warning`` (or ``error``/``exception``/``critical``) — the
   user asked for an accelerated path and is not getting it, which must
   be visible in the log; ``log.info`` does not satisfy the contract —
   fallbacks are warnings by definition; and
2. a counted stats write — a ``record_*_fallback(...)`` call on the
   ``StatisticsManager`` (which maintains the ``*Fallbacks`` /
   ``*FallbackReason`` feed keys served over REST), or a direct
   ``*fallback*`` counter write.

The rule anchors on ``except SiddhiAppCreationError`` handlers (the
engine's single fallback currency) and checks both obligations over
the calls **reachable** from the handler through the project call
graph — the planner's habit of delegating to ``self._fallback(...)``
or a module helper two files away is followed, not guessed at.
Handlers that re-raise are exempt: propagating the error is the
other legitimate response to a failed gate.

Without a ``ProjectIndex`` only the handler's lexical body is
searched (fixture mode).  Handlers that delegate through edges the
call graph cannot resolve (callbacks passed as parameters) belong in
the allowlist with a justification naming where the logging/counting
actually happens.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Set, Tuple

from ..framework import Finding, Rule, register
from ..index import ModuleIndex

_EXC_NAME = "SiddhiAppCreationError"
_LOG_METHODS = {"warning", "error", "exception", "critical"}
_COUNTER_RE = re.compile(r"^record_\w*fallback\w*$")
_FALLBACK_SEG_RE = re.compile(r"fallback", re.IGNORECASE)


def _handler_catches(handler: ast.ExceptHandler) -> bool:
    """Does the handler type mention SiddhiAppCreationError?"""
    t = handler.type
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    for node in types:
        if isinstance(node, ast.Name) and node.id == _EXC_NAME:
            return True
        if isinstance(node, ast.Attribute) and node.attr == _EXC_NAME:
            return True
    return False


def _reraises(handler: ast.ExceptHandler) -> bool:
    return any(isinstance(n, ast.Raise) for n in ast.walk(handler))


def _is_log_call(call: ast.Call) -> bool:
    """`.warning()/.error()/...` on any receiver — including the
    chained ``logging.getLogger(...).warning(...)`` form."""
    return (isinstance(call.func, ast.Attribute)
            and call.func.attr in _LOG_METHODS)


def _is_counter_call(call: ast.Call) -> bool:
    func = call.func
    leaf = func.attr if isinstance(func, ast.Attribute) else (
        func.id if isinstance(func, ast.Name) else None)
    return leaf is not None and _COUNTER_RE.match(leaf) is not None


def _counter_writes(index: ModuleIndex, node: ast.AST) -> bool:
    """Direct ``*.somethingFallback* = / += `` counter writes."""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Assign, ast.AugAssign)):
            targets = (sub.targets if isinstance(sub, ast.Assign)
                       else [sub.target])
            for t in targets:
                name = index.dotted(t) if isinstance(
                    t, (ast.Attribute, ast.Name)) else None
                if name and any(_FALLBACK_SEG_RE.search(seg)
                                for seg in name.split(".")):
                    return True
    return False


@register
class FallbackDisciplineRule(Rule):
    name = "fallback-discipline"
    description = (
        "except SiddhiAppCreationError fallback gate that does not reach "
        "both a log.warning and a counted record_*_fallback stats write")

    def check(self, index: ModuleIndex) -> Iterable[Finding]:
        seen: Set[Tuple[str, str]] = set()
        for node in ast.walk(index.tree):
            if not isinstance(node, ast.ExceptHandler) or \
                    not _handler_catches(node):
                continue
            if _reraises(node):
                continue  # propagating the gate failure is fine
            logged, counted = self._obligations(index, node)
            if logged and counted:
                continue
            missing = []
            if not logged:
                missing.append("no log.warning")
            if not counted:
                missing.append("no record_*_fallback stats write")
            scope = index.qualname(node)
            key = (scope, ", ".join(missing))
            if key in seen:
                continue
            seen.add(key)
            yield Finding(
                rule=self.name,
                rel=index.rel,
                line=node.lineno,
                scope=scope,
                message=(
                    f"fallback gate ({', '.join(missing)} reachable from "
                    "the handler) — a declined accelerated path must be "
                    "both visible in the log and counted on the "
                    "statistics feed, or allowlisted with a "
                    "justification naming where that happens"),
            )

    def _obligations(self, index: ModuleIndex,
                     handler: ast.ExceptHandler) -> Tuple[bool, bool]:
        logged = counted = False
        if self.project is not None:
            calls = self.project.iter_calls_reachable(index, [handler])
        else:
            calls = ((index, c) for c in ast.walk(handler)
                     if isinstance(c, ast.Call))
        for c_idx, call in calls:
            if _is_log_call(call):
                logged = True
            if _is_counter_call(call):
                counted = True
            if logged and counted:
                return True, True
        if not counted:
            counted = _counter_writes(index, handler)
        return logged, counted
