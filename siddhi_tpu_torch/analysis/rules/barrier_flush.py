"""barrier-flush-completeness: barriers drain every queue they own.

The engine's correctness barriers — shutdown/stop teardown,
snapshot/restore/persist state capture, replan — all carry the same
implicit obligation: any **bounded** staging buffer the component owns
must be empty (or explicitly handed off) when the barrier completes,
or events are silently stranded behind it (the rung-survival and
stale-TableCache bug shape PRs kept fixing by hand).  This rule makes
the obligation checkable:

- the **queue registry** derives from the bounded-queue-discipline
  rule's construction-site scan: every ``self.<attr> = deque(maxlen=)``
  / ``Queue(maxsize=)`` in its scopes (``core/``, ``transport/``,
  ``robustness/``) registers ``(owner class, attr)``;
- the owner class's **barrier methods** (any method named ``stop``,
  ``shutdown``, ``close``, ``snapshot``, ``restore``, ``persist`` or
  ``replan``, MRO-resolved; empty SPI stubs skipped) must each reach a
  **flush** of every registered queue;
- "reach" is CFG reachability through the call graph: a statement only
  counts if its basic block is reachable from the barrier's entry (a
  flush parked after an early ``return`` does not), and the walk
  follows project-resolved callees (``resolve_call``) up to the same
  closure bound the other reachability rules use;
- a "flush" is a drain call on the queue (``get``/``get_nowait``/
  ``popleft``/``pop``/``clear``) or a rebind of the owning attribute —
  receiver chains are matched on the queue's attribute leaf after
  expanding single-assignment local aliases (``sp = self._spool``),
  which is also the rule's resolution limit: a queue drained through a
  differently-named alias handle needs an allowlist entry saying so.

Cross-class barriers compose modularly: ``SiddhiAppRuntime.shutdown``
calls ``junction.stop()`` / ``sink.shutdown()`` through dynamically
typed registries the call graph cannot resolve, but each owner's own
barrier is verified to flush its own queues, which is exactly the
obligation the runtime delegates.  Whole-program only.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from ..framework import Finding, Rule, register
from ..index import ModuleIndex
from ..locksets import get_model, shallow_calls
from ..project import plain_dotted
from .bounded_queues import _BOUNDED_CTORS, _SCOPES

_BARRIER_NAMES = ("stop", "shutdown", "close", "snapshot", "restore",
                  "persist", "replan")

_DRAIN_OPS = {"get", "get_nowait", "popleft", "pop", "clear"}

_MAX_DEFS = 200


def _bounded_ctor(value: ast.AST, index: ModuleIndex) -> bool:
    """RHS constructs a bounded queue (conditional ctors — ``X if cond
    else None`` — count via either arm)."""
    if isinstance(value, ast.IfExp):
        return _bounded_ctor(value.body, index) or \
            _bounded_ctor(value.orelse, index)
    if not isinstance(value, ast.Call):
        return False
    name = index.dotted(value.func)
    spec = _BOUNDED_CTORS.get(name)
    if spec is None:
        return False
    kwarg, pos = spec
    if any(kw.arg == kwarg for kw in value.keywords):
        return True
    return len(value.args) > pos


def _is_stub(fn: ast.AST) -> bool:
    """SPI placeholder bodies (``pass``/docstring/``...``/``raise
    NotImplementedError``) carry no flush obligation — overriders do."""
    for stmt in fn.body:
        if isinstance(stmt, ast.Pass):
            continue
        if isinstance(stmt, ast.Expr) and \
                isinstance(stmt.value, ast.Constant):
            continue
        if isinstance(stmt, ast.Raise):
            continue
        return False
    return True


@register
class BarrierFlushRule(Rule):
    name = "barrier-flush-completeness"
    description = (
        "a barrier method (stop/shutdown/snapshot/...) does not reach "
        "a flush of a bounded queue its class owns")

    def check(self, index: ModuleIndex) -> Iterable[Finding]:
        return ()  # whole-program only

    def finish(self) -> Iterable[Finding]:
        if self.project is None:
            return ()
        model = get_model(self.project)
        findings: List[Finding] = []
        for fq_class in sorted(self.project.classes):
            idx, cls = self.project.classes[fq_class]
            if not idx.rel.startswith(_SCOPES):
                continue
            queues = self._owned_queues(idx, cls)
            if not queues:
                continue
            cls_qual = idx.def_qualname(cls)
            methods = self.project.class_methods(fq_class)
            barriers = [
                (n,) + methods[n] for n in _BARRIER_NAMES
                if n in methods and not _is_stub(methods[n][1])]
            if not barriers:
                for attr, line in queues:
                    findings.append(Finding(
                        rule=self.name,
                        rel=idx.rel,
                        line=line,
                        scope=f"{cls_qual}.{attr}",
                        message=(
                            f"'{cls_qual}' owns bounded queue "
                            f"'{attr}' but declares no barrier method "
                            f"({'/'.join(_BARRIER_NAMES)}) that could "
                            "flush it — add a teardown path, or "
                            "allowlist with a justification"),
                    ))
                continue
            for bname, b_idx, b_fn, _owner in barriers:
                flushed = self._flushed_attrs(model, b_idx, b_fn)
                for attr, line in queues:
                    if attr in flushed:
                        continue
                    findings.append(Finding(
                        rule=self.name,
                        rel=idx.rel,
                        line=line,
                        scope=f"{cls_qual}.{bname}:{attr}",
                        message=(
                            f"barrier '{cls_qual}.{bname}' never "
                            f"reaches a flush of bounded queue "
                            f"'{attr}' (no reachable "
                            f"{'/'.join(sorted(_DRAIN_OPS))} or rebind "
                            "through the call graph) — drain it on "
                            "this path, or allowlist with a "
                            "justification"),
                    ))
        return findings

    # -- registry ------------------------------------------------------------

    def _owned_queues(self, idx: ModuleIndex, cls: ast.ClassDef
                      ) -> List[Tuple[str, int]]:
        out = []
        seen: Set[str] = set()
        for node in ast.walk(cls):
            if not isinstance(node, ast.Assign):
                continue
            if not _bounded_ctor(node.value, idx):
                continue
            for t in node.targets:
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id in ("self", "cls") and \
                        t.attr not in seen:
                    seen.add(t.attr)
                    out.append((t.attr, node.lineno))
        return out

    # -- reachability --------------------------------------------------------

    def _flushed_attrs(self, model, idx: ModuleIndex, root: ast.AST
                       ) -> Set[str]:
        """Queue-attribute leaves drained on some CFG-reachable path
        from ``root``, following resolved callees."""
        flushed: Set[str] = set()
        work: List[Tuple[ModuleIndex, ast.AST]] = [(idx, root)]
        seen: Set[int] = set()
        while work and len(seen) < _MAX_DEFS:
            f_idx, fn = work.pop()
            if id(fn) in seen:
                continue
            seen.add(id(fn))
            try:
                cfg = model.cfg_of(fn)
            except (TypeError, SyntaxError):  # pragma: no cover
                continue
            live = cfg.reachable()
            aliases = model.aliases_of(f_idx, fn)
            for block in cfg.blocks:
                if block.bid not in live:
                    continue
                for stmt in block.stmts:
                    self._scan_stmt(f_idx, stmt, aliases, flushed, work)
        return flushed

    def _scan_stmt(self, idx: ModuleIndex, stmt, aliases,
                   flushed: Set[str], work):
        # rebinding the attribute is a flush (restore-style barriers)
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id in ("self", "cls"):
                    flushed.add(t.attr)
        for call in shallow_calls(stmt):
            func = call.func
            if isinstance(func, ast.Attribute) and \
                    func.attr in _DRAIN_OPS:
                leaf = self._receiver_leaf(func.value, aliases)
                if leaf is not None:
                    flushed.add(leaf)
                continue
            hit = self.project.resolve_call(idx, call)
            if hit is not None:
                work.append((hit[0], hit[1]))

    @staticmethod
    def _receiver_leaf(value: ast.AST, aliases) -> str:
        """Last attribute component of the drain receiver, aliases
        expanded (``sp`` -> ``self._spool`` -> ``_spool``)."""
        p = plain_dotted(value)
        if p is None:
            return None
        parts = p.split(".")
        if parts[0] in aliases:
            parts = aliases[parts[0]].split(".") + parts[1:]
        leaf = parts[-1]
        if leaf in ("self", "cls"):
            return None
        return leaf
