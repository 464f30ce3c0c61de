"""thread-lifecycle: every Thread/Timer is daemon or joined.

A non-daemon thread that nobody joins keeps the interpreter alive after
``shutdown()`` — the engine appears to exit and hangs in atexit; a
joined-nowhere ``threading.Timer`` re-arms forever.  The engine's
convention is explicit on every spawn site: either the thread is marked
``daemon=True`` (the junction worker, the scheduler, the stats
reporter, the persist daemon, the reconnect Timer chain), or the owner
class joins/cancels it on a shutdown path (the checkpoint writer's
``stop()``).

Per ``threading.Thread(...)`` / ``threading.Timer(...)`` construction
site the rule accepts any of:

- ``daemon=True`` passed to the constructor;
- ``<obj>.daemon = True`` / ``<obj>.setDaemon(True)`` on the
  constructed object (local name or ``self.<attr>``) in the same
  function;
- the object is stored into ``self.<attr>`` and SOME method of the
  owner class calls ``self.<attr>.join()`` or ``self.<attr>.cancel()``
  — the shutdown path.  With a ``ProjectIndex`` the method search runs
  over the MRO-merged method table, so a mixin's Timer joined by the
  subclass's ``shutdown()`` (or vice versa) resolves; without one, only
  the lexical class body is searched;
- a purely local object that is ``join()``ed / ``cancel()``ed in the
  same function (scoped worker pools).

Anything else is a finding on the construction site.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional, Tuple

from ..framework import Finding, Rule, register
from ..index import ModuleIndex

_CTORS = {"threading.Thread", "Thread", "threading.Timer", "Timer"}
_RELEASERS = {"join", "cancel"}


def _is_true(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _binding_of(index: ModuleIndex, site: ast.Call
                ) -> Tuple[Optional[str], Optional[str]]:
    """(local name, self attr) the constructed object is bound to —
    either may be None."""
    local = attr = None
    for anc in index.ancestors(site):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            break
        if isinstance(anc, ast.Assign):
            for t in anc.targets:
                if isinstance(t, ast.Name):
                    local = t.id
                elif isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id in ("self", "cls"):
                    attr = t.attr
            break
    return local, attr


def _released_in(index: ModuleIndex, fn: ast.AST, receiver: str) -> bool:
    """``<receiver>.join()`` / ``.cancel()`` / ``.daemon = True`` /
    ``.setDaemon(True)`` anywhere in ``fn`` — receiver is a dotted
    string like ``t`` or ``self._timer`` (self elided by dotted())."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute):
            recv = index.dotted(node.func.value)
            if recv != receiver:
                continue
            if node.func.attr in _RELEASERS:
                return True
            if node.func.attr == "setDaemon" and node.args and \
                    _is_true(node.args[0]):
                return True
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and t.attr == "daemon" \
                        and index.dotted(t.value) == receiver and \
                        _is_true(node.value):
                    return True
    return False


@register
class ThreadLifecycleRule(Rule):
    name = "thread-lifecycle"
    description = (
        "Thread/Timer that is neither daemon nor joined/cancelled on a "
        "shutdown path of its owner class")

    def check(self, index: ModuleIndex) -> Iterable[Finding]:
        for site in index.calls():
            if index.dotted(site.func) not in _CTORS:
                continue
            if any(_is_true(kw.value) for kw in site.keywords
                   if kw.arg == "daemon"):
                continue
            fn = index.enclosing(site, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))
            local, attr = _binding_of(index, site)
            handled = False
            if fn is not None and local is not None and \
                    _released_in(index, fn, local):
                handled = True
            if not handled and attr is not None:
                # dotted() elides the leading self, so the receiver of
                # a `self.<attr>.join()` is just `<attr>`
                handled = self._owner_releases(index, site, attr)
            if handled:
                continue
            yield Finding(
                rule=self.name,
                rel=index.rel,
                line=site.lineno,
                scope=index.qualname(site),
                message=(
                    "Thread/Timer is neither daemon=True nor "
                    "joined/cancelled on a shutdown path of its owner "
                    "class — it outlives shutdown(); mark it daemon or "
                    "join/cancel it, or allowlist with a justification"),
            )

    def _owner_releases(self, index: ModuleIndex, site: ast.Call,
                        attr: str) -> bool:
        """Some method of the owner class releases ``self.<attr>`` —
        MRO-merged in project mode, lexical class body otherwise."""
        cls = index.enclosing(site, (ast.ClassDef,))
        if cls is None:
            return False
        if self.project is not None:
            fq = f"{self.project.module_of(index)}.{index.def_qualname(cls)}"
            methods = [(m_idx, m) for m_idx, m, _owner
                       in self.project.class_methods(fq).values()]
            # a subclass may own the shutdown path for a base's thread
            for other_fq, (o_idx, _o_cls) in self.project.classes.items():
                if other_fq != fq and fq in self.project.mro(other_fq):
                    methods.extend(
                        (m_idx, m) for m_idx, m, _owner
                        in self.project.class_methods(other_fq).values())
        else:
            methods = [(index, n) for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
        return any(_released_in(m_idx, m, attr) for m_idx, m in methods)
