"""retrace-hazard: no step or kernel rebuilds on the per-batch path.

The port has no ``jax.jit`` and no CUDA graph, so nothing re-traces;
the name is the reference's so the two catalogs line up.  In the port
the expensive constructions are the **step builders** (``make_step``,
``make_general_step``, ``make_time_step``, ``build_packed_nfa``,
``make_scan``: each compiles the engine's filters and allocates its
constants) and ``kernels/build.py`` ``load`` (an ``nvcc`` build and a
``dlopen`` on a miss).  The engine's discipline is that builders
memoize what they build (``self._general_cache[key]``,
``self._time_step``, ``build._LOADED[name]``) so the hot path only
ever LOOKS UP.

The rule finds calls to a step builder or ``load`` inside a function
whose name matches the per-batch pattern (``process*``, ``*_chunk``,
``*_step``, ``receive``, ``advance``...) and reports them unless the
result is memoized — at the call site, into an instance attribute
(``self._fn = make_step(k)``, ``self._cache[k] = ...``, or a local then
stored), or inside the builder itself when the call resolves to it
(lexically through ``self.``, or through the project index): any store
into ``self.<attr>``, ``self.<attr>[k]`` or a module-level cache
``_CACHE[k]`` in the builder's body.  A call on a receiver the rule
cannot resolve (``eng.make_general_step(...)``) is reported; a
sanctioned one goes in the allowlist with a justification naming the
builder's cache.

With a ``ProjectIndex`` the rule additionally follows one call-graph
hop: a hot-named function that calls a project-resolved **helper in
another scope** whose body calls a builder without memoizing rebuilds
per batch just the same, only with the call hidden a file away.  The
finding lands on the hot caller's call site.  Helpers whose own name
matches the hot pattern are skipped there (the direct pass owns them).
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional, Set

from ..framework import Finding, Rule, register
from ..index import ModuleIndex
from .jit_purity import STEP_BUILDERS

#: function names that run once per batch/event/pane — the hot path.
HOT_NAME_RE = re.compile(
    r"(?:^|_)(process|receive|send|dispatch|deliver|publish|advance|fire|"
    r"drain|flush|submit|finish|emit|step|chunk|segment|scatter|reduce|"
    r"kernel|acc|on_time|sweep)(?:$|_)")

#: dotted spellings of kernels/build.py's loader
LOAD_NAMES = {"load", "build.load"}


def build_sites(index: ModuleIndex) -> List[ast.Call]:
    """Calls to a step builder or the kernel loader."""
    out = []
    for call in index.calls():
        name = index.dotted(call.func)
        if name is None:
            continue
        if name in LOAD_NAMES or name.split(".")[-1] in STEP_BUILDERS:
            out.append(call)
    return out


def _self_attr_target(node: ast.AST) -> bool:
    """True for ``self.x`` or ``self.x[...]`` assignment targets."""
    if isinstance(node, ast.Subscript):
        node = node.value
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id in ("self", "cls"))


def _escapes_to_instance(index: ModuleIndex, site: ast.Call,
                         hot_fn: ast.AST) -> bool:
    """Does the value built at ``site`` get memoized on the instance
    inside ``hot_fn``?"""
    # direct: an ancestor assignment whose target is self.x / self.x[k]
    local_names: Set[str] = set()
    for anc in index.ancestors(site):
        if anc is hot_fn:
            break
        if isinstance(anc, ast.Assign):
            for t in anc.targets:
                if _self_attr_target(t):
                    return True
                if isinstance(t, ast.Name):
                    local_names.add(t.id)
        elif isinstance(anc, (ast.AugAssign, ast.AnnAssign)) and \
                _self_attr_target(anc.target):
            return True
    if not local_names:
        return False
    # indirect: a local bound from the site is later stored on self
    for node in ast.walk(hot_fn):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Name) and \
                node.value.id in local_names:
            if any(_self_attr_target(t) for t in node.targets):
                return True
    return False


def _memoizes(builder: ast.AST) -> bool:
    """Does the builder's body store into an instance or module cache
    (``self.x = ``, ``self.x[k] = ``, ``_CACHE[k] = ``)?"""
    for node in ast.walk(builder):
        targets = (node.targets if isinstance(node, ast.Assign) else
                   [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        for t in targets:
            if _self_attr_target(t):
                return True
            if isinstance(t, ast.Subscript) and \
                    isinstance(t.value, ast.Name) and \
                    t.value.id.lstrip("_").isupper():
                return True
    return False


def _lexical_builder(index: ModuleIndex, site: ast.Call
                     ) -> Optional[ast.AST]:
    """The def a builder call names within its own module: a plain
    module function, or a ``self.``/``cls.`` method of the enclosing
    class."""
    f = site.func
    if isinstance(f, ast.Name):
        return index.functions.get(f.id)
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) and \
            f.value.id in ("self", "cls"):
        cls = index.enclosing(site, (ast.ClassDef,))
        if cls is not None:
            return index.functions.get(
                f"{index.def_qualname(cls)}.{f.attr}")
    return None


@register
class RetraceHazardRule(Rule):
    name = "retrace-hazard"
    description = (
        "un-memoized step-builder / kernel-load call inside a per-batch "
        "function — rebuilds on the hot path")

    def _builder_memoizes(self, index: ModuleIndex, site: ast.Call) -> bool:
        fn = _lexical_builder(index, site)
        if fn is None and self.project is not None:
            hit = self.project.resolve_call(index, site)
            if hit is not None:
                fn = hit[1]
        return fn is not None and _memoizes(fn)

    def begin(self):
        # per-run memos: module -> builder call sites, def -> verdict
        self._sites = {}
        self._fresh = {}

    def _build_sites(self, index: ModuleIndex) -> List[ast.Call]:
        memo = getattr(self, "_sites", None)
        if memo is None:
            return build_sites(index)
        hit = memo.get(id(index))
        if hit is None:
            hit = memo[id(index)] = build_sites(index)
        return hit

    def check(self, index: ModuleIndex) -> Iterable[Finding]:
        for site in self._build_sites(index):
            fn = index.enclosing(site, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))
            if fn is None:
                continue  # module-level build runs once at import
            if not HOT_NAME_RE.search(fn.name):
                continue
            if _escapes_to_instance(index, site, fn):
                continue
            if self._builder_memoizes(index, site):
                continue
            yield Finding(
                rule=self.name,
                rel=index.rel,
                line=site.lineno,
                scope=index.def_qualname(fn),
                message=(
                    f"{index.dotted(site.func)}() called inside a "
                    "per-batch function without memoizing the result — "
                    "every call rebuilds; memoize it (builder-side cache "
                    "or instance attribute), or allowlist with a "
                    "justification naming the cache"),
            )
        if self.project is not None:
            yield from self._cross_module(index)

    def _cross_module(self, index: ModuleIndex) -> Iterable[Finding]:
        """One call-graph hop: hot caller → helper (any scope) that
        calls a builder without memoizing, and is not memoized at the
        call site."""
        seen: Set[tuple] = set()
        for qual, fn in index.functions.items():
            if not HOT_NAME_RE.search(fn.name):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                if index.enclosing(node, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)) is not fn:
                    continue  # nested defs get their own hot-name check
                hit = self.project.resolve_call(index, node)
                if hit is None:
                    continue
                t_idx, t_fn, t_fq = hit
                if not isinstance(t_fn, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if t_fn is fn or HOT_NAME_RE.search(t_fn.name) or \
                        t_fn.name in STEP_BUILDERS:
                    continue  # the direct pass owns these
                if not self._builds_fresh(t_idx, t_fn):
                    continue
                if _escapes_to_instance(index, node, fn):
                    continue  # caller memoizes the built value
                key = (index.rel, qual, t_fq)
                if key in seen:
                    continue
                seen.add(key)
                yield Finding(
                    rule=self.name,
                    rel=index.rel,
                    line=node.lineno,
                    scope=qual,
                    message=(
                        f"per-batch call to {t_fq}() which calls a step "
                        "builder or the kernel loader without memoizing "
                        "— a rebuild per call; memoize the built value "
                        "(helper-side cache or instance attribute at "
                        "this call site), or allowlist with a "
                        "justification"),
                )

    def _builds_fresh(self, t_idx: ModuleIndex, t_fn: ast.AST) -> bool:
        """Does ``t_fn`` call a builder whose result neither it nor the
        builder memoizes (a new build per call)?"""
        memo = self._fresh
        hit = memo.get(id(t_fn))
        if hit is None:
            hit = memo[id(t_fn)] = self._builds_fresh_uncached(t_idx, t_fn)
        return hit

    def _builds_fresh_uncached(self, t_idx: ModuleIndex,
                               t_fn: ast.AST) -> bool:
        if _memoizes(t_fn):
            return False
        for site in self._build_sites(t_idx):
            if t_idx.enclosing(site, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)) is not t_fn:
                continue
            if not self._builder_memoizes(t_idx, site):
                return True
        return False
