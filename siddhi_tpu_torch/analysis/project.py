"""Whole-program index: imports, class hierarchies, and the call graph.

``ModuleIndex`` (``index.py``) resolves names lexically within one file;
that leaves the engine's riskiest constructs invisible — mixin state
(``ConnectRetryMixin`` methods run as ``threading.Timer`` targets of
classes defined two modules away), jitted callables imported from
helper modules, and planner fallback handlers that delegate logging and
counting to functions in other files.  ``ProjectIndex`` layers the
cross-module resolution every rule shares:

- **import maps** — per module, local name → fully-qualified target,
  covering ``import a.b``, ``import a.b as x``, ``from a.b import c``
  (aliased or not) and relative forms (``from . import x``,
  ``from ..pkg.mod import y``), collected from the whole tree so
  function-local imports (the planner's habit) resolve too;
- **symbol chasing** — a name imported from a package ``__init__``
  re-export is followed one hop at a time (cycle-guarded) to the
  defining module;
- **class hierarchy** — C3 linearization (MRO) over *project-local*
  bases, mixins and diamonds included; external bases (``object``,
  stdlib classes) are ignored, keeping the analysis conservative;
- **method resolution** — ``resolve_method(cls, name)`` walks the MRO
  exactly like runtime attribute lookup, so ``self.<method>`` thread
  targets and dispatch edges land on the defining module;
- **call graph** — conservative def→call edges through plain names
  (enclosing-scope chain, module functions, imports), ``self.``/
  ``cls.`` dispatch, imported-module attributes, and
  ``functools.partial``/wrapper first-arguments.

What is deliberately NOT followed (documented contract, mirrored in the
README): attribute calls on arbitrary objects (``engine.make_step()``
— no type inference), values stored into containers, dynamic
``getattr``, and anything outside the indexed package.  Rules stay
conservative-by-construction: an unresolved edge is a skipped edge,
never a guess.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .index import ModuleIndex


def module_name_of(rel: str) -> str:
    """Dotted module name of a repo-relative path
    (``siddhi_tpu_torch/core/stream.py`` → ``siddhi_tpu_torch.core.stream``;
    ``pkg/__init__.py`` → ``pkg``)."""
    parts = rel.split("/")
    if parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def plain_dotted(node: ast.AST) -> Optional[str]:
    """Dotted chain WITHOUT the ``self``/``cls`` elision of
    ``index.dotted_name`` — callers that need receiver identity
    (call-graph edges) must distinguish ``self.m`` from plain ``m``."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _c3_merge(seqs: List[List[str]]) -> Optional[List[str]]:
    """C3 linearization merge; None when inconsistent."""
    result: List[str] = []
    seqs = [list(s) for s in seqs if s]
    while seqs:
        for seq in seqs:
            head = seq[0]
            if not any(head in s[1:] for s in seqs):
                break
        else:
            return None  # inconsistent hierarchy
        result.append(head)
        seqs = [[x for x in s if x != head] for s in seqs]
        seqs = [s for s in seqs if s]
    return result


class ProjectIndex:
    """Cross-module resolution over a set of ``ModuleIndex``es."""

    def __init__(self, indexes: Sequence[ModuleIndex]):
        self.indexes: List[ModuleIndex] = list(indexes)
        #: dotted module name -> ModuleIndex
        self.by_module: Dict[str, ModuleIndex] = {}
        #: ModuleIndex id -> dotted module name
        self._mod_of: Dict[int, str] = {}
        for idx in self.indexes:
            mod = module_name_of(idx.rel)
            self.by_module[mod] = idx
            self._mod_of[id(idx)] = mod
        #: fully-qualified function name -> (index, def node)
        self.functions: Dict[str, Tuple[ModuleIndex, ast.AST]] = {}
        #: fully-qualified class name -> (index, ClassDef)
        self.classes: Dict[str, Tuple[ModuleIndex, ast.ClassDef]] = {}
        for mod, idx in self.by_module.items():
            for qual, fn in idx.functions.items():
                self.functions[f"{mod}.{qual}"] = (idx, fn)
            for qual, cls in idx.classes.items():
                self.classes[f"{mod}.{qual}"] = (idx, cls)
        #: module -> {local name -> fully-qualified target}
        self.imports: Dict[str, Dict[str, str]] = {
            mod: self._collect_imports(mod, idx)
            for mod, idx in self.by_module.items()
        }
        self._mro_cache: Dict[str, List[str]] = {}
        self._methods_cache: Dict[
            str, Dict[str, Tuple[ModuleIndex, ast.AST, str]]] = {}

    # -- imports --------------------------------------------------------------

    def module_of(self, idx: ModuleIndex) -> str:
        return self._mod_of[id(idx)]

    def _collect_imports(self, mod: str, idx: ModuleIndex
                         ) -> Dict[str, str]:
        is_pkg = idx.rel.endswith("__init__.py")
        pkg_parts = mod.split(".") if is_pkg else mod.split(".")[:-1]
        out: Dict[str, str] = {}
        for node in ast.walk(idx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        out[alias.asname] = alias.name
                    else:
                        # `import a.b.c` binds `a`; dotted chains resolve
                        # through the identity mapping of the root
                        root = alias.name.split(".")[0]
                        out.setdefault(root, root)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base_parts = pkg_parts[:len(pkg_parts)
                                           - (node.level - 1)]
                    if node.level - 1 > len(pkg_parts):
                        continue  # beyond the indexed root
                else:
                    base_parts = []
                if node.module:
                    base_parts = base_parts + node.module.split(".")
                base = ".".join(base_parts)
                for alias in node.names:
                    if alias.name == "*":
                        continue  # star imports are not followed
                    local = alias.asname or alias.name
                    out[local] = f"{base}.{alias.name}" if base \
                        else alias.name
        return out

    # -- symbol resolution ----------------------------------------------------

    def expand(self, mod: str, dotted: str) -> str:
        """Fully-qualified form of ``dotted`` as seen from ``mod``
        (import map applied to the head; module-local otherwise)."""
        parts = dotted.split(".")
        imp = self.imports.get(mod, {})
        if parts[0] in imp:
            return ".".join([imp[parts[0]]] + parts[1:])
        return f"{mod}.{dotted}"

    def _chase(self, fq: str, seen: Set[str]):
        """('function'|'class', fq) following one re-export hop at a
        time; None when the symbol leaves the project."""
        if fq in seen:
            return None
        seen.add(fq)
        if fq in self.functions:
            return ("function", fq)
        if fq in self.classes:
            return ("class", fq)
        parts = fq.split(".")
        for i in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:i])
            if mod in self.by_module:
                rest = parts[i:]
                imp = self.imports.get(mod, {})
                if rest and rest[0] in imp:
                    new = ".".join([imp[rest[0]]] + rest[1:])
                    return self._chase(new, seen)
                return None
        return None

    def resolve_symbol(self, mod: str, dotted: str):
        """('function'|'class', fq) for a dotted name as seen from
        ``mod``, or None."""
        hit = self._chase(self.expand(mod, dotted), set())
        if hit is None and "." not in dotted:
            # maybe a module-level name shadowed by the expand() head
            # rule — nothing else to try
            return None
        return hit

    def resolve_function_name(self, idx: ModuleIndex, scope: str,
                              name: str
                              ) -> Optional[Tuple[ModuleIndex, ast.AST, str]]:
        """Resolve a bare ``name(...)`` call made inside ``scope`` of
        module ``idx``: enclosing-scope chain first (nested defs), then
        module level, then imports.  Returns (index, def, fq)."""
        mod = self.module_of(idx)
        parts = scope.split(".") if scope != "<module>" else []
        while True:
            qual = ".".join(parts + [name]) if parts else name
            fn = idx.functions.get(qual)
            if fn is not None:
                return (idx, fn, f"{mod}.{qual}")
            if not parts:
                break
            parts.pop()
        hit = self.resolve_symbol(mod, name)
        if hit is not None and hit[0] == "function":
            f_idx, fn = self.functions[hit[1]]
            return (f_idx, fn, hit[1])
        return None

    def resolve_dotted_function(self, idx: ModuleIndex, dotted: str
                                ) -> Optional[Tuple[ModuleIndex, ast.AST, str]]:
        """Resolve an ``a.b.f(...)`` receiver chain rooted at an import
        (``plane_pack.pack_bits``); None for plain names (use
        ``resolve_function_name``) and unresolvable roots."""
        hit = self.resolve_symbol(self.module_of(idx), dotted)
        if hit is not None and hit[0] == "function":
            f_idx, fn = self.functions[hit[1]]
            return (f_idx, fn, hit[1])
        return None

    # -- class hierarchy ------------------------------------------------------

    def resolve_class(self, mod: str, dotted: str) -> Optional[str]:
        hit = self.resolve_symbol(mod, dotted)
        return hit[1] if hit is not None and hit[0] == "class" else None

    def bases_of(self, fq_class: str) -> List[str]:
        idx, cls = self.classes[fq_class]
        mod = self.module_of(idx)
        out = []
        for b in cls.bases:
            name = plain_dotted(b)
            if not name:
                continue
            fq = self.resolve_class(mod, name)
            if fq is not None:
                out.append(fq)
        return out

    def mro(self, fq_class: str) -> List[str]:
        """C3 linearization over project-local bases (falls back to a
        left-to-right DFS dedup when C3 rejects the hierarchy)."""
        cached = self._mro_cache.get(fq_class)
        if cached is not None:
            return cached
        self._mro_cache[fq_class] = [fq_class]  # cycle guard
        parents = [p for p in self.bases_of(fq_class) if p != fq_class]
        merged = _c3_merge(
            [[fq_class]] + [list(self.mro(p)) for p in parents]
            + [list(parents)])
        if merged is None:  # inconsistent: conservative DFS dedup
            merged, seen = [fq_class], {fq_class}
            for p in parents:
                for c in self.mro(p):
                    if c not in seen:
                        seen.add(c)
                        merged.append(c)
        self._mro_cache[fq_class] = merged
        return merged

    def class_methods(self, fq_class: str
                      ) -> Dict[str, Tuple[ModuleIndex, ast.AST, str]]:
        """name -> (index, def, owner class fq), merged over the MRO
        (most-derived definition wins, like runtime lookup)."""
        cached = self._methods_cache.get(fq_class)
        if cached is not None:
            return cached
        out: Dict[str, Tuple[ModuleIndex, ast.AST, str]] = {}
        for c in reversed(self.mro(fq_class)):
            idx, cls = self.classes[c]
            for n in cls.body:
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[n.name] = (idx, n, c)
        self._methods_cache[fq_class] = out
        return out

    def resolve_method(self, fq_class: str, name: str
                       ) -> Optional[Tuple[ModuleIndex, ast.AST, str]]:
        return self.class_methods(fq_class).get(name)

    def enclosing_class_fq(self, idx: ModuleIndex, node: ast.AST
                           ) -> Optional[str]:
        cls = idx.enclosing(node, (ast.ClassDef,))
        if cls is None:
            return None
        return f"{self.module_of(idx)}.{idx.def_qualname(cls)}"

    # -- call graph -----------------------------------------------------------

    def resolve_call(self, idx: ModuleIndex, call: ast.Call
                     ) -> Optional[Tuple[ModuleIndex, ast.AST, str]]:
        """(index, def, fq) of the function a call statically dispatches
        to; None when the receiver cannot be resolved without type
        inference.  ``functools.partial(f, ...)`` resolves to ``f``."""
        func = call.func
        if isinstance(func, ast.Name):
            hit = self.resolve_function_name(
                idx, idx.qualname(call), func.id)
            if hit is not None:
                leaf = hit[2].rsplit(".", 1)[-1]
                if leaf == "partial" and call.args:
                    return self._resolve_value(idx, call, call.args[0])
                return hit
            # partial imported from functools resolves outside the
            # project; still follow its first argument
            if func.id == "partial" and call.args:
                return self._resolve_value(idx, call, call.args[0])
            return None
        if isinstance(func, ast.Attribute):
            if isinstance(func.value, ast.Name) and \
                    func.value.id in ("self", "cls"):
                owner = self.enclosing_class_fq(idx, call)
                if owner is not None:
                    return self.resolve_method(owner, func.attr)
                return None
            dotted = plain_dotted(func)
            if dotted is None:
                return None
            if dotted.endswith(".partial") and call.args:
                return self._resolve_value(idx, call, call.args[0])
            return self.resolve_dotted_function(idx, dotted)
        return None

    def _resolve_value(self, idx: ModuleIndex, site: ast.AST,
                       value: ast.AST
                       ) -> Optional[Tuple[ModuleIndex, ast.AST, str]]:
        """Resolve a callable VALUE (partial/wrapper argument)."""
        if isinstance(value, ast.Lambda):
            return (idx, value, f"{self.module_of(idx)}."
                                f"{idx.qualname(value)}.<lambda>")
        if isinstance(value, ast.Call):
            if value.args:
                return self._resolve_value(idx, site, value.args[0])
            return None
        if isinstance(value, ast.Name):
            return self.resolve_function_name(
                idx, idx.qualname(site), value.id)
        if isinstance(value, ast.Attribute):
            dotted = plain_dotted(value)
            if dotted is None:
                return None
            if isinstance(value.value, ast.Name) and \
                    value.value.id in ("self", "cls"):
                owner = self.enclosing_class_fq(idx, site)
                if owner is not None:
                    return self.resolve_method(owner, value.attr)
                return None
            return self.resolve_dotted_function(idx, dotted)
        return None

    def iter_calls_reachable(self, idx: ModuleIndex,
                             roots: Sequence[ast.AST],
                             max_defs: int = 200
                             ) -> Iterator[Tuple[ModuleIndex, ast.Call]]:
        """Every call lexically inside ``roots`` plus, transitively,
        inside the bodies of project-resolved callees — the shared BFS
        behind reachability rules (fallback-discipline, jit-purity's
        helper following).  Yields ``(defining index, call)`` pairs;
        ``max_defs`` bounds runaway closures."""
        work: List[Tuple[ModuleIndex, ast.AST]] = [
            (idx, r) for r in roots]
        visited: Set[Tuple[int, int]] = set()
        expanded = 0
        while work:
            cur_idx, node = work.pop()
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                yield (cur_idx, sub)
                hit = self.resolve_call(cur_idx, sub)
                if hit is None:
                    continue
                t_idx, t_fn, t_fq = hit
                key = (id(t_idx), id(t_fn))
                if key in visited or expanded >= max_defs:
                    continue
                visited.add(key)
                expanded += 1
                work.append((t_idx, t_fn))


def build_project(indexes: Sequence[ModuleIndex]) -> ProjectIndex:
    return ProjectIndex(indexes)
