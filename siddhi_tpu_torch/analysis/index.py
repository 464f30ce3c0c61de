"""Module indexing: one parse per file, shared by every rule.

The three retired guard tests each re-implemented file walking, AST
parsing and qualified-name ("``Class.method``") scope resolution.  This
module does that work once: a ``ModuleIndex`` parses a file a single
time and precomputes the structures every rule needs —

- ``qualname(node)``  — the dotted function/class scope enclosing any
  AST node (``DeviceQueryRuntime.process_stream_batch``), resolved from
  a parent map rather than per-rule visitor stacks;
- ``dotted(call)``    — the receiver chain of a call as a dotted string
  (``self.engine.make_step`` → ``engine.make_step`` with the leading
  ``self`` elided, so rules match receivers held as attributes and plain
  imports
  alike);
- ``functions``       — every function/lambda def keyed by qualified
  name, for rules that resolve a callable argument to its definition.

Rules receive the index and never re-parse; ``index_package`` walks a
package root once and yields indexes sorted by path so reports are
deterministic.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)


def dotted_name(node: ast.AST) -> Optional[str]:
    """Dotted receiver chain of an expression (``a.b.c``), or None when
    any link is not a plain name/attribute (calls, subscripts, ...).
    A leading ``self``/``cls`` is elided so ``self.np.asarray`` and
    ``np.asarray`` compare equal."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        if node.id not in ("self", "cls"):
            parts.append(node.id)
    elif not parts:
        return None
    elif not isinstance(node, ast.Name):
        return None
    return ".".join(reversed(parts)) if parts else None


class ModuleIndex:
    """One parsed module plus the lookups every rule shares."""

    #: process-wide count of actual ``ast.parse`` runs — tests assert
    #: the (path, mtime, size) cache keeps this at one per file
    parse_count: int = 0

    def __init__(self, path: Path, rel: str, source: Optional[str] = None):
        ModuleIndex.parse_count += 1
        self.path = Path(path)
        self.rel = rel  # repo-relative posix path used in findings
        self.source = self.path.read_text() if source is None else source
        self.tree = ast.parse(self.source)
        self._parents: Dict[ast.AST, ast.AST] = {}
        self._qualnames: Dict[ast.AST, str] = {}
        #: qualified name -> FunctionDef/AsyncFunctionDef (module scope
        #: and nested defs alike; lambdas are not named so not listed)
        self.functions: Dict[str, ast.AST] = {}
        #: qualified name -> ClassDef
        self.classes: Dict[str, ast.ClassDef] = {}
        self._build(self.tree, ())

    def _build(self, node: ast.AST, scope: Tuple[str, ...]):
        for child in ast.iter_child_nodes(node):
            self._parents[child] = node
            child_scope = scope
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                child_scope = scope + (child.name,)
                qual = ".".join(child_scope)
                self._qualnames[child] = qual
                if isinstance(child, ast.ClassDef):
                    self.classes[qual] = child
                else:
                    self.functions[qual] = child
            self._build(child, child_scope)

    # -- scope resolution ---------------------------------------------------

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def def_qualname(self, node: ast.AST) -> str:
        """Qualified name OF a function/class def node itself (falls
        back to the enclosing scope for lambdas and other nodes)."""
        return self._qualnames.get(node) or self.qualname(node)

    def qualname(self, node: ast.AST) -> str:
        """Qualified name of the innermost function/class scope that
        contains ``node`` (``"<module>"`` at module level)."""
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                return self._qualnames[cur]
            cur = self._parents.get(cur)
        return "<module>"

    def enclosing(self, node: ast.AST, kinds=_SCOPES) -> Optional[ast.AST]:
        """Innermost enclosing node of the given AST types."""
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, kinds):
                return cur
            cur = self._parents.get(cur)
        return None

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    # -- shared predicates --------------------------------------------------

    def dotted(self, node: ast.AST) -> Optional[str]:
        return dotted_name(node)

    def calls(self) -> Iterator[ast.Call]:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                yield node

    def under_lock(self, node: ast.AST) -> bool:
        """True when ``node`` sits lexically inside a ``with`` block
        whose context expression is a dotted name ending in ``lock``
        (``self._lock``, ``ctx.process_lock``, ``cls._retry_lock``...).
        The lexical check is deliberately conservative: lock handoffs a
        rule cannot see (e.g. "caller always holds the lock") belong in
        that rule's allowlist with a written justification."""
        for anc in self.ancestors(node):
            if isinstance(anc, ast.With):
                for item in anc.items:
                    name = dotted_name(item.context_expr)
                    if name and name.split(".")[-1].lower().endswith("lock"):
                        return True
        return False


#: (absolute path, rel) -> (mtime_ns, size, ModuleIndex) — one parse
#: per file per analyzer run: the CLI, the clean-package test, and any
#: rule-subset re-run inside one process share parsed indexes as long
#: as the file on disk is byte-identical (mtime+size key).
_PARSE_CACHE: dict = {}


def index_package(root: Path, rel_base: Optional[Path] = None,
                  exclude: Tuple[str, ...] = ("analysis",),
                  cache: bool = True) -> List[ModuleIndex]:
    """Parse every ``*.py`` under ``root`` once, sorted by path.

    ``exclude`` names top-level subpackages to skip, repo-relative to
    ``root`` — the analysis package itself is excluded by default (its
    fixture strings and banned-call tables would trip the very rules
    they implement).  Parses are memoized on (path, mtime, size) so
    repeated runs in one process re-use one ``ModuleIndex`` per file;
    ``cache=False`` forces a fresh parse."""
    root = Path(root)
    rel_base = Path(rel_base) if rel_base is not None else root.parent
    out: List[ModuleIndex] = []
    for path in sorted(root.rglob("*.py")):
        parts = path.relative_to(root).parts
        if parts and parts[0] in exclude:
            continue
        rel = path.relative_to(rel_base).as_posix()
        st = path.stat()
        key = (str(path), rel)
        hit = _PARSE_CACHE.get(key)
        if cache and hit is not None and \
                hit[0] == st.st_mtime_ns and hit[1] == st.st_size:
            out.append(hit[2])
            continue
        mi = ModuleIndex(path, rel)
        _PARSE_CACHE[key] = (st.st_mtime_ns, st.st_size, mi)
        out.append(mi)
    return out
