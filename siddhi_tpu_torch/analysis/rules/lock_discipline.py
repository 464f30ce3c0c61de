"""lock-discipline: cross-thread attribute writes stay under the lock.

The engine spawns real threads: the async junction worker
(``core/stream.py``), the scheduler's wall-clock timer
(``util/scheduler.py``), the statistics reporter, the playback
heartbeat, the periodic-persist daemon (``core/app_runtime.py``),
the checkpoint writer (``durability/writer.py``), the service
listener, and the transport reconnect chain (``threading.Timer`` in
``transport/retry.py``).  All of them share
mutable engine state with the main batch path; the convention is that
shared state is touched under the engine lock (``process_lock`` or a
component lock), but nothing enforced it — PRs 1–4 added emit/ingest
queues and scheduler interactions that no guard checked at all.

Per class, the rule:

1. finds **thread entries**: methods or local functions passed as
   ``threading.Thread(target=...)`` / ``threading.Timer(..., fn)``;
2. closes them over ``self.method()`` calls — a call made inside a
   ``with <...lock>`` block does NOT extend the closure (the callee runs
   lock-protected there, like ``Scheduler._loop`` →
   ``advance`` under ``process_lock``);
3. collects direct ``self.<attr>`` writes on both sides (constructors
   — ``__init__`` and the transport SPI's ``init``/``_init_*``
   initializers — are excluded: construction happens-before thread
   start);
4. reports every attribute written by BOTH a thread-side function and a
   main-path method where any write site is not lexically under a
   lock-``with``.

With a ``ProjectIndex`` (the normal whole-program run), every step
resolves through the class's **MRO**: a ``threading.Timer`` armed in a
mixin (``ConnectRetryMixin``) is a thread entry of every class that
inherits it, ``self.<method>`` targets and closure calls dispatch to
the defining module, and write sites carry the file that owns them.  A
conflict whose participating sites are identical across several classes
(mixin-internal state seen through each subclass) is reported once, on
the base-most class.  Without a project (fixture mode) the rule is the
original single-module lexical pass.

The lexical lock check is conservative by design: disciplines the rule
cannot see (GIL-atomic monotonic flags, caller-holds-lock contracts)
are allowlisted per attribute with a written justification.

Since the flow-sensitive ``lockset-race`` rule landed, this pass is a
**thin compatibility wrapper**: in a full-catalog run it stands down
entirely — the lockset rule reports the same conflicts under the same
``<rel>:<Class.attr>`` keys with per-statement precision (its
allowlist inherited this rule's entries verbatim) — and only
standalone runs (``--rules lock-discipline``, fixture harnesses)
exercise the original lexical behavior.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Tuple

from ..framework import Finding, Rule, register
from ..index import ModuleIndex
from ..locksets import thread_target_of as _target_of

#: a write-site record: (scope qualname, line, under_lock, rel)
_Site = Tuple[str, int, bool, str]


@register
class LockDisciplineRule(Rule):
    name = "lock-discipline"
    description = (
        "attribute written from both a thread-entry function and the "
        "main path without the engine lock")

    def begin(self):
        # candidate conflicts across classes, for base-most dedup:
        # (attr, site identity) -> [(class fq, Finding)]
        self._candidates: Dict[Tuple[str, frozenset],
                               List[Tuple[str, Finding]]] = {}

    def check(self, index: ModuleIndex) -> Iterable[Finding]:
        if self.project is not None:
            return  # whole-program pass runs in finish()
        for cls_qual, cls in index.classes.items():
            methods = {
                n.name: (index, n, cls_qual) for n in cls.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
            yield from self._check_class(index, cls_qual, cls, methods)

    def finish(self) -> Iterable[Finding]:
        if self.project is None:
            return ()
        # compatibility-wrapper mode: when the flow-sensitive
        # lockset-race rule ran earlier in this run (registration order
        # guarantees it in the full catalog), this rule stands down —
        # every conflict the lexical pass can see, the lockset pass
        # sees with strictly better precision (same Class.attr keys),
        # so shared findings emit once and lexical-only candidates are
        # the flow pass's *proven-safe* set, not new signal.  Run
        # standalone (--rules lock-discipline, fixture harnesses) the
        # stash is absent and the full lexical behavior remains.
        if getattr(self.project, "_lockset_keys", None) is not None:
            return ()
        for fq_class in sorted(self.project.classes):
            idx, cls = self.project.classes[fq_class]
            methods = self.project.class_methods(fq_class)
            for f in self._check_class(
                    idx, idx.def_qualname(cls), cls, methods,
                    fq_class=fq_class):
                pass  # collected in self._candidates
        return self._dedup_candidates()

    # -- per-class analysis -------------------------------------------------

    def _own_nodes(self, index: ModuleIndex, fn: ast.AST, qual: str):
        """Walk ``fn``'s body excluding nested function/class scopes —
        a local ``def loop()`` inside ``start()`` is its own scope."""
        for node in ast.walk(fn):
            if node is fn:
                continue
            if index.qualname(node) == qual:
                yield node

    def _self_writes(self, index: ModuleIndex, fn: ast.AST, qual: str
                     ) -> List[_Site]:
        """Every direct ``self.x = / +=`` in ``fn``'s own scope."""
        out = []
        for node in self._own_nodes(index, fn, qual):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id in ("self", "cls"):
                    out.append((t.attr, t.lineno, index.under_lock(t),
                                index.rel))
        return out

    def _self_calls(self, index: ModuleIndex, fn: ast.AST, qual: str
                    ) -> List[Tuple[str, bool]]:
        """(method name, under_lock) for every ``self.m(...)`` call in
        ``fn``'s own scope."""
        out = []
        for node in self._own_nodes(index, fn, qual):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id in ("self", "cls"):
                out.append((node.func.attr, index.under_lock(node)))
        return out

    def _check_class(self, cls_index: ModuleIndex, cls_qual: str,
                     cls: ast.ClassDef,
                     methods: Dict[str, Tuple[ModuleIndex, ast.AST, str]],
                     fq_class: Optional[str] = None) -> Iterable[Finding]:
        """``methods`` carries (defining index, def node, owner) per
        name — the single-class dict lexically, the MRO-merged table in
        project mode."""
        # 1. thread entries
        roots: List[Tuple[str, ModuleIndex, ast.AST, str]] = []
        for mname, (m_idx, m, _owner) in methods.items():
            # thread ctors may sit inside a local def, so scan the full
            # method subtree (not just its own scope)
            for node in ast.walk(m):
                if not isinstance(node, ast.Call):
                    continue
                tgt = _target_of(node, m_idx)
                if tgt is None:
                    continue
                kind, tname = tgt
                if kind == "method" and tname in methods:
                    t_idx, t_fn, _ = methods[tname]
                    roots.append((tname, t_idx, t_fn,
                                  t_idx.def_qualname(t_fn)))
                elif kind == "local":
                    # resolve the local function def by qualified name,
                    # searching outward from the launching scope
                    scope = m_idx.qualname(node)
                    fn = m_idx.functions.get(f"{scope}.{tname}")
                    if fn is not None:
                        roots.append((tname, m_idx, fn, f"{scope}.{tname}"))
        if not roots:
            return
        # 2. closure over unlocked self.method() calls
        thread_fns: Dict[str, Tuple[ModuleIndex, ast.AST, str]] = {}
        work = list(roots)
        while work:
            label, f_idx, fn, qual = work.pop()
            if label in thread_fns:
                continue
            thread_fns[label] = (f_idx, fn, qual)
            for callee, locked in self._self_calls(f_idx, fn, qual):
                if locked:
                    continue  # callee runs under the lock at this site
                if callee in methods and callee not in thread_fns:
                    c_idx, c_fn, _ = methods[callee]
                    work.append((callee, c_idx, c_fn,
                                 c_idx.def_qualname(c_fn)))
        # 3. writes on each side
        thread_writes: Dict[str, List[_Site]] = {}
        for label, (f_idx, fn, qual) in thread_fns.items():
            for site in self._self_writes(f_idx, fn, qual):
                thread_writes.setdefault(site[0], []).append(
                    (qual,) + site[1:])
        main_writes: Dict[str, List[_Site]] = {}
        for mname, (m_idx, m, _owner) in methods.items():
            if mname in thread_fns or mname in ("__init__", "__new__",
                                                "init") \
                    or mname.startswith("_init"):
                continue
            mqual = m_idx.def_qualname(m)
            for site in self._self_writes(m_idx, m, mqual):
                main_writes.setdefault(site[0], []).append(
                    (mqual,) + site[1:])
        # 4. conflicts: one finding per attribute, keyed Class.attr
        for attr in sorted(set(thread_writes) & set(main_writes)):
            sites = thread_writes[attr] + main_writes[attr]
            unlocked = [(q, ln, rel) for q, ln, locked, rel in sites
                        if not locked]
            if not unlocked:
                continue
            where = ", ".join(f"{q}:{ln}" for q, ln, _rel in unlocked)
            finding = Finding(
                rule=self.name,
                rel=cls_index.rel,
                line=unlocked[0][1],
                scope=f"{cls_qual}.{attr}",
                message=(
                    f"'{attr}' is written from both a thread entry "
                    f"({', '.join(sorted(thread_fns))}) and the main "
                    f"path, with unlocked write(s) at {where} — guard "
                    "every write with the engine/component lock, or "
                    "allowlist with a justification"),
            )
            if fq_class is None:
                yield finding
            else:
                ident = frozenset((rel, ln) for _q, ln, _lk, rel in sites)
                self._candidates.setdefault(
                    (attr, ident), []).append((fq_class, finding))

    def _dedup_candidates(self) -> Iterable[Finding]:
        """One finding per (attr, site set): inherited mixin state
        shows the same conflict through every subclass — report it on
        the base-most class in the group."""
        out: List[Finding] = []
        for (_attr, _ident), group in sorted(
                self._candidates.items(),
                key=lambda kv: (kv[1][0][1].rel, kv[1][0][1].scope)):
            if len(group) == 1:
                out.append(group[0][1])
                continue
            base = None
            for fq, finding in group:
                if all(fq in self.project.mro(other)
                       for other, _f in group):
                    base = finding
                    break
            if base is None:
                base = sorted(group,
                              key=lambda g: (g[1].rel, g[1].scope))[0][1]
            out.append(base)
        return out
