"""lockset-race: flow-sensitive cross-thread write check (Eraser).

The lexical ``lock-discipline`` rule asks "is the write *inside* a
``with <lock>:`` block?" — a question with two blind spots this rule
closes:

1. **released-then-write**: an explicit ``lock.release()`` (or a
   ``with``-exit) before the write leaves the statement lexically
   inside the block but dynamically unprotected;
2. **disjoint locks**: the thread side holding ``self._a`` and the main
   path holding ``self._b`` are both "locked", yet nothing orders the
   two writes.

Per class (MRO-merged, as the whole-program pass resolves it):

1. **thread entries** come from ``threading.Thread(target=...)`` /
   ``Timer(..., fn)`` calls anywhere in the class's methods;
2. the thread side is closed over ``self.m()`` calls, each callee's
   **entry lockset seeded with the lockset held at the call site**
   (intersected over sites, so a helper called both locked and
   unlocked starts empty) — strictly more precise than the lexical
   rule's "a locked call does not extend the closure";
3. every reachable direct ``self.<attr>`` write on either side is
   recorded with the must-hold lockset ``dataflow.solve`` computed for
   its statement (main-path privates inherit the project-wide
   interprocedural seeds, so a helper only ever called under
   ``process_lock`` is not misread as unlocked);
4. an attribute written on both sides whose locksets have an **empty
   intersection** is a finding — same ``Class.attr`` key the lexical
   rule used, so existing allowlist entries stay valid and only
   shrink.

Constructors (``__init__``/``__new__``/transport ``init``/``_init*``)
are excluded: construction happens-before thread start.  Functions
whose fixpoint did not converge (none today — the CFG corpus sweep
pins this) are skipped rather than guessed at.

The rule is whole-program by construction (thread roots and MRO
merging need the ``ProjectIndex``); in fixture mode build a project
over the fixture files, as ``tests/test_torch_analysis_flow.py`` does.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, Iterable, List, Tuple

from ..dataflow import TOP
from ..framework import Finding, Rule, register
from ..index import ModuleIndex
from ..locksets import (
    Token,
    get_model,
    shallow_calls,
    stmt_writes,
    thread_target_of,
)

#: an access record: (scope qualname, line, lockset, rel)
_Access = Tuple[str, int, FrozenSet[Token], str]

_CTOR_NAMES = ("__init__", "__new__", "init")


def _is_ctor(name: str) -> bool:
    return name in _CTOR_NAMES or name.startswith("_init")


@register
class LocksetRaceRule(Rule):
    name = "lockset-race"
    description = (
        "attribute written from both a thread entry and the main path "
        "with an empty must-hold lockset intersection (flow-sensitive)")

    def begin(self):
        # (attr, site identity) -> [(class fq, Finding)], for base-most
        # dedup of conflicts inherited through several subclasses
        self._candidates: Dict[Tuple[str, frozenset],
                               List[Tuple[str, Finding]]] = {}

    def check(self, index: ModuleIndex) -> Iterable[Finding]:
        return ()  # whole-program only: everything happens in finish()

    def finish(self) -> Iterable[Finding]:
        if self.project is None:
            return ()
        model = get_model(self.project)
        for fq_class in sorted(self.project.classes):
            idx, cls = self.project.classes[fq_class]
            self._check_class(model, fq_class, idx, cls)
        findings = list(self._dedup_candidates())
        # lexical lock-discipline consults this to stand down on
        # conflicts the flow-sensitive pass already covers (raw keys,
        # pre-allowlist: a suppressed lockset finding still wins)
        self.project._lockset_keys = {f.key for f in findings}
        return findings

    # -- per-class analysis --------------------------------------------------

    def _thread_roots(self, model, fq_class: str,
                      methods) -> List[Tuple[str, ModuleIndex, ast.AST]]:
        roots = []
        for _mname, (m_idx, m, _owner) in methods.items():
            for node in ast.walk(m):
                if not isinstance(node, ast.Call):
                    continue
                tgt = thread_target_of(node, m_idx)
                if tgt is None:
                    continue
                kind, tname = tgt
                if kind == "method" and tname in methods:
                    t_idx, t_fn, _ = methods[tname]
                    roots.append((tname, t_idx, t_fn))
                elif kind == "local":
                    scope = m_idx.qualname(node)
                    fn = m_idx.functions.get(f"{scope}.{tname}")
                    if fn is not None:
                        roots.append((tname, m_idx, fn))
        return roots

    def _closure_with_seeds(self, model, methods, roots):
        """label -> (index, fn, entry seed): thread-side functions with
        call-site-seeded entry locksets.  Seeds only shrink (intersected
        across call sites), so the worklist terminates."""
        fns: Dict[str, Tuple[ModuleIndex, ast.AST]] = {}
        seeds: Dict[str, FrozenSet[Token]] = {}
        work = [(label, idx, fn, frozenset())
                for label, idx, fn in roots]
        while work:
            label, idx, fn, seed = work.pop()
            if label in fns:
                old = seeds[label]
                seed = old & seed
                if seed == old:
                    continue
            fns[label] = (idx, fn)
            seeds[label] = seed
            ff = model.facts(idx, fn, seed)
            if not ff.result.converged:
                continue
            for stmt, fact in ff.statements():
                if fact is TOP:
                    continue
                for call in shallow_calls(stmt):
                    if not (isinstance(call.func, ast.Attribute) and
                            isinstance(call.func.value, ast.Name) and
                            call.func.value.id in ("self", "cls")):
                        continue
                    callee = call.func.attr
                    if callee in methods:
                        c_idx, c_fn, _ = methods[callee]
                        work.append((callee, c_idx, c_fn,
                                     frozenset(fact)))
        return {label: (idx, fn, seeds[label])
                for label, (idx, fn) in fns.items()}

    def _check_class(self, model, fq_class: str, cls_index: ModuleIndex,
                     cls: ast.ClassDef):
        methods = self.project.class_methods(fq_class)
        roots = self._thread_roots(model, fq_class, methods)
        if not roots:
            return
        thread_fns = self._closure_with_seeds(model, methods, roots)
        thread_writes = self._collect_writes(model, thread_fns)
        main_fns: Dict[str, Tuple[ModuleIndex, ast.AST, FrozenSet[Token]]]
        main_fns = {}
        for mname, (m_idx, m, _owner) in methods.items():
            if mname in thread_fns or _is_ctor(mname):
                continue
            main_fns[mname] = (m_idx, m, model.seed_of(m))
        main_writes = self._collect_writes(model, main_fns)
        cls_qual = cls_index.def_qualname(cls)
        for attr in sorted(set(thread_writes) & set(main_writes)):
            sites = thread_writes[attr] + main_writes[attr]
            common = frozenset.intersection(*[s[2] for s in sites])
            if common:
                continue
            unlocked = [(q, ln, rel) for q, ln, ls, rel in sites
                        if not ls]
            witness = unlocked or [(q, ln, rel)
                                   for q, ln, _ls, rel in sites[:2]]
            where = ", ".join(f"{q}:{ln}" for q, ln, _rel in witness)
            finding = Finding(
                rule=self.name,
                rel=cls_index.rel,
                line=witness[0][1],
                scope=f"{cls_qual}.{attr}",
                message=(
                    f"'{attr}' is written from both a thread entry "
                    f"({', '.join(sorted(thread_fns))}) and the main "
                    f"path with no common lock held across the writes "
                    f"(empty lockset intersection; e.g. {where}) — hold "
                    "one lock over every write, or allowlist with a "
                    "justification"),
            )
            ident = frozenset((rel, ln) for _q, ln, _ls, rel in sites)
            self._candidates.setdefault(
                (attr, ident), []).append((fq_class, finding))

    def _collect_writes(self, model, fns) -> Dict[str, List[_Access]]:
        """attr -> access records with locksets, across ``fns``
        (label -> (index, fn, entry seed))."""
        out: Dict[str, List[_Access]] = {}
        for _label, (idx, fn, seed) in fns.items():
            ff = model.facts(idx, fn, seed)
            if not ff.result.converged:
                continue
            for stmt, fact in ff.statements():
                if fact is TOP:
                    continue
                for attr, line in stmt_writes(stmt):
                    out.setdefault(attr, []).append(
                        (ff.qual, line, frozenset(fact), idx.rel))
        return out

    def _dedup_candidates(self) -> Iterable[Finding]:
        """One finding per (attr, site set): mixin state seen through
        several subclasses reports once, on the base-most class."""
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
