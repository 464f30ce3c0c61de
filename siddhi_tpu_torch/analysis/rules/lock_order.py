"""lock-order-deadlock: cycles in the global lock-acquisition graph.

Two threads that take the same pair of locks in opposite orders
deadlock the moment their windows overlap — the bug class no amount of
per-lock discipline catches, because every individual critical section
looks correct.  The rule builds one **acquisition-order graph** for the
whole package:

- every lock acquisition (``with``-enter or explicit ``.acquire()``)
  in every function contributes edges ``held -> acquired`` for each
  lock in the must-hold lockset ``dataflow.solve`` computed at that
  statement (interprocedural entry seeds included, so a private helper
  that acquires ``B`` and is only called under ``A`` contributes
  ``A -> B`` even though the two acquisitions sit in different
  functions);
- nodes are project-global lock identities: instance locks qualify by
  their MRO-resolved **defining class** (``ConnectRetryMixin._retry_lock``
  is one node however many sink/source subclasses inherit it), chain
  locks by their normalized last-two-component path
  (``app_context.process_lock``);
- every elementary cycle is a finding, reported once (canonical
  rotation) with one witness per edge — function, file and line of the
  inner acquisition;
- re-acquiring a lock already in the lockset is a self-cycle finding
  when the constructor registry proves the lock non-reentrant
  (``threading.Lock``/``Condition(Lock())``); RLocks and
  unknown-constructor chains are skipped.

Finding keys name only the cycle's lock identities, not lines, so
allowlist entries survive refactors.  The rule is whole-program only
(token identity needs the MRO and the project-wide seeds).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Tuple

from ..framework import Finding, Rule, register
from ..index import ModuleIndex
from ..locksets import get_model

#: witness for an edge a -> b: (rel, function fq, line of acquiring b)
_Witness = Tuple[str, str, int]

_MAX_CYCLE_LEN = 6
_MAX_CYCLES = 50


@register
class LockOrderRule(Rule):
    name = "lock-order-deadlock"
    description = (
        "cycle in the global lock-acquisition-order graph (AB/BA "
        "deadlock), or re-acquisition of a held non-reentrant lock")

    def check(self, index: ModuleIndex) -> Iterable[Finding]:
        return ()  # whole-program only

    def finish(self) -> Iterable[Finding]:
        if self.project is None:
            return ()
        model = get_model(self.project)
        edges: Dict[Tuple[str, str], _Witness] = {}
        self_cycles: List[Tuple[str, _Witness]] = []
        for fq in sorted(self.project.functions):
            idx, fn = self.project.functions[fq]
            ctx_class = self.project.enclosing_class_fq(idx, fn)
            ff = model.facts(idx, fn, model.seed_of(fn))
            if not ff.result.converged:
                continue
            for tok, held, line in ff.acquisitions():
                t_q = model.qualify(tok, ctx_class)
                for h in held:
                    h_q = model.qualify(h, ctx_class)
                    wit = (idx.rel, fq, line)
                    if h_q == t_q:
                        if model.reentrant(tok, ctx_class) is False:
                            self_cycles.append((t_q, wit))
                        continue
                    edges.setdefault((h_q, t_q), wit)
        findings = []
        seen = set()
        for name, (rel, fq, line) in self_cycles:
            if name in seen:
                continue
            seen.add(name)
            findings.append(Finding(
                rule=self.name,
                rel=rel,
                line=line,
                scope=f"self-cycle:{name}",
                message=(
                    f"non-reentrant lock '{name}' is re-acquired while "
                    f"already held (at {fq}:{line}) — guaranteed "
                    "self-deadlock; make it an RLock or drop the nested "
                    "acquisition"),
            ))
        for cycle in self._cycles(edges):
            path = " -> ".join(cycle + (cycle[0],))
            witnesses = []
            for i, a in enumerate(cycle):
                b = cycle[(i + 1) % len(cycle)]
                rel, fq, line = edges[(a, b)]
                witnesses.append(f"{a}->{b} at {fq} ({rel}:{line})")
            rel0, _fq0, line0 = edges[(cycle[0], cycle[1])]
            findings.append(Finding(
                rule=self.name,
                rel=rel0,
                line=line0,
                scope=f"cycle:{path}",
                message=(
                    f"lock-acquisition-order cycle {path}: "
                    + "; ".join(witnesses)
                    + " — pick one global order for these locks"),
            ))
        return findings

    def _cycles(self, edges: Dict[Tuple[str, str], _Witness]
                ) -> List[Tuple[str, ...]]:
        """Elementary cycles, canonically rotated to start at their
        smallest node, each reported once.  DFS from each start node
        visiting only nodes >= start (the classic enumeration trick:
        every elementary cycle is found exactly once, from its minimal
        node), bounded in length and count."""
        adj: Dict[str, List[str]] = {}
        for a, b in edges:
            adj.setdefault(a, []).append(b)
        for outs in adj.values():
            outs.sort()
        out: List[Tuple[str, ...]] = []
        for start in sorted(adj):
            stack = [(start, (start,))]
            while stack and len(out) < _MAX_CYCLES:
                node, path = stack.pop()
                for nxt in adj.get(node, ()):
                    if nxt == start:
                        out.append(path)
                    elif nxt > start and nxt not in path and \
                            len(path) < _MAX_CYCLE_LEN:
                        stack.append((nxt, path + (nxt,)))
        return out
