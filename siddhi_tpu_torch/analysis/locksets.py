"""Flow-sensitive lockset machinery shared by the concurrency rules.

Built on ``cfg`` + ``dataflow``, this module computes Eraser-style
**must-hold locksets**: for every statement of every function in the
project, the set of lock tokens that are held on EVERY path from the
function's entry to that statement.  The three flow-sensitive rules
(``lockset-race``, ``lock-order-deadlock``, ``barrier-flush``) consume
one shared :class:`LockModel` per run (cached on the ``ProjectIndex``),
so the package is lowered and iterated once, not once per rule.

**Lock tokens.**  A ``with``-context expression or ``.acquire()`` /
``.release()`` receiver whose final attribute ends in ``lock`` (the same
heuristic the lexical ``under_lock`` check used) becomes a token:

- ``self._lock`` → ``('attr', '_lock')`` — an instance lock, compared
  per-class (and qualified by its *defining* class for the global
  lock-order graph, so a mixin's lock is one node however many
  subclasses inherit it);
- ``self.app_context.process_lock`` / ``ctx.process_lock`` →
  ``('chain', 'app_context.process_lock')`` — an engine-level lock
  reached through a chain; the last two components identify it across
  modules, and single-assignment local aliases (``ctx =
  self.runtime.app_context``) are expanded first so every spelling
  normalizes to the same token.

**Transfer function.** ``WithEnter``/``WithExit`` pseudo-statements add
and remove tokens; explicit ``.acquire()`` adds and ``.release()``
removes, which is exactly what the lexical pass could not see — a write
after a mid-``with`` release, or between ``acquire()`` pairs, gets the
correct (empty) lockset.  ``Condition.wait()`` is a no-op: the lock is
re-held when the call returns.

**Interprocedural seeding.** Private helpers (leading ``_``, not
dunder, not a thread target) that are only ever called with a lock held
inherit that lock as their entry lockset: the model intersects the
caller-side locksets over every call site the project call graph resolves,
then re-runs the dataflow with the grown seeds (two rounds — seeds grow
monotonically, so the iteration is convergent and bounded).  Public
methods always start empty: anything may call them.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from .cfg import CFG, WithEnter, WithExit, build_cfg
from .dataflow import TOP, Analysis, Result, solve, stmt_facts
from .index import ModuleIndex
from .project import ProjectIndex, plain_dotted

#: a lock token: ('attr', '<name>') for self/cls-owned instance locks,
#: ('chain', '<a.b>') for locks reached through an attribute chain
Token = Tuple[str, str]

_THREAD_CTORS = {"threading.Thread", "Thread"}
_TIMER_CTORS = {"threading.Timer", "Timer"}

_SCOPE_NODES = (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef,
                ast.ClassDef)


def thread_target_of(call: ast.Call, index: ModuleIndex):
    """(kind, name) for a thread-launching call: ``('method', m)`` for a
    ``self.m`` target, ``('local', f)`` for a local function — shared by
    the lock rules and the lexical lock-discipline wrapper."""
    name = index.dotted(call.func)
    target = None
    if name in _THREAD_CTORS:
        for kw in call.keywords:
            if kw.arg == "target":
                target = kw.value
    elif name in _TIMER_CTORS:
        if len(call.args) >= 2:
            target = call.args[1]
        else:
            for kw in call.keywords:
                if kw.arg == "function":
                    target = kw.value
    if target is None:
        return None
    if isinstance(target, ast.Attribute) and \
            isinstance(target.value, ast.Name) and \
            target.value.id in ("self", "cls"):
        return ("method", target.attr)
    if isinstance(target, ast.Name):
        return ("local", target.id)
    return None


def render_token(tok: Token) -> str:
    return tok[1]


def lock_token(expr: ast.AST, aliases: Dict[str, str]) -> Optional[Token]:
    """Token for a lock expression, or None when it isn't lock-shaped."""
    p = plain_dotted(expr)
    if p is None:
        return None
    parts = p.split(".")
    if parts[0] in aliases:
        parts = aliases[parts[0]].split(".") + parts[1:]
    self_rooted = parts[0] in ("self", "cls")
    if self_rooted:
        parts = parts[1:]
    if not parts:
        return None
    leaf = parts[-1]
    if not leaf.lower().endswith("lock"):
        return None
    if self_rooted and len(parts) == 1:
        return ("attr", leaf)
    return ("chain", ".".join(parts[-2:]))


def _walk_no_scopes(root: ast.AST) -> Iterator[ast.AST]:
    """``ast.walk`` that does not descend into nested scopes."""
    stack = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _SCOPE_NODES):
                continue
            stack.append(child)


def shallow_calls(stmt) -> Iterator[ast.Call]:
    """Calls evaluated BY this statement itself: compound headers yield
    only their test/iterator expression (their bodies are separate
    statements of other blocks), plain statements their full expression
    tree minus nested scopes."""
    if isinstance(stmt, (WithEnter, WithExit)):
        roots = [stmt.item.context_expr]
    elif isinstance(stmt, (ast.If, ast.While)):
        roots = [stmt.test]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        roots = [stmt.iter]
    elif hasattr(ast, "Match") and isinstance(stmt, ast.Match):
        roots = [stmt.subject]
    elif isinstance(stmt, (ast.Try, ast.ExceptHandler)) or \
            isinstance(stmt, _SCOPE_NODES):
        return
    else:
        roots = [stmt]
    for root in roots:
        for node in _walk_no_scopes(root):
            if isinstance(node, ast.Call):
                yield node


def stmt_writes(stmt) -> Iterator[Tuple[str, int]]:
    """Direct ``self.x = / += / :`` writes of ONE statement —
    ``(attr, lineno)``; compound headers yield nothing."""
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    else:
        return
    for t in targets:
        elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
        for e in elts:
            if isinstance(e, ast.Attribute) and \
                    isinstance(e.value, ast.Name) and \
                    e.value.id in ("self", "cls"):
                yield (e.attr, e.lineno)


class LocksetAnalysis(Analysis):
    """Forward must-hold analysis: join is set intersection."""

    direction = "forward"

    def __init__(self, seed: FrozenSet[Token], aliases: Dict[str, str]):
        self.seed = frozenset(seed)
        self.aliases = aliases

    def initial(self, cfg: CFG) -> FrozenSet[Token]:
        return self.seed

    def join(self, a, b):
        return a & b

    def transfer(self, stmt, fact):
        if isinstance(stmt, WithEnter):
            tok = lock_token(stmt.item.context_expr, self.aliases)
            return fact | {tok} if tok else fact
        if isinstance(stmt, WithExit):
            tok = lock_token(stmt.item.context_expr, self.aliases)
            return fact - {tok} if tok else fact
        for call in shallow_calls(stmt):
            if not isinstance(call.func, ast.Attribute):
                continue
            if call.func.attr == "acquire":
                tok = lock_token(call.func.value, self.aliases)
                if tok:
                    fact = fact | {tok}
            elif call.func.attr == "release":
                tok = lock_token(call.func.value, self.aliases)
                if tok:
                    fact = fact - {tok}
        return fact


class FnFacts:
    """One function's fixpoint: per-statement must-hold locksets."""

    __slots__ = ("index", "fn", "qual", "cfg", "analysis", "result")

    def __init__(self, index: ModuleIndex, fn: ast.AST, qual: str,
                 cfg: CFG, analysis: LocksetAnalysis, result: Result):
        self.index = index
        self.fn = fn
        self.qual = qual
        self.cfg = cfg
        self.analysis = analysis
        self.result = result

    def statements(self):
        """Yield ``(stmt, lockset_before)``; the lockset is ``TOP`` in
        unreachable blocks (callers skip those)."""
        for _block, stmt, fact in stmt_facts(
                self.cfg, self.analysis, self.result):
            yield stmt, fact

    def acquisitions(self):
        """Yield ``(token, held_before, lineno)`` for every lock
        acquisition this function performs on a reachable path."""
        for stmt, fact in self.statements():
            if fact is TOP:
                continue
            if isinstance(stmt, WithEnter):
                tok = lock_token(stmt.item.context_expr,
                                 self.analysis.aliases)
                if tok:
                    yield tok, fact, stmt.lineno
                continue
            held = fact
            for call in shallow_calls(stmt):
                if not isinstance(call.func, ast.Attribute):
                    continue
                if call.func.attr == "acquire":
                    tok = lock_token(call.func.value,
                                     self.analysis.aliases)
                    if tok:
                        yield tok, held, call.lineno
                        held = held | {tok}
                elif call.func.attr == "release":
                    tok = lock_token(call.func.value,
                                     self.analysis.aliases)
                    if tok:
                        held = held - {tok}


def _lock_ctor_kind(value: ast.AST) -> Optional[str]:
    """'lock' | 'rlock' for a ``threading.Lock()``-style RHS; Conditions
    carry the reentrancy of their underlying lock (bare ``Condition()``
    allocates an RLock)."""
    if not isinstance(value, ast.Call):
        return None
    func = value.func
    leaf = None
    if isinstance(func, ast.Attribute):
        leaf = func.attr
    elif isinstance(func, ast.Name):
        leaf = func.id
    if leaf == "Lock":
        return "lock"
    if leaf == "RLock":
        return "rlock"
    if leaf == "Condition":
        if value.args:
            return _lock_ctor_kind(value.args[0]) or "lock"
        return "rlock"
    return None


class LockModel:
    """Whole-project lockset facts, shared by every flow rule."""

    #: seeding rounds: seeds grow monotonically, two rounds reach the
    #: helpers-two-hops-down cases the engine actually has
    ROUNDS = 2

    def __init__(self, project: ProjectIndex):
        self.project = project
        self._fq_of_fn: Dict[int, str] = {
            id(fn): fq for fq, (_idx, fn) in project.functions.items()}
        self._cfgs: Dict[int, CFG] = {}
        self._aliases: Dict[int, Dict[str, str]] = {}
        self._facts: Dict[Tuple[int, FrozenSet[Token]], FnFacts] = {}
        #: (class fq, attr) -> 'lock' | 'rlock'
        self.lock_defs: Dict[Tuple[str, str], str] = {}
        #: method/local-def NAMES that are Thread/Timer targets anywhere
        self.thread_target_names: Set[str] = set()
        self._collect_lock_defs()
        self._collect_thread_targets()
        #: fq -> entry lockset (interprocedural seeding)
        self.seeds: Dict[str, FrozenSet[Token]] = {}
        self._compute_seeds()

    # -- structure scans ----------------------------------------------------

    def _collect_lock_defs(self):
        for class_fq, (idx, cls) in self.project.classes.items():
            for stmt in cls.body:
                if isinstance(stmt, ast.Assign) and \
                        _lock_ctor_kind(stmt.value):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            self.lock_defs[(class_fq, t.id)] = \
                                _lock_ctor_kind(stmt.value)
            for node in ast.walk(cls):
                if not isinstance(node, ast.Assign):
                    continue
                kind = _lock_ctor_kind(node.value)
                if kind is None:
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id in ("self", "cls"):
                        self.lock_defs[(class_fq, t.attr)] = kind

    def _collect_thread_targets(self):
        for idx in self.project.indexes:
            for call in idx.calls():
                tgt = thread_target_of(call, idx)
                if tgt is not None:
                    self.thread_target_names.add(tgt[1])

    # -- per-function facts --------------------------------------------------

    def cfg_of(self, fn: ast.AST) -> CFG:
        cfg = self._cfgs.get(id(fn))
        if cfg is None:
            cfg = build_cfg(fn)
            self._cfgs[id(fn)] = cfg
        return cfg

    def aliases_of(self, index: ModuleIndex, fn: ast.AST
                   ) -> Dict[str, str]:
        cached = self._aliases.get(id(fn))
        if cached is not None:
            return cached
        qual = index.def_qualname(fn)
        assigned: Dict[str, int] = {}
        values: Dict[str, str] = {}
        for node in ast.walk(fn):
            if node is fn or index.qualname(node) != qual:
                continue
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                assigned[name] = assigned.get(name, 0) + 1
                v = plain_dotted(node.value)
                if v is not None:
                    values[name] = v
        out = {n: v for n, v in values.items() if assigned.get(n) == 1}
        self._aliases[id(fn)] = out
        return out

    def facts(self, index: ModuleIndex, fn: ast.AST,
              seed: FrozenSet[Token] = frozenset()) -> FnFacts:
        key = (id(fn), frozenset(seed))
        hit = self._facts.get(key)
        if hit is not None:
            return hit
        analysis = LocksetAnalysis(seed, self.aliases_of(index, fn))
        cfg = self.cfg_of(fn)
        result = solve(cfg, analysis)
        ff = FnFacts(index, fn, index.def_qualname(fn), cfg, analysis,
                     result)
        self._facts[key] = ff
        return ff

    def seed_of(self, fn: ast.AST) -> FrozenSet[Token]:
        fq = self._fq_of_fn.get(id(fn))
        if fq is None:
            return frozenset()
        return self.seeds.get(fq, frozenset())

    # -- interprocedural seeding --------------------------------------------

    def _seedable(self, fq: str) -> bool:
        leaf = fq.rsplit(".", 1)[-1]
        return (leaf.startswith("_") and not leaf.startswith("__")
                and leaf not in self.thread_target_names)

    def _compute_seeds(self):
        seeds: Dict[str, FrozenSet[Token]] = {}
        for _round in range(self.ROUNDS):
            acc: Dict[str, Optional[FrozenSet[Token]]] = {}
            for fq, (idx, fn) in self.project.functions.items():
                ff = self.facts(idx, fn, seeds.get(fq, frozenset()))
                if not ff.result.converged:
                    continue
                for stmt, fact in ff.statements():
                    if fact is TOP:
                        continue
                    for call in shallow_calls(stmt):
                        hit = self.project.resolve_call(idx, call)
                        if hit is None:
                            continue
                        # hit[2] is the defining CLASS for self.m()
                        # calls — recover the function's own fq from
                        # the resolved def node
                        t_fq = self._fq_of_fn.get(id(hit[1]))
                        if t_fq is None or not self._seedable(t_fq):
                            continue
                        cur = acc.get(t_fq)
                        acc[t_fq] = (frozenset(fact) if cur is None
                                     else cur & fact)
            new_seeds = {fq: s for fq, s in acc.items() if s}
            if new_seeds == seeds:
                break
            seeds = new_seeds
        self.seeds = seeds

    # -- token identity across the project ----------------------------------

    def definer_of(self, ctx_class_fq: Optional[str], attr: str
                   ) -> Optional[str]:
        """The MRO class that constructs ``self.<attr>`` as a lock."""
        if ctx_class_fq is None:
            return None
        for c in self.project.mro(ctx_class_fq):
            if (c, attr) in self.lock_defs:
                return c
        return ctx_class_fq

    def qualify(self, tok: Token, ctx_class_fq: Optional[str]) -> str:
        """Globally-unique node name for the lock-order graph."""
        kind, name = tok
        if kind == "attr":
            d = self.definer_of(ctx_class_fq, name)
            leaf = d.rsplit(".", 1)[-1] if d else "?"
            return f"{leaf}.{name}"
        return name

    def reentrant(self, tok: Token, ctx_class_fq: Optional[str]
                  ) -> Optional[bool]:
        """True/False when the lock's constructor is known, else None."""
        kind, name = tok
        if kind != "attr":
            return None
        d = self.definer_of(ctx_class_fq, name)
        lk = self.lock_defs.get((d, name)) if d else None
        if lk is None:
            return None
        return lk == "rlock"


def get_model(project: ProjectIndex) -> LockModel:
    """The per-run shared model, built once and cached on the project."""
    model = getattr(project, "_lock_model", None)
    if model is None:
        model = LockModel(project)
        project._lock_model = model
    return model
