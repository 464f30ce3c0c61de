"""Basic-block control-flow graphs for function bodies.

The flow-*insensitive* rules (lexical, then whole-program) can
say *where* a statement sits but not *when* it runs: they cannot see
that a write happens after a lock is released in the same method, cannot
order two acquisitions, and cannot tell a reachable flush from dead code
behind an early return.  This module lowers any ``FunctionDef`` /
``AsyncFunctionDef`` / ``Lambda`` body to a CFG the ``dataflow`` engine
iterates over:

- **blocks** hold the original AST statements in execution order, plus
  two pseudo-statements — :class:`WithEnter` / :class:`WithExit` — that
  mark ``with`` context entry and exit explicitly (the lockset rules'
  acquire/release events).  Compound statements (``If``/``While``/
  ``For``/``Try``/``Match``) appear once, in the block that evaluates
  their test, as a *header marker*; their bodies are lowered into
  successor blocks;
- **edges** cover both branch arms, loop back-edges and exits (``break``
  / ``continue`` unwind through any ``with`` frames they cross, emitting
  the matching ``WithExit``s), ``try`` bodies (every body block gets an
  edge to each handler entry — an exception may occur anywhere),
  ``finally`` routing (normal completion, handler completion, and jumps
  through the ``finally`` all pass through its blocks), and early
  ``return`` / ``raise`` (unwound through open ``with`` frames to the
  exit block or the innermost handler);
- **nested scopes are opaque**: a nested ``def``/``lambda``/``class``
  statement is one ordinary statement of the enclosing CFG — callers
  build a separate CFG per function, exactly like ``ModuleIndex``
  scopes.

Deliberate over-approximations (documented, conservative for the
must-hold lockset analyses that consume this graph): exception edges out
of a ``with`` body do not emit ``WithExit`` (the held-set stays larger,
so a must-analysis claims *fewer* facts, never more), and a shared
``finally`` lowering merges the paths that cross it instead of
duplicating blocks per jump target.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Union

__all__ = ["Block", "CFG", "WithEnter", "WithExit", "build_cfg"]


class WithEnter:
    """Pseudo-statement: control entered ``with <item>`` (acquire)."""

    __slots__ = ("node", "item")

    def __init__(self, node: ast.With, item: ast.withitem):
        self.node = node
        self.item = item

    @property
    def lineno(self) -> int:
        return self.node.lineno

    def __repr__(self):  # pragma: no cover - debug aid
        return f"WithEnter@{self.lineno}"


class WithExit:
    """Pseudo-statement: control left ``with <item>`` (release)."""

    __slots__ = ("node", "item")

    def __init__(self, node: ast.With, item: ast.withitem):
        self.node = node
        self.item = item

    @property
    def lineno(self) -> int:
        return self.node.lineno

    def __repr__(self):  # pragma: no cover - debug aid
        return f"WithExit@{self.lineno}"


#: what a block may hold: real statements, header markers (the compound
#: statement node itself), ``except`` handler markers, or pseudo-ops
Stmt = Union[ast.AST, WithEnter, WithExit]


class Block:
    """One basic block: straight-line statements + explicit edges."""

    __slots__ = ("bid", "stmts", "succs", "preds")

    def __init__(self, bid: int):
        self.bid = bid
        self.stmts: List[Stmt] = []
        self.succs: List["Block"] = []
        self.preds: List["Block"] = []

    def __repr__(self):  # pragma: no cover - debug aid
        return (f"Block({self.bid}, stmts={len(self.stmts)}, "
                f"succs={[s.bid for s in self.succs]})")


class CFG:
    """The lowered graph of one function body."""

    __slots__ = ("func", "blocks", "entry", "exit")

    def __init__(self, func: ast.AST, blocks: List[Block],
                 entry: Block, exit_block: Block):
        self.func = func
        self.blocks = blocks
        self.entry = entry
        self.exit = exit_block

    def reachable(self) -> set:
        """Block ids reachable from the entry."""
        seen = {self.entry.bid}
        work = [self.entry]
        while work:
            b = work.pop()
            for s in b.succs:
                if s.bid not in seen:
                    seen.add(s.bid)
                    work.append(s)
        return seen


class _WithFrame:
    __slots__ = ("node", "items")

    kind = "with"

    def __init__(self, node: ast.With, items):
        self.node = node
        self.items = list(items)


class _FinallyFrame:
    __slots__ = ("entry", "deferred")

    kind = "finally"

    def __init__(self, entry: Block):
        self.entry = entry
        #: jump targets routed through this finally; connected from the
        #: finally's last block once it has been lowered
        self.deferred: List[Block] = []


_LOOP_NODES = (ast.While, ast.For, ast.AsyncFor)


class _Builder:
    def __init__(self, func: ast.AST):
        self.func = func
        self.blocks: List[Block] = []
        self.entry = self._block()
        self.exit = self._block()
        #: current insertion block; None right after a jump
        self.cur: Optional[Block] = self.entry
        #: (header, loop exit, context-stack depth at loop entry)
        self.loops: List[tuple] = []
        #: open with/finally frames, innermost last
        self.ctx: List[Union[_WithFrame, _FinallyFrame]] = []
        #: (handler entry blocks, context-stack depth at try entry)
        self.handlers: List[tuple] = []

    # -- plumbing -----------------------------------------------------------

    def _block(self) -> Block:
        b = Block(len(self.blocks))
        self.blocks.append(b)
        return b

    def edge(self, a: Block, b: Block):
        if b not in a.succs:
            a.succs.append(b)
            b.preds.append(a)

    def current(self) -> Block:
        if self.cur is None:
            # statements after a jump: their own (unreachable) block
            self.cur = self._block()
        return self.cur

    def _jump(self, targets: Sequence[Block], depth: int):
        """Route control from the current block to ``targets``,
        unwinding context frames above ``depth``: open ``with`` frames
        emit their ``WithExit``s; a ``finally`` frame captures the
        targets and the jump lands on its entry instead."""
        cur = self.current()
        for frame in reversed(self.ctx[depth:]):
            if frame.kind == "with":
                for item in reversed(frame.items):
                    cur.stmts.append(WithExit(frame.node, item))
            else:  # finally: the jump continues from its last block
                frame.deferred.extend(targets)
                self.edge(cur, frame.entry)
                self.cur = None
                return
        for t in targets:
            self.edge(cur, t)
        self.cur = None

    # -- statement lowering -------------------------------------------------

    def lower(self, stmts: Sequence[ast.stmt]):
        for s in stmts:
            self._lower_stmt(s)

    def _lower_stmt(self, node: ast.stmt):
        if isinstance(node, ast.If):
            self._lower_if(node)
        elif isinstance(node, _LOOP_NODES):
            self._lower_loop(node)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            self._lower_with(node)
        elif isinstance(node, ast.Try):
            self._lower_try(node)
        elif hasattr(ast, "Match") and isinstance(node, ast.Match):
            self._lower_match(node)
        elif isinstance(node, ast.Return):
            self.current().stmts.append(node)
            self._jump([self.exit], 0)
        elif isinstance(node, ast.Raise):
            self.current().stmts.append(node)
            if self.handlers:
                entries, depth = self.handlers[-1]
                self._jump(entries, depth)
            else:
                self._jump([self.exit], 0)
        elif isinstance(node, ast.Break):
            if self.loops:
                _header, loop_exit, depth = self.loops[-1]
                self._jump([loop_exit], depth)
        elif isinstance(node, ast.Continue):
            if self.loops:
                header, _loop_exit, depth = self.loops[-1]
                self._jump([header], depth)
        else:
            # plain statement — nested defs/classes/lambdas included,
            # as opaque single statements of THIS scope
            self.current().stmts.append(node)

    def _lower_if(self, node: ast.If):
        header = self.current()
        header.stmts.append(node)  # header marker (carries the test)
        then = self._block()
        self.edge(header, then)
        self.cur = then
        self.lower(node.body)
        then_end = self.cur
        after = self._block()
        if then_end is not None:
            self.edge(then_end, after)
        if node.orelse:
            els = self._block()
            self.edge(header, els)
            self.cur = els
            self.lower(node.orelse)
            if self.cur is not None:
                self.edge(self.cur, after)
        else:
            self.edge(header, after)
        self.cur = after

    def _lower_loop(self, node):
        header = self._block()
        self.edge(self.current(), header)
        header.stmts.append(node)  # header marker (test / iterator)
        loop_exit = self._block()
        body = self._block()
        self.edge(header, body)
        self.loops.append((header, loop_exit, len(self.ctx)))
        self.cur = body
        self.lower(node.body)
        if self.cur is not None:
            self.edge(self.cur, header)  # back edge
        self.loops.pop()
        if node.orelse:
            els = self._block()
            self.edge(header, els)
            self.cur = els
            self.lower(node.orelse)
            if self.cur is not None:
                self.edge(self.cur, loop_exit)
        else:
            self.edge(header, loop_exit)
        self.cur = loop_exit

    def _lower_with(self, node):
        cur = self.current()
        for item in node.items:
            cur.stmts.append(WithEnter(node, item))
        frame = _WithFrame(node, node.items)
        self.ctx.append(frame)
        self.lower(node.body)
        self.ctx.pop()
        if self.cur is not None:
            cur = self.current()
            for item in reversed(node.items):
                cur.stmts.append(WithExit(node, item))

    def _lower_try(self, node: ast.Try):
        fin_frame: Optional[_FinallyFrame] = None
        if node.finalbody:
            fin_frame = _FinallyFrame(self._block())
            self.ctx.append(fin_frame)
        handler_entries = [self._block() for _ in node.handlers]
        body_start = len(self.blocks)
        start = self._block()
        self.edge(self.current(), start)
        self.cur = start
        if handler_entries:
            self.handlers.append((handler_entries, len(self.ctx)))
        self.lower(node.body)
        if handler_entries:
            self.handlers.pop()
            # an exception may occur anywhere in the body: edge every
            # block lowered for it (nested structure included) to every
            # handler entry
            for b in self.blocks[body_start:]:
                if b in handler_entries:
                    continue
                for h in handler_entries:
                    self.edge(b, h)
        if self.cur is not None and node.orelse:
            self.lower(node.orelse)
        normal_ends = [self.cur] if self.cur is not None else []
        for h_entry, handler in zip(handler_entries, node.handlers):
            self.cur = h_entry
            h_entry.stmts.append(handler)  # handler marker
            self.lower(handler.body)
            if self.cur is not None:
                normal_ends.append(self.cur)
        if fin_frame is not None:
            self.ctx.pop()
            for e in normal_ends:
                self.edge(e, fin_frame.entry)
            if not normal_ends and not fin_frame.deferred:
                # body and handlers all diverged without crossing the
                # finally (e.g. plain raises) — still reachable via the
                # exception path
                for b in self.blocks[body_start:]:
                    if not b.succs and b is not fin_frame.entry:
                        self.edge(b, fin_frame.entry)
            self.cur = fin_frame.entry
            self.lower(node.finalbody)
            after = self._block()
            if self.cur is not None:
                fin_end = self.cur
                self.edge(fin_end, after)
                for tgt in fin_frame.deferred:
                    self.edge(fin_end, tgt)
                # the uncaught-exception continuation re-raises
                self.edge(fin_end, self.exit)
            self.cur = after
        else:
            after = self._block()
            for e in normal_ends:
                self.edge(e, after)
            self.cur = after

    def _lower_match(self, node):
        header = self.current()
        header.stmts.append(node)  # header marker (carries the subject)
        after = self._block()
        for case in node.cases:
            b = self._block()
            self.edge(header, b)
            self.cur = b
            self.lower(case.body)
            if self.cur is not None:
                self.edge(self.cur, after)
        self.edge(header, after)  # no case matched
        self.cur = after


def build_cfg(func: ast.AST) -> CFG:
    """Lower one function def (or lambda) to a CFG.

    Only the function's OWN body is lowered — nested function/class
    definitions appear as single opaque statements; build a separate CFG
    for each (``ModuleIndex.functions`` lists them all).
    """
    b = _Builder(func)
    if isinstance(func, ast.Lambda):
        b.current().stmts.append(func.body)
    else:
        body = getattr(func, "body", None)
        if not isinstance(body, list):
            raise TypeError(
                f"build_cfg expects a function def or lambda, got "
                f"{type(func).__name__}")
        b.lower(body)
    if b.cur is not None:
        b.edge(b.cur, b.exit)
    return CFG(func, b.blocks, b.entry, b.exit)
