"""Generic forward/backward dataflow over ``cfg.CFG`` graphs.

A worklist fixpoint engine rules plug into by subclassing
:class:`Analysis` — a join-semilattice of facts plus a per-statement
transfer function.  The engine is direction-agnostic (``forward`` walks
successor edges from the entry, ``backward`` predecessor edges from the
exit), iterates to a fixpoint under a hard iteration bound, and applies
``widen`` once a block has been revisited more than ``WIDEN_AFTER``
times — for the finite lock-token lattices used today widening never
fires, but the bound keeps a buggy transfer function from hanging the
analyzer (the CFG corpus sweep in ``tests/test_torch_analysis_flow.py`` pins
``converged`` over every function in the package).

Must-analyses (held locksets) use ``TOP`` as the not-yet-reached value:
``join(TOP, x) == x``, so unreached predecessors don't erase facts, and
a block whose input is still ``TOP`` after the fixpoint is simply
unreachable — rules skip findings there.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

from .cfg import CFG, Block

__all__ = ["Analysis", "Result", "TOP", "solve", "stmt_facts"]


class _Top:
    """Sentinel: 'every fact' — the identity of a must-join."""

    __slots__ = ()

    def __repr__(self):  # pragma: no cover - debug aid
        return "TOP"


TOP = _Top()

#: revisits of one block before ``widen`` kicks in
WIDEN_AFTER = 8


class Analysis:
    """One dataflow problem: subclass and implement the lattice."""

    #: "forward" or "backward"
    direction = "forward"

    def initial(self, cfg: CFG):
        """Fact at the entry (forward) / exit (backward) boundary."""
        raise NotImplementedError

    def join(self, a, b):
        """Least upper bound of two facts (handle ``TOP``)."""
        raise NotImplementedError

    def equals(self, a, b) -> bool:
        return a == b

    def transfer(self, stmt, fact):
        """Fact after one statement given the fact before it."""
        raise NotImplementedError

    def widen(self, old, new):
        """Accelerate convergence after ``WIDEN_AFTER`` revisits; the
        default keeps the new fact (finite lattices converge anyway)."""
        return new

    # -- derived ------------------------------------------------------------

    def transfer_block(self, block: Block, fact):
        if fact is TOP:
            return TOP
        for s in block.stmts:
            fact = self.transfer(s, fact)
        return fact


class Result:
    """Fixpoint facts: ``block_in[bid]`` / ``block_out[bid]``."""

    __slots__ = ("block_in", "block_out", "converged", "steps")

    def __init__(self, block_in: Dict[int, object],
                 block_out: Dict[int, object],
                 converged: bool, steps: int):
        self.block_in = block_in
        self.block_out = block_out
        self.converged = converged
        self.steps = steps


def solve(cfg: CFG, analysis: Analysis, max_steps: int = 0) -> Result:
    """Iterate ``analysis`` over ``cfg`` to a fixpoint.

    ``max_steps`` bounds total block evaluations (0 = the default bound,
    proportional to graph size); on overrun the result is returned
    as-is with ``converged=False`` — callers treat that as 'no facts'
    (the conservative answer for a must-analysis).
    """
    forward = analysis.direction == "forward"
    start = cfg.entry if forward else cfg.exit
    if not max_steps:
        max_steps = 256 + 16 * len(cfg.blocks) * max(
            1, sum(len(b.succs) for b in cfg.blocks))
    block_in: Dict[int, object] = {b.bid: TOP for b in cfg.blocks}
    block_out: Dict[int, object] = {b.bid: TOP for b in cfg.blocks}
    block_in[start.bid] = analysis.initial(cfg)
    visits: Dict[int, int] = {}
    work = [start]
    queued = {start.bid}
    steps = 0
    converged = True
    while work:
        steps += 1
        if steps > max_steps:
            converged = False
            break
        block = work.pop(0)
        queued.discard(block.bid)
        out = analysis.transfer_block(block, block_in[block.bid])
        old = block_out[block.bid]
        if old is not TOP and not (out is TOP or
                                   analysis.equals(old, out)):
            visits[block.bid] = visits.get(block.bid, 0) + 1
            if visits[block.bid] > WIDEN_AFTER:
                out = analysis.widen(old, out)
        if old is not TOP and (out is TOP or analysis.equals(old, out)):
            continue
        block_out[block.bid] = out
        nexts = block.succs if forward else block.preds
        for nxt in nexts:
            cur = block_in[nxt.bid]
            if cur is TOP:
                joined = out
            elif out is TOP:
                joined = cur
            else:
                joined = analysis.join(cur, out)
            if cur is TOP or not analysis.equals(cur, joined):
                block_in[nxt.bid] = joined
                if nxt.bid not in queued:
                    queued.add(nxt.bid)
                    work.append(nxt)
    return Result(block_in, block_out, converged, steps)


def stmt_facts(cfg: CFG, analysis: Analysis, result: Result
               ) -> Iterator[Tuple[Block, object, object]]:
    """Replay the transfer inside each block, yielding
    ``(block, stmt, fact_before_stmt)`` — the per-statement view the
    lockset rules consume.  Blocks whose input is ``TOP`` (unreachable)
    yield ``TOP`` facts; rules skip them.  Forward direction only."""
    for block in cfg.blocks:
        fact = result.block_in[block.bid]
        for s in block.stmts:
            yield (block, s, fact)
            if fact is not TOP:
                fact = analysis.transfer(s, fact)
