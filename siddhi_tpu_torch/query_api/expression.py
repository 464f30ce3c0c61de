"""Expression AST.

Mirrors ``io.siddhi.query.api.expression`` (Expression/Variable/constant/
condition/math trees).  Unlike the reference — which lowers these to ~155
per-type executor classes (reference: core/executor/, SURVEY.md §2.2) — the
port compiles one expression tree into a single vectorized columnar
evaluator (torch tensor operators), so no per-type class
explosion is needed: dtype dispatch is handled by the array library.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Union

from siddhi_tpu_torch.query_api.attribute import AttrType


class Expression:
    """Base class for all expression nodes."""

    __slots__ = ()


@dataclass(frozen=True)
class Constant(Expression):
    value: object
    type: AttrType


@dataclass(frozen=True)
class TimeConstant(Expression):
    """A time literal like ``5 sec``; value is milliseconds (long)."""

    value: int

    @property
    def type(self) -> AttrType:
        return AttrType.LONG


@dataclass(frozen=True)
class Variable(Expression):
    """Attribute reference: ``attr``, ``Stream.attr``, ``e1[2].attr``,
    ``#innerStream.attr``, ``!faultStream.attr``."""

    attribute: str
    stream_id: Optional[str] = None
    # index into a pattern event collection, e.g. e1[0].price; LAST = -1,
    # LAST - k = -(k+1)
    stream_index: Optional[int] = None
    is_inner: bool = False
    is_fault: bool = False
    # second-level reference for on-demand queries over named windows
    function_id: Optional[str] = None


@dataclass(frozen=True)
class FunctionCall(Expression):
    """``ns:fn(arg, ...)`` — builtins, UDFs, window/stream processors."""

    namespace: Optional[str]
    name: str
    args: tuple = ()
    # True when the call was written as fn(*)
    star: bool = False


@dataclass(frozen=True)
class ArithmeticOp(Expression):
    op: str  # '+', '-', '*', '/', '%'
    left: Expression
    right: Expression


@dataclass(frozen=True)
class CompareOp(Expression):
    op: str  # '<', '<=', '>', '>=', '==', '!='
    left: Expression
    right: Expression


@dataclass(frozen=True)
class AndOp(Expression):
    left: Expression
    right: Expression


@dataclass(frozen=True)
class OrOp(Expression):
    left: Expression
    right: Expression


@dataclass(frozen=True)
class NotOp(Expression):
    expr: Expression


@dataclass(frozen=True)
class InOp(Expression):
    """``expr IN TableName`` membership test."""

    expr: Expression
    source_id: str


@dataclass(frozen=True)
class IsNull(Expression):
    expr: Expression


@dataclass(frozen=True)
class IsNullStream(Expression):
    """``e1 IS NULL`` / ``e1[1] IS NULL`` over a pattern event slot."""

    stream_id: str
    stream_index: Optional[int] = None
    is_inner: bool = False
    is_fault: bool = False
