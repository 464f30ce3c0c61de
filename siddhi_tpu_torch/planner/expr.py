"""Expression compiler: query_api expression tree -> closure over tensors.

Port of the JAX package's ``planner/expr.py`` for the device path.  One
compile pass turns an expression tree into ``fn(env) -> tensor`` where
``env`` maps column keys to torch tensors.  The closures use operator
overloading only, so they run unchanged on CPU and CUDA tensors.

Numeric constants stay numpy scalars (``np.float64`` for DOUBLE) exactly
as in the JAX package.  Torch, like JAX with x64 off, treats such a
scalar as weakly typed: ``v > np.float64(8.1)`` on a float32 tensor
compares in float32.  A numpy evaluation would compare in float64 and
disagree for ``v == f32(8.1)``, which is why the filters never run on
the host.

The JAX package's builtin functions and its null test are numpy
closures that its dense step cannot trace, so a function call or an
``is null`` in a device filter is refused here at compile time; a user
function (an extension or a ``define function`` script) is unknown
here, as in the reference, and its query runs on the host.  ``expr in
Table`` raises as the reference's device compilers do: they have no
table resolver.

Java arithmetic semantics are preserved where they differ from Python's:
integer division truncates toward zero and integer remainder takes the
dividend's sign.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from siddhi_tpu_torch.core.exceptions import (
    DeviceUncompilableError,
    SiddhiAppCreationError,
)
from siddhi_tpu_torch.query_api import (
    AndOp,
    ArithmeticOp,
    AttrType,
    CompareOp,
    Constant,
    Expression,
    FunctionCall,
    InOp,
    IsNull,
    NotOp,
    OrOp,
    TimeConstant,
    Variable,
)
from siddhi_tpu_torch.query_api.attribute import promote

# env keys for batch metadata
TS_KEY = "__ts"
N_KEY = "__n"

# aggregator names handled by a selector, the device query rewrite or
# the aggregation rewrite, not scalar functions
AGGREGATOR_NAMES = {
    "sum", "avg", "count", "min", "max", "minForever", "maxForever",
    "stdDev", "distinctCount", "and", "or", "unionSet",
}


@dataclass
class CompiledExpression:
    fn: Callable[[Dict[str, object]], object]
    type: AttrType

    def __call__(self, env: Dict[str, object]):
        return self.fn(env)


class Scope:
    """Resolves a Variable to (env column key, AttrType).

    For single-stream queries keys are bare attribute names; for
    patterns the planner registers qualified keys like ``e1.price`` as
    well.
    """

    def __init__(self):
        # attr name -> (key, type); ambiguous bare names map to None
        self._bare: Dict[str, Optional[Tuple[str, AttrType]]] = {}
        # (stream_ref, attr) -> (key, type)
        self._qualified: Dict[Tuple[str, str], Tuple[str, AttrType]] = {}
        # stream refs known to the scope (e.g. pattern event refs)
        self.stream_refs: set = set()

    def add(self, stream_ref: str, attr: str, key: str, attr_type: AttrType):
        """Register ``stream_ref.attr`` (and bare ``attr`` unless another
        stream's attribute of that name makes it ambiguous)."""
        self.stream_refs.add(stream_ref)
        self._qualified[(stream_ref, attr)] = (key, attr_type)
        if attr in self._bare:
            existing = self._bare[attr]
            if existing is not None and existing[0] != key:
                self._bare[attr] = None  # ambiguous — stays ambiguous
        else:
            self._bare[attr] = (key, attr_type)

    def add_bare(self, name: str, attr_type: AttrType):
        """Register an unqualified name (aggregation base fields and
        outputs, select aliases)."""
        self._bare[name] = (name, attr_type)

    def clone(self) -> "Scope":
        s = Scope()
        s._bare = dict(self._bare)
        s._qualified = dict(self._qualified)
        s.stream_refs = set(self.stream_refs)
        return s

    def add_alias(self, alias: str, stream_ref: str):
        """Make ``alias.attr`` resolve like ``stream_ref.attr``."""
        self.stream_refs.add(alias)
        for (ref, attr), v in list(self._qualified.items()):
            if ref == stream_ref:
                self._qualified[(alias, attr)] = v

    def resolve(self, var: Variable) -> Tuple[str, AttrType]:
        if var.stream_id is not None:
            hit = self._qualified.get((var.stream_id, var.attribute))
            if hit is None:
                raise SiddhiAppCreationError(
                    f"cannot resolve attribute '{var.stream_id}.{var.attribute}'"
                )
            return hit
        hit = self._bare.get(var.attribute)
        if hit is None:
            if var.attribute in self._bare:
                raise SiddhiAppCreationError(
                    f"attribute '{var.attribute}' is ambiguous; qualify with stream name"
                )
            raise SiddhiAppCreationError(f"cannot resolve attribute '{var.attribute}'")
        return hit


_CMP = {
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}


def _java_int_div(a, b):
    q = a // b
    r = a - q * b
    # floor division -> truncation when signs differ and remainder != 0
    adjust = (r != 0) & ((a < 0) != (b < 0))
    return q + adjust


def _java_int_mod(a, b):
    r = a % b
    adjust = (r != 0) & ((a < 0) != (b < 0))
    return r - b * adjust


_NUMERIC_NP = {
    AttrType.INT: np.int32,
    AttrType.LONG: np.int64,
    AttrType.FLOAT: np.float32,
    AttrType.DOUBLE: np.float64,
}


class ExpressionCompiler:
    """Compiles expression trees against a Scope."""

    def __init__(self, scope: Scope):
        self.scope = scope

    @staticmethod
    def _meet(a, b):
        """The two operands of a comparison or an arithmetic op where
        they meet; a subclass may adjust them (the dense compiler
        flushes float32 subnormals there)."""
        return a, b

    def compile(self, expr: Expression) -> CompiledExpression:
        m = getattr(self, "_c_" + type(expr).__name__, None)
        if m is None:
            raise DeviceUncompilableError(
                f"cannot compile expression node {type(expr).__name__} "
                "on the device path")
        return m(expr)

    # ---- leaves -----------------------------------------------------------

    def _c_Constant(self, e: Constant) -> CompiledExpression:
        v = e.value
        if e.type.is_numeric:
            v = _NUMERIC_NP[e.type](v)
        return CompiledExpression(lambda env: v, e.type)

    def _c_TimeConstant(self, e: TimeConstant) -> CompiledExpression:
        v = np.int64(e.value)
        return CompiledExpression(lambda env: v, AttrType.LONG)

    def _c_Variable(self, e: Variable) -> CompiledExpression:
        key, t = self.scope.resolve(e)
        return CompiledExpression(lambda env: env[key], t)

    # ---- boolean ----------------------------------------------------------

    def _c_AndOp(self, e: AndOp) -> CompiledExpression:
        l, r = self.compile(e.left), self.compile(e.right)
        return CompiledExpression(lambda env: l.fn(env) & r.fn(env), AttrType.BOOL)

    def _c_OrOp(self, e: OrOp) -> CompiledExpression:
        l, r = self.compile(e.left), self.compile(e.right)
        return CompiledExpression(lambda env: l.fn(env) | r.fn(env), AttrType.BOOL)

    def _c_NotOp(self, e: NotOp) -> CompiledExpression:
        c = self.compile(e.expr)
        return CompiledExpression(lambda env: ~c.fn(env), AttrType.BOOL)

    def _c_CompareOp(self, e: CompareOp) -> CompiledExpression:
        l, r = self.compile(e.left), self.compile(e.right)
        cmp, meet = _CMP[e.op], self._meet
        return CompiledExpression(
            lambda env: cmp(*meet(l.fn(env), r.fn(env))), AttrType.BOOL)

    # ---- arithmetic -------------------------------------------------------

    def _c_ArithmeticOp(self, e: ArithmeticOp) -> CompiledExpression:
        l, r = self.compile(e.left), self.compile(e.right)
        if not (l.type.is_numeric and r.type.is_numeric):
            raise SiddhiAppCreationError(
                f"arithmetic '{e.op}' on non-numeric types {l.type}/{r.type}"
            )
        out_t = promote(l.type, r.type)
        is_int = out_t in (AttrType.INT, AttrType.LONG)
        op = e.op
        if op == "+":
            raw = lambda a, b: a + b
        elif op == "-":
            raw = lambda a, b: a - b
        elif op == "*":
            raw = lambda a, b: a * b
        elif op == "/":
            raw = _java_int_div if is_int else (lambda a, b: a / b)
        elif op == "%":
            raw = _java_int_mod if is_int else (lambda a, b: a % b)
        else:
            raise SiddhiAppCreationError(f"unknown arithmetic op {op!r}")
        meet = self._meet
        return CompiledExpression(
            lambda env: raw(*meet(l.fn(env), r.fn(env))), out_t)

    def _c_FunctionCall(self, e: FunctionCall) -> CompiledExpression:
        from siddhi_tpu_torch.planner.host_expr import BUILTIN_FUNCTIONS

        # the reference's order: the name (a user function is unknown to
        # the device compiler), then the arguments
        name = (e.namespace + ":" if e.namespace else "") + e.name
        if name not in BUILTIN_FUNCTIONS:
            raise DeviceUncompilableError(f"unknown function '{name}()'")
        for a in e.args:
            self.compile(a)
        raise DeviceUncompilableError(
            f"function '{name}()' is not supported in a device filter")

    def _c_InOp(self, e: InOp) -> CompiledExpression:
        # the reference's device compilers have no table resolver: the
        # query (or pattern) runs on the host, as there
        raise SiddhiAppCreationError(
            f"'IN {e.source_id}': no table resolver in this context")

    def _c_IsNull(self, e: IsNull) -> CompiledExpression:
        self.compile(e.expr)
        raise DeviceUncompilableError(
            "cannot compile expression node IsNull on the device path")
