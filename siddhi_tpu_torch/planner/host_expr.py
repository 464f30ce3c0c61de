"""Host expression compiler: query_api expression tree -> numpy closure.

Port of the host half of the JAX package's ``planner/expr.py``.  The
aggregation runtime and on-demand queries evaluate on the host with
numpy, as the JAX package does: DOUBLE arithmetic in float64, object
(string) columns, int64 timestamps.  None of it goes through torch
(``planner/expr.py`` compiles the device filters).

Compared with the device compiler it adds the reference's null
semantics for object columns (a null compares false and propagates
through arithmetic), ``is null``, the pattern presence test ``e1[1] is
null`` and the builtin scalar functions.  The host pattern engine
(``ops/nfa.py``) evaluates these closures on Python scalars, one event
at a time.  The
``expr in Table`` membership test belongs to the table slice of the port
and is refused.

Java arithmetic semantics are preserved where they differ from numpy:
integer division truncates toward zero and integer remainder takes the
dividend's sign.
"""

from __future__ import annotations

import uuid as _uuid
from typing import Callable, Dict, List

import numpy as np

from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.planner.expr import (
    _CMP,
    AGGREGATOR_NAMES,
    _NUMERIC_NP,
    N_KEY,
    TS_KEY,
    CompiledExpression,
    Scope,
    _java_int_div,
    _java_int_mod,
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
    IsNullStream,
    NotOp,
    OrOp,
    TimeConstant,
    Variable,
)
from siddhi_tpu_torch.query_api.attribute import promote

__all__ = ["AGGREGATOR_NAMES", "CompiledExpression", "ExpressionCompiler",
           "N_KEY", "Scope", "TS_KEY"]


def _null_safe_compare(a, b, op: str):
    """Comparison where null (None in object lanes) compares false
    instead of raising, matching the reference's null-comparison
    semantics.  Engages only for object-dtype operands."""
    if getattr(a, "dtype", None) != object and getattr(b, "dtype", None) != object:
        return _CMP[op](a, b)
    a_arr, b_arr = np.broadcast_arrays(
        np.atleast_1d(np.asarray(a, dtype=object)), np.atleast_1d(np.asarray(b, dtype=object)))
    none_mask = (a_arr == None) | (b_arr == None)  # noqa: E711 — elementwise
    if not none_mask.any():
        return _CMP[op](a_arr, b_arr)
    out = np.zeros(a_arr.shape, dtype=bool)
    ok = ~none_mask
    if ok.any():
        out[ok] = np.frompyfunc(_CMP[op], 2, 1)(a_arr[ok], b_arr[ok]).astype(bool)
    return out


def _null_safe_arith(a, b, op):
    """Arithmetic where null (None in object lanes) propagates to a null
    result instead of raising, matching the reference's arithmetic
    executors.  Engages only for object-dtype operands."""
    if getattr(a, "dtype", None) != object and getattr(b, "dtype", None) != object:
        return op(a, b)
    a_arr, b_arr = np.broadcast_arrays(
        np.atleast_1d(np.asarray(a, dtype=object)),
        np.atleast_1d(np.asarray(b, dtype=object)))
    none_mask = (a_arr == None) | (b_arr == None)  # noqa: E711 — elementwise
    if not none_mask.any():
        return np.frompyfunc(op, 2, 1)(a_arr, b_arr)
    out = np.empty(a_arr.shape, dtype=object)
    out[none_mask] = None
    ok = ~none_mask
    if ok.any():
        out[ok] = np.frompyfunc(op, 2, 1)(a_arr[ok], b_arr[ok])
    return out


class ExpressionCompiler:
    """Compiles expression trees against a Scope into numpy closures."""

    def __init__(self, scope: Scope, functions: Dict[str, Callable] = None):
        self.scope = scope
        # the builtins, then the app's user functions (extensions and
        # ``define function`` scripts), name -> builder
        self.functions = dict(BUILTIN_FUNCTIONS)
        if functions:
            self.functions.update(functions)

    def compile(self, expr: Expression) -> CompiledExpression:
        m = getattr(self, "_c_" + type(expr).__name__, None)
        if m is None:
            raise SiddhiAppCreationError(f"cannot compile expression node {type(expr).__name__}")
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
        op = e.op
        return CompiledExpression(
            lambda env: _null_safe_compare(l.fn(env), r.fn(env), op), AttrType.BOOL)

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
        return CompiledExpression(
            lambda env: _null_safe_arith(l.fn(env), r.fn(env), raw), out_t)

    # ---- null / membership ------------------------------------------------

    def _c_IsNull(self, e: IsNull) -> CompiledExpression:
        c = self.compile(e.expr)

        # dispatch on the runtime dtype: nulls ride object-dtype columns
        # whatever the attribute's declared type
        def fn(env):
            v = np.asarray(c.fn(env))
            if v.dtype == object:
                return np.frompyfunc(
                    lambda x: (x is None
                               or (isinstance(x, float) and np.isnan(x))),
                    1, 1)(v).astype(bool)
            if v.dtype.kind == "f":
                return np.isnan(v)
            # native int/bool lanes have no null representation
            return np.zeros(v.shape, dtype=bool)

        return CompiledExpression(fn, AttrType.BOOL)

    def _c_IsNullStream(self, e: IsNullStream) -> CompiledExpression:
        # `e1[1] is null` in a pattern: the host pattern engine supplies
        # the presence of each referenced capture as `__present.<ref>[i]`
        idx = e.stream_index if e.stream_index is not None else 0
        key = f"__present.{e.stream_id}[{idx}]"
        return CompiledExpression(lambda env: ~env[key], AttrType.BOOL)

    def _c_InOp(self, e: InOp) -> CompiledExpression:
        raise SiddhiAppCreationError(
            f"'in {e.source_id}': tables — a later slice of the port")

    # ---- functions --------------------------------------------------------

    def _c_FunctionCall(self, e: FunctionCall) -> CompiledExpression:
        name = (e.namespace + ":" if e.namespace else "") + e.name
        builder = self.functions.get(name)
        if builder is None:
            raise SiddhiAppCreationError(f"unknown function '{name}()'")
        args = [self.compile(a) for a in e.args]
        return builder(args)


# ---------------------------------------------------------------------------
# Builtin scalar functions (reference: core/executor/function/*)
# ---------------------------------------------------------------------------


_CAST_TARGETS = {
    "string": AttrType.STRING,
    "int": AttrType.INT,
    "long": AttrType.LONG,
    "float": AttrType.FLOAT,
    "double": AttrType.DOUBLE,
    "bool": AttrType.BOOL,
}


def _to_type(arr, t: AttrType):
    if t == AttrType.STRING:
        a = np.asarray(arr)
        return np.frompyfunc(lambda x: None if x is None else str(x), 1, 1)(a)
    if t == AttrType.BOOL:
        a = np.asarray(arr)
        if a.dtype == object:
            out = np.frompyfunc(
                lambda x: (None if x is None
                           else x if isinstance(x, bool)
                           else str(x).lower() == "true"), 1, 1
            )(a)
            if any(x is None for x in out.reshape(-1).tolist()):
                return out
            return out.astype(bool)
        return a.astype(bool)
    dt = _NUMERIC_NP[t]
    a = np.asarray(arr)
    if a.dtype == object:
        # null-safe: None converts to None; the column stays object-dtype
        # when any null is present
        out = np.frompyfunc(
            lambda x: None if x is None else dt(float(x)), 1, 1)(a)
        if any(x is None for x in out.reshape(-1).tolist()):
            return out
        return out.astype(dt)
    return a.astype(dt)


def _fn_cast(args: List[CompiledExpression]) -> CompiledExpression:
    if len(args) != 2:
        raise SiddhiAppCreationError("cast(value, 'type') needs 2 args")
    target = args[1].fn({})
    t = _CAST_TARGETS.get(str(target).lower())
    if t is None:
        raise SiddhiAppCreationError(f"cast: unknown target type {target!r}")
    v = args[0]
    return CompiledExpression(lambda env: _to_type(v.fn(env), t), t)


def _fn_coalesce(args: List[CompiledExpression]) -> CompiledExpression:
    if not args:
        raise SiddhiAppCreationError("coalesce() needs at least 1 arg")
    t = args[0].type

    def fn(env):
        out = np.asarray(args[0].fn(env))
        if out.dtype == object:
            out = out.copy()
            for a in args[1:]:
                nulls = np.frompyfunc(lambda x: x is None, 1, 1)(out).astype(bool)
                if not nulls.any():
                    break
                out[nulls] = np.broadcast_to(np.asarray(a.fn(env), dtype=object), out.shape)[nulls]
            return out
        if np.issubdtype(out.dtype, np.floating):
            for a in args[1:]:
                nulls = np.isnan(out)
                if not nulls.any():
                    break
                out = np.where(nulls, a.fn(env), out)
            return out
        return out

    return CompiledExpression(fn, t)


def _fn_if_then_else(args: List[CompiledExpression]) -> CompiledExpression:
    if len(args) != 3:
        raise SiddhiAppCreationError("ifThenElse(cond, then, else) needs 3 args")
    cond, then_e, else_e = args
    t = then_e.type if then_e.type != AttrType.OBJECT else else_e.type

    def fn(env):
        c = cond.fn(env)
        a = then_e.fn(env)
        b = else_e.fn(env)
        if getattr(a, "dtype", None) == object or getattr(b, "dtype", None) == object:
            return np.where(np.asarray(c), np.asarray(a, dtype=object),
                            np.asarray(b, dtype=object))
        return np.where(c, a, b)

    return CompiledExpression(fn, t)


def _fn_uuid(args: List[CompiledExpression]) -> CompiledExpression:
    def fn(env):
        n = env[N_KEY]
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = str(_uuid.uuid4())
        return out

    return CompiledExpression(fn, AttrType.STRING)


def _fn_event_timestamp(args: List[CompiledExpression]) -> CompiledExpression:
    return CompiledExpression(lambda env: env[TS_KEY], AttrType.LONG)


def _fn_current_time_millis(args: List[CompiledExpression]) -> CompiledExpression:
    import time as _time

    return CompiledExpression(
        lambda env: np.int64(int(_time.time() * 1000)), AttrType.LONG
    )


def _minmax(args: List[CompiledExpression], is_max: bool) -> CompiledExpression:
    if not args:
        raise SiddhiAppCreationError("maximum()/minimum() need args")
    t = args[0].type
    for a in args[1:]:
        t = promote(t, a.type)

    def fn(env):
        vals = [a.fn(env) for a in args]
        out = vals[0]
        for v in vals[1:]:
            out = np.maximum(out, v) if is_max else np.minimum(out, v)
        return out

    return CompiledExpression(fn, t)


def _instance_of(py_check) -> Callable:
    def builder(args: List[CompiledExpression]) -> CompiledExpression:
        v = args[0]

        def fn(env):
            a = np.asarray(v.fn(env))
            if a.dtype == object:
                return np.frompyfunc(py_check, 1, 1)(a).astype(bool)
            ok = py_check(a.dtype.type(0))
            n = a.shape[0] if a.ndim else 1
            return np.full(n, ok, dtype=bool)

        return CompiledExpression(fn, AttrType.BOOL)

    return builder


def _fn_sqrt(args: List[CompiledExpression]) -> CompiledExpression:
    if len(args) != 1:
        raise SiddhiAppCreationError("sqrt(value) needs 1 arg")
    v = args[0]

    def fn(env):
        with np.errstate(invalid="ignore"):
            return np.sqrt(np.asarray(v.fn(env), dtype=np.float64))

    return CompiledExpression(fn, AttrType.DOUBLE)


BUILTIN_FUNCTIONS: Dict[str, Callable] = {
    "sqrt": _fn_sqrt,
    "cast": _fn_cast,
    "convert": _fn_cast,
    "coalesce": _fn_coalesce,
    "default": _fn_coalesce,
    "ifThenElse": _fn_if_then_else,
    "UUID": _fn_uuid,
    "eventTimestamp": _fn_event_timestamp,
    "currentTimeMillis": _fn_current_time_millis,
    "maximum": lambda args: _minmax(args, True),
    "minimum": lambda args: _minmax(args, False),
    "instanceOfString": _instance_of(lambda x: isinstance(x, str)),
    "instanceOfBoolean": _instance_of(lambda x: isinstance(x, (bool, np.bool_))),
    "instanceOfInteger": _instance_of(
        lambda x: isinstance(x, (int, np.int32)) and not isinstance(x, bool)
    ),
    "instanceOfLong": _instance_of(lambda x: isinstance(x, (int, np.int64)) and not isinstance(x, bool)),
    "instanceOfFloat": _instance_of(lambda x: isinstance(x, (float, np.float32))),
    "instanceOfDouble": _instance_of(lambda x: isinstance(x, (float, np.float64))),
}
