"""Device path for general single-stream queries, in torch ops.

Port of the JAX package's ``ops/device_query.py``.  A filter, window and
group-by query (the reference's ProcessStreamReceiver → FilterProcessor
→ window processor → QuerySelector) runs as one step over a columnar
micro-batch:

- **filter**: the compiled expression tree gives a boolean mask over
  the batch;
- **windows**: fixed-capacity ring buffers on the device.  Sliding
  aggregates (length/time) take a ``[B, W]`` window gather, a membership
  mask and a reduction, every output row at once.  Passing rows are
  compacted with a prefix-sum scatter, so filtered rows never take a
  window slot;
- **group by**: group keys are interned on the host to dense ids; the
  per-group aggregator state is ``[G, A]`` device rows, and the running
  prefixes within a batch are a masked ``[B, B]`` same-group matmul;
- **tumbling windows** (lengthBatch/timeBatch): per-group accumulators
  and a flush step emitting one row per touched group; the host splits
  batches at pane boundaries.

The JAX step is jitted XLA with no Pallas kernel, so here it is torch
ops, with three choices of the port's own:

- the state scatters of the running and tumbling accumulators go
  through ``kernels.bank_scatter.accumulate_`` (in place, one launch a
  lane kind, deterministic, with XLA's float min/max), never through
  float atomics, so two card runs of one input give the same bits;
- the ``[B, B]`` prefix products run in float64 and round once to
  float32, so the caller's ``torch.set_float32_matmul_precision`` (TF32)
  cannot reach them, and no process-wide setting is touched;
- the per-key ring buffers of partition mode are written in place: a
  row that the reference sends to a scratch row writes, instead, the
  value that the slot's one real write carries (or the slot's own), so
  every write to a slot carries the same bits.

Other state is replaced, not written in place, so an output a pending
emit still holds never aliases state a later step changes.

Subset (the reference's; the planner runs the host chain otherwise): one
input stream, filters before at most one window of ``length``,
``time``, ``lengthBatch`` or ``timeBatch``; the aggregators sum, count,
avg, min, max, stdDev, minForever, maxForever, and, or; numeric and
bool lanes (INT as int32, FLOAT and DOUBLE as float32, LONG as a hi/lo
int32 pair for comparisons only; a LONG elsewhere in a device
expression is ineligible); tumbling selects of group keys and
aggregates only.  A time window holds at most ``window_capacity`` (1024)
passing events and drops the oldest past that, as the reference's
device path does.  Float32 lanes read subnormals as zeros of their sign,
as the reference's XLA on the CPU does.  Emitted columns are cast back
to their declared types.

Partition mode (``partition with (key of S)`` under
``@app:execution('tpu')``): the partition key arrives per row, composes
into the group axis, and scopes windows per key (one ``[W]`` ring row of
a ``[n_wgroups, W]`` state each); ``purge_idle_keys`` recycles the rows
of idle keys.  Tumbling windows are refused there (the reference falls
back to per-key host instances).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.core.emit_queue import fetch_coalesced
from siddhi_tpu_torch.core.exceptions import (
    SiddhiAppCreationError,
    SiddhiAppRuntimeError,
)
from siddhi_tpu_torch.core.ingest_stage import staged_put
from siddhi_tpu_torch.kernels.bank_scatter import accumulate_
from siddhi_tpu_torch.kernels.dense_step import flush_subnormals
from siddhi_tpu_torch.ops.dense_nfa import DenseExprCompiler, resolve_device
from siddhi_tpu_torch.planner.expr import (
    AGGREGATOR_NAMES,
    N_KEY,
    TS_KEY,
    CompiledExpression,
    ExpressionCompiler,
    Scope,
)
# group keys and window constants are evaluated on the host (interning),
# at native numpy width and any type, as in the reference
from siddhi_tpu_torch.planner.host_expr import (
    ExpressionCompiler as HostExpressionCompiler,
)
from siddhi_tpu_torch.query_api import (
    AndOp,
    ArithmeticOp,
    AttrType,
    CompareOp,
    Constant,
    Expression,
    Filter,
    FunctionCall,
    InOp,
    IsNull,
    NotOp,
    OrOp,
    OutputAttribute,
    Query,
    SingleInputStream,
    Variable,
    WindowHandler,
)

SUPPORTED_AGGS = ("sum", "count", "avg", "min", "max", "stdDev",
                  "minForever", "maxForever", "and", "or")
# distinctCount and unionSet keep unbounded per-group value sets: the
# host engine runs them
SUPPORTED_WINDOWS = (None, "length", "time", "lengthBatch", "timeBatch")

# aggregators whose window or running reduction is a masked sum of the
# argument lane (and/or over the bool lane)
_SUM_KINDS = ("sum", "avg", "stdDev", "and", "or")

PER_EVENT = "per_event"
PER_FLUSH = "per_flush"

# the per-event step's chunk bound: the running and keyed-sliding kinds
# build [B, B] masks; chunks advance the state in order
MAX_DEVICE_BATCH = 2048

_F32 = torch.float32
_I32 = torch.int32
_INF = float("inf")
# each scatter op's identity, the pad value of accumulate_'s events
_IDENTITY = {"sum": 0.0, "min": _INF, "max": -_INF}


@dataclass
class DeviceAgg:
    kind: str  # one of SUPPORTED_AGGS
    arg: Optional[CompiledExpression]  # None for count
    env_key: str


class DeviceQueryCompiler(DenseExprCompiler):
    """Compiler of device-evaluated expressions: LONG stream attributes
    (``pair_keys``) ride hi/lo int32 pair lanes, usable in comparisons
    only (bit-exact at any magnitude); INT keeps its int32 lane;
    synthetic LONG keys (``count()`` outputs) ride float32 lanes.  Of the
    builtin functions, the ones the reference's device trace accepts
    (``eventTimestamp()``, the batch's relative timestamp lane, and
    ``currentTimeMillis()``) compile; the others, numpy closures there,
    are ineligible."""

    PAIR_TYPES = (AttrType.LONG,)

    def __init__(self, scope: Scope, pair_keys):
        super().__init__(scope)
        self.pair_keys = set(pair_keys)

    def _i64_parts(self, e, var_only=False):
        if isinstance(e, Variable):
            key, _t = self.scope.resolve(e)
            if key not in self.pair_keys:
                return None
        return super()._i64_parts(e, var_only)

    def _c_Variable(self, e):
        key, t = self.scope.resolve(e)
        if t in self.PAIR_TYPES and key not in self.pair_keys:
            return ExpressionCompiler._c_Variable(self, e)
        return super()._c_Variable(e)

    def _c_FunctionCall(self, e):
        if e.namespace is None and e.name == "eventTimestamp":
            return CompiledExpression(lambda env: env[TS_KEY], AttrType.LONG)
        if e.namespace is None and e.name == "currentTimeMillis":
            return CompiledExpression(
                lambda env: np.int64(int(time.time() * 1000)), AttrType.LONG)
        return super()._c_FunctionCall(e)


def _split_i64(v: np.ndarray):
    """int64 column -> (hi, lo) int32 lanes; lo is bias-signed so signed
    int32 comparison of lo equals unsigned comparison of the low word."""
    v = np.asarray(v, dtype=np.int64)
    hi = (v >> 32).astype(np.int32)
    lo = ((v & 0xFFFFFFFF) - 2**31).astype(np.int32)
    return hi, lo


def _map_children(expr: Expression, fn) -> Expression:
    """Rebuild a composite expression node with ``fn`` applied to each
    child; leaves return unchanged.  The one structural walk of every
    AST pass in this module."""
    if isinstance(expr, ArithmeticOp):
        return ArithmeticOp(expr.op, fn(expr.left), fn(expr.right))
    if isinstance(expr, CompareOp):
        return CompareOp(expr.op, fn(expr.left), fn(expr.right))
    if isinstance(expr, AndOp):
        return AndOp(fn(expr.left), fn(expr.right))
    if isinstance(expr, OrOp):
        return OrOp(fn(expr.left), fn(expr.right))
    if isinstance(expr, NotOp):
        return NotOp(fn(expr.expr))
    if isinstance(expr, IsNull):
        return IsNull(fn(expr.expr))
    if isinstance(expr, FunctionCall):
        return FunctionCall(
            expr.namespace, expr.name, tuple(fn(a) for a in expr.args),
            expr.star)
    if isinstance(expr, InOp):
        return InOp(fn(expr.expr), expr.source_id)
    return expr


class _DeviceAggRewrite:
    """Replaces aggregator calls in select and having expressions with
    synthetic variables bound to the device aggregation outputs."""

    def __init__(self, scope: Scope, compiler: ExpressionCompiler):
        self.scope = scope
        self.compiler = compiler
        self.aggs: List[DeviceAgg] = []

    def rewrite(self, expr: Expression) -> Expression:
        if (isinstance(expr, FunctionCall) and expr.namespace is None
                and expr.name in AGGREGATOR_NAMES):
            if expr.name not in SUPPORTED_AGGS:
                raise SiddhiAppCreationError(
                    f"device query path does not support aggregator "
                    f"'{expr.name}'"
                    + (" (unbounded value sets need the host engine)"
                       if expr.name in ("distinctCount", "unionSet")
                       else ""))
            key = f"__dagg_{len(self.aggs)}"
            arg = None
            if expr.args:
                if len(expr.args) > 1:
                    raise SiddhiAppCreationError(
                        f"aggregator '{expr.name}' takes one argument")
                arg = self.compiler.compile(self.rewrite(expr.args[0]))
            elif expr.name != "count":
                raise SiddhiAppCreationError(
                    f"aggregator '{expr.name}' needs an argument")
            if expr.name in ("and", "or"):
                if arg is None or arg.type != AttrType.BOOL:
                    raise SiddhiAppCreationError(
                        f"aggregator '{expr.name}' needs a boolean argument")
                out_t = AttrType.BOOL
            elif expr.name == "count":
                out_t = AttrType.LONG
            else:
                out_t = AttrType.DOUBLE
            self.aggs.append(DeviceAgg(expr.name, arg, key))
            self.scope.add_bare(key, out_t)
            return Variable(attribute=key)
        if isinstance(expr, InOp):
            raise SiddhiAppCreationError(
                "device query path does not support table membership (IN)")
        return _map_children(expr, self.rewrite)


def _subst_aliases(expr: Expression, aliases: Dict[str, Expression]
                   ) -> Expression:
    """Replace bare references to select aliases with the select item's
    (aggregator-rewritten) expression; an alias shadows a same-named
    input attribute, as in the host selector's scope."""
    if isinstance(expr, Variable):
        if expr.stream_id is None and expr.attribute in aliases:
            return aliases[expr.attribute]
        return expr
    return _map_children(expr, lambda e: _subst_aliases(e, aliases))


def _pow2(n: int, floor: int = 16) -> int:
    return max(1 << (max(n, 1) - 1).bit_length(), floor)


def _prefix_mm(mask: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``mask @ vals`` for a 0/1 ``[B, B]`` mask and float32 ``vals``,
    summed in float64 and rounded once to float32: TF32, which the
    caller's matmul precision may allow, never touches it."""
    return (mask.to(torch.float64) @ vals.to(torch.float64)).to(_F32)


def _lane(x, B: int, device, dtype=None) -> torch.Tensor:
    """An expression's value as a ``[B]`` tensor.  A host constant is
    filled on the device (no copy crosses to it)."""
    if not isinstance(x, torch.Tensor):
        h = np.asarray(x)
        return torch.full((B,), h.item(), device=device,
                          dtype=dtype or torch.from_numpy(h).dtype)
    t = x if dtype is None else x.to(dtype)
    return t.expand(B) if t.dim() == 0 else t


def _scatter_(acc: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
              op: str):
    """``acc[rows[b], a] ⊕= vals[b, a]`` in place for ``acc [G, A]``, as
    XLA's ``acc.at[rows].add/min/max(vals)``: one ``accumulate_`` over
    the flattened rows, events padded to a power of two >= 256 with the
    op's identity on row 0."""
    A = acc.shape[1]
    flat = (rows.long()[:, None] * A
            + torch.arange(A, device=rows.device)).reshape(-1)
    v = vals.reshape(-1)
    n = v.numel()
    N = max(256, _pow2(n))
    if N > n:
        flat = torch.cat([flat, flat.new_zeros(N - n)])
        v = torch.cat([v, v.new_full((N - n,), _IDENTITY[op])])
    accumulate_(acc.view(-1), flat.to(_I32), v.contiguous(), op)


class DeviceQueryEngine:
    """One single-input query compiled into device steps.

    Usage::

        eng = compile_query(app_str, "q1", n_groups=1024, device="cpu")
        state = eng.init_state()
        state, rows = eng.process(state, cols, ts)   # rows: output dicts
    """

    def __init__(self, query: Query, stream_def, n_groups: int = 1024,
                 window_capacity: int = 1024, partition_mode: bool = False,
                 n_wgroups: Optional[int] = None,
                 defer_order_by: bool = False, device=None):
        self.device = resolve_device(device)
        self.query = query
        self.stream_def = stream_def
        self.n_groups = n_groups
        # partition mode: the partition key arrives per row, composes
        # into the group axis and scopes windows per key
        self.partition_mode = bool(partition_mode)
        self.n_wgroups = int(n_wgroups) if n_wgroups else n_groups
        self.ingest_stats = None  # set by the runtime

        s = query.input_stream
        if not isinstance(s, SingleInputStream):
            raise SiddhiAppCreationError(
                "device query path needs a single input stream")
        self.stream_id = s.stream_id

        # -- handler chain: filters then at most one window ------------------
        self.filter_exprs: List[Expression] = []
        self.window_name: Optional[str] = None
        self.window_args: List = []
        seen_window = False
        for h in s.handlers:
            if isinstance(h, Filter):
                if seen_window:
                    raise SiddhiAppCreationError(
                        "device query path: filters must precede the window")
                self.filter_exprs.append(h.expression)
            elif isinstance(h, WindowHandler):
                if seen_window:
                    raise SiddhiAppCreationError(
                        "device query path supports at most one window")
                seen_window = True
                self.window_name = h.name
                self.window_args = list(h.args)
            else:
                raise SiddhiAppCreationError(
                    f"device query path: unsupported handler "
                    f"{type(h).__name__}")
        if self.window_name not in SUPPORTED_WINDOWS:
            raise SiddhiAppCreationError(
                f"device query path does not support window "
                f"'{self.window_name}'")
        self.mode = (PER_FLUSH if self.window_name in ("lengthBatch",
                                                       "timeBatch")
                     else PER_EVENT)

        # -- scope and expressions --------------------------------------------
        self._lane_dtype: Dict[str, np.dtype] = {
            a.name: (np.dtype(np.int32) if a.type == AttrType.INT
                     else np.dtype(np.bool_) if a.type == AttrType.BOOL
                     else np.dtype(np.float32))
            for a in stream_def.attributes
            if (a.type.is_numeric or a.type == AttrType.BOOL)
            and a.type != AttrType.LONG
        }
        self.attrs = list(self._lane_dtype)
        self.long_attrs = [a.name for a in stream_def.attributes
                           if a.type == AttrType.LONG]
        self.all_attrs = list(stream_def.attribute_names)
        scope = Scope()
        for a in stream_def.attributes:
            scope.add(s.alias or s.stream_id, a.name, a.name, a.type)
            if s.alias:
                scope.add(s.stream_id, a.name, a.name, a.type)
        compiler = DeviceQueryCompiler(scope, self.long_attrs)
        host_compiler = HostExpressionCompiler(scope)

        self.filters = [compiler.compile(e) for e in self.filter_exprs]

        self.window_param: Optional[int] = None
        if self.window_name is not None:
            if not self.window_args:
                raise SiddhiAppCreationError(
                    f"window '{self.window_name}' needs an argument")
            c = host_compiler.compile(self.window_args[0])
            try:
                self.window_param = int(c.fn({}))
            except Exception as e:
                raise SiddhiAppCreationError(
                    f"window '{self.window_name}' argument must be constant"
                ) from e

        sel = query.selector
        self.group_exprs: List[CompiledExpression] = [
            host_compiler.compile(g) for g in (sel.group_by or [])]
        self.group_raw: List[Expression] = list(sel.group_by or [])
        self._numeric_group_keys = [
            i for i, g in enumerate(self.group_exprs) if g.type.is_numeric]

        rewriter = _DeviceAggRewrite(scope, compiler)
        if sel.selection is None:
            # select *: every input attribute passes through
            sel = type(sel)(
                selection=[OutputAttribute(Variable(attribute=a.name))
                           for a in stream_def.attributes],
                group_by=list(sel.group_by or []), having=sel.having,
                order_by=list(sel.order_by or []), limit=sel.limit,
                offset=sel.offset)
        # out_spec entries: ("expr", compiled) | ("group_key", key index)
        # | ("passthrough", attr name): passthroughs and group keys are
        # gathered on the host at native width (LONG and STRING too)
        self.out_spec: List[Tuple[str, object, str]] = []
        self._device_expr_raw: List[Expression] = []
        alias_map: Dict[str, Expression] = {}
        for oa in sel.selection:
            gk = self._as_group_key(oa.expression)
            if gk is not None:
                self.out_spec.append(("group_key", gk, oa.name))
                alias_map[oa.name] = oa.expression
                continue
            pt = self._as_passthrough(oa.expression, stream_def, s)
            if pt is not None:
                self.out_spec.append(("passthrough", pt, oa.name))
                alias_map[oa.name] = oa.expression
                continue
            rewritten = rewriter.rewrite(oa.expression)
            self.out_spec.append(("expr", compiler.compile(rewritten),
                                  oa.name))
            self._device_expr_raw.append(oa.expression)
            alias_map[oa.name] = rewritten
        self.aggs = rewriter.aggs
        self.out_types: List[AttrType] = []
        for kind, v, _name in self.out_spec:
            if kind == "group_key":
                self.out_types.append(self.group_exprs[v].type)
            elif kind == "passthrough":
                self.out_types.append(stream_def.attribute_type(v))
            else:
                self.out_types.append(v.type)
        self._check_value_types(stream_def, s, sel)
        self.having = (
            compiler.compile(rewriter.rewrite(
                _subst_aliases(sel.having, alias_map)))
            if sel.having is not None else None)
        # order by / limit / offset run in the planner's host selector
        # over each emitted chunk; the direct API has no such selector
        if not defer_order_by and (sel.order_by or sel.limit is not None
                                   or sel.offset is not None):
            raise SiddhiAppCreationError(
                "device query engine: order by/limit/offset need the "
                "planner's host-side selector (SiddhiManager path) — the "
                "direct compile_query API does not apply them")
        if self.mode == PER_FLUSH:
            for kind, v, name in self.out_spec:
                if kind == "passthrough" or (
                        kind == "expr" and not self._flush_expr_ok(v)):
                    raise SiddhiAppCreationError(
                        f"tumbling device query: select item '{name}' may "
                        "reference only group keys and aggregates")
        if self.mode == PER_EVENT and self.window_name is None \
                and not self.aggs:
            self.kind = "filter"  # stateless filter/projection
        elif self.mode == PER_EVENT and self.window_name is None:
            self.kind = "running"
        elif self.mode == PER_EVENT:
            self.kind = "sliding"
        else:
            self.kind = "tumbling"
        if self.partition_mode:
            if self.kind == "tumbling":
                raise SiddhiAppCreationError(
                    "partitioned tumbling windows need per-key pane "
                    "boundaries — per-key host instances used")
            if self.kind == "sliding":
                self.kind = "keyed_sliding"

        if self.kind in ("sliding", "keyed_sliding"):
            self.W = (int(self.window_param) if self.window_name == "length"
                      else int(window_capacity))
            if self.W < 1:
                raise SiddhiAppCreationError("window size must be >= 1")
        else:
            self.W = 0

        self._trace_check()

        # host interning and pane bookkeeping.  In partition mode the
        # group key is the tuple (partition key, *group keys); window
        # groups intern the partition key alone.  Purged ids return to
        # free lists once their rows are zeroed.
        self._group_ids: Dict = {}
        self._group_vals: List = []
        self._group_free: List[int] = []
        self._group_last: Dict[int, int] = {}
        self._wgrp_ids: Dict = {}
        self._wgrp_vals: List = []
        self._wgrp_free: List[int] = []
        self._wgrp_last = np.zeros(self.n_wgroups, dtype=np.int64)
        self._wgrp_in_use = np.zeros(self.n_wgroups, dtype=bool)
        # sorted key index of the vectorized intern; object or mixed key
        # dtypes fall back to dict probes
        self._wgrp_sorted_keys: Optional[np.ndarray] = None
        self._wgrp_sorted_ids: Optional[np.ndarray] = None
        self._wgrp_vector = True
        self.base_ts: Optional[int] = None
        self._pane_end: Optional[int] = None  # timeBatch
        self._pane_fill = 0  # passing events in the open pane
        self._prev_pane_fill = 0  # the previous pane's (idle detection)

    # -- compilation helpers -------------------------------------------------

    def _as_group_key(self, expr: Expression) -> Optional[int]:
        """A select item that is a group-by key -> its key index."""
        if not isinstance(expr, Variable):
            return None
        for i, g in enumerate(self.group_raw):
            if isinstance(g, Variable) and g.attribute == expr.attribute:
                return i
        return None

    @staticmethod
    def _as_passthrough(expr: Expression, stream_def, s) -> Optional[str]:
        """A select item that is a bare input attribute -> its name."""
        if not isinstance(expr, Variable):
            return None
        if expr.stream_id not in (None, s.stream_id, s.alias):
            return None
        if expr.attribute not in stream_def.attribute_names:
            return None
        return expr.attribute

    def _check_value_types(self, stream_def, s, sel):
        """Refuse a device-evaluated expression (filter, computed select
        item, aggregate argument, having) that uses a LONG attribute
        outside a plain comparison, or a LONG constant outside the int32
        range: LONG comparisons ride exact hi/lo pairs, but LONG
        arithmetic has no 64-bit lane.  Group keys and bare select items
        stay on the host and may be any type."""
        names = set(stream_def.attribute_names)
        ids = (None, s.stream_id, s.alias)

        def is_long_var(e):
            return (isinstance(e, Variable) and e.stream_id in ids
                    and e.attribute in names
                    and stream_def.attribute_type(e.attribute)
                    == AttrType.LONG)

        def walk(e):
            if isinstance(e, CompareOp) and (
                    is_long_var(e.left) or is_long_var(e.right)):
                return e  # the pair compare (or the compiler's refusal)
            if isinstance(e, Variable):
                if is_long_var(e):
                    raise SiddhiAppCreationError(
                        f"device query path: attribute '{e.attribute}' is "
                        "LONG and used outside a plain comparison; its "
                        "hi/lo lanes support comparisons only — host "
                        "engine used (LONG is fine as a group-by key, bare "
                        "select item, or comparison operand)")
                return e
            if (isinstance(e, Constant) and e.type == AttrType.LONG
                    and e.value is not None
                    and not -(2**31) <= int(e.value) < 2**31):
                raise SiddhiAppCreationError(
                    f"device query path: constant {e.value} exceeds the "
                    "int32 device lane — host engine used")
            return _map_children(e, walk)

        for f in self.filter_exprs:
            walk(f)
        for e in self._device_expr_raw:
            walk(e)
        if sel.having is not None:
            walk(sel.having)

    def _flush_expr_ok(self, compiled) -> bool:
        """A flush-time expression may read only aggregates and numeric
        group keys (tried on exactly that env)."""
        try:
            self._trial(compiled, self._flush_env())
            return True
        except Exception:
            return False

    def _trial_env(self, B: int = 8) -> Dict:
        env = {a: torch.zeros(B, dtype=torch.from_numpy(
            np.zeros(0, self._lane_dtype[a])).dtype) for a in self.attrs}
        for a in self.long_attrs:
            env[a + "|hi"] = torch.zeros(B, dtype=_I32)
            env[a + "|lo"] = torch.zeros(B, dtype=_I32)
        env[TS_KEY] = torch.zeros(B, dtype=_I32)
        env[N_KEY] = B
        for a in self.aggs:
            env[a.env_key] = torch.zeros(
                B, dtype=torch.bool if a.kind in ("and", "or") else _F32)
        return env

    def _flush_env(self, G: int = 8) -> Dict:
        env = {a.env_key: torch.zeros(
            G, dtype=torch.bool if a.kind in ("and", "or") else _F32)
            for a in self.aggs}
        for i in self._numeric_group_keys:
            g = self.group_raw[i]
            if isinstance(g, Variable):
                env[g.attribute] = torch.zeros(G, dtype=_F32)
        env[N_KEY] = G
        return env

    @staticmethod
    def _trial(compiled, env):
        """Evaluate on a small zero env of CPU tensors: what the step
        cannot evaluate (a string lane, a host-only function, a bitwise
        op on floats) raises here."""
        B = env[N_KEY]
        _lane(compiled.fn(env), B, "cpu").to(_F32)

    def _trace_check(self):
        """Plan-time eligibility: every device expression evaluates on a
        trial env of the lanes the step provides (the reference traces
        the step abstractly)."""
        env = self._trial_env()
        try:
            for f in self.filters:
                self._trial(f, env)
            for a in self.aggs:
                if a.arg is not None:
                    self._trial(a.arg, env)
            items = ([v for k, v, _n in self.out_spec if k == "expr"]
                     + ([self.having] if self.having is not None else []))
            probe_env = env if self.mode == PER_EVENT else self._flush_env()
            for v in items:
                self._trial(v, probe_env)
        except SiddhiAppCreationError:
            raise
        except Exception as e:
            raise SiddhiAppCreationError(
                f"query not device-eligible (expression not evaluable on "
                f"the device lanes): {e}") from e

    # -- state ---------------------------------------------------------------

    def init_state(self) -> Dict[str, torch.Tensor]:
        return staged_put(self.init_state_host(), self.device,
                          self.ingest_stats)

    def init_state_host(self) -> Dict[str, np.ndarray]:
        """The zero state as numpy arrays, in the reference's layout (the
        same keys, shapes and dtypes, so snapshots cross packages)."""
        A = max(len(self.aggs), 1)
        G = self.n_groups
        state = {}
        kinds = {a.kind for a in self.aggs}
        f32 = np.float32
        if self.kind == "sliding":
            W = self.W
            state["win_vals"] = np.zeros((W, A), dtype=f32)
            state["win_ts"] = np.zeros(W, dtype=np.int32)
            state["win_grp"] = np.zeros(W, dtype=np.int32)
            state["win_valid"] = np.zeros(W, dtype=bool)
        elif self.kind == "keyed_sliding":
            Gw, W = self.n_wgroups, self.W
            state["win_vals"] = np.zeros((Gw, W, A), dtype=f32)
            state["win_ts"] = np.zeros((Gw, W), dtype=np.int32)
            state["win_grp"] = np.zeros((Gw, W), dtype=np.int32)
            state["win_valid"] = np.zeros((Gw, W), dtype=bool)
            state["win_count"] = np.zeros(Gw, dtype=np.int32)
        elif self.kind in ("running", "tumbling"):
            if kinds & set(_SUM_KINDS):
                state["acc_sum"] = np.zeros((G, A), dtype=f32)
            if "stdDev" in kinds:
                state["acc_sumsq"] = np.zeros((G, A), dtype=f32)
            state["acc_cnt"] = np.zeros((G, A), dtype=f32)
            if "min" in kinds:
                state["acc_min"] = np.full((G, A), np.inf, dtype=f32)
            if "max" in kinds:
                state["acc_max"] = np.full((G, A), -np.inf, dtype=f32)
            if self.kind == "tumbling":
                state["touched"] = np.zeros(G, dtype=bool)
                K = max(len(self._numeric_group_keys), 1)
                state["grp_keys"] = np.zeros((G, K), dtype=f32)
        # all-time accumulators, never reset by expiry or a flush
        if self.kind != "filter":
            if "minForever" in kinds:
                state["acc_minf"] = np.full((G, A), np.inf, dtype=f32)
            if "maxForever" in kinds:
                state["acc_maxf"] = np.full((G, A), -np.inf, dtype=f32)
        return state

    def state_to_host(self, state) -> Dict[str, np.ndarray]:
        """The device state fetched as numpy copies (one coalesced
        fetch)."""
        keys = list(state)
        return dict(zip(keys, fetch_coalesced([state[k] for k in keys])))

    def state_from_host(self, host) -> Dict[str, torch.Tensor]:
        """Numpy state (this engine's or the reference's snapshot) on the
        device; the shapes must be this engine's."""
        expect = {k: v.shape for k, v in self.init_state_host().items()}
        for k, v in host.items():
            if k in expect and np.shape(v) != expect[k]:
                raise SiddhiAppRuntimeError(
                    f"device-query snapshot '{k}' has shape {np.shape(v)}; "
                    f"this engine expects {expect[k]}")
        return staged_put({k: np.array(v, copy=True) for k, v in
                           host.items()}, self.device, self.ingest_stats)

    # -- step pieces ---------------------------------------------------------

    def _base_env(self, cols, ts, B):
        env = {}
        for a in self.attrs:
            if a in cols:
                c = cols[a]
                env[a] = flush_subnormals(c) if c.dtype == _F32 else c
        for a in self.long_attrs:
            hk, lk = a + "|hi", a + "|lo"
            if hk in cols:
                env[hk] = cols[hk]
                env[lk] = cols[lk]
        env[TS_KEY] = ts
        env[N_KEY] = B
        return env

    def _filter_mask(self, env, valid):
        m = valid
        for f in self.filters:
            m = m & _lane(f.fn(env), valid.shape[0], valid.device,
                          torch.bool)
        return m

    def _arg_vals(self, env, B):
        """``[B, A]`` float32 aggregate arguments (count: ones)."""
        dev = env[TS_KEY].device
        if not self.aggs:
            return torch.ones((B, 1), dtype=_F32, device=dev)
        cols = []
        for a in self.aggs:
            if a.arg is None:
                cols.append(torch.ones(B, dtype=_F32, device=dev))
            else:
                cols.append(_lane(a.arg.fn(env), B, dev, _F32))
        return torch.stack(cols, dim=-1)

    def _emit(self, env_out, fmask, B):
        """Select items and having -> ``(out_valid, {name: [B]})``; each
        computed column keeps its declared type's lane (INT int32, BOOL
        bool, else float32), as its own tensor."""
        dev = fmask.device
        out = {}
        for kind, v, name in self.out_spec:
            if kind in ("group_key", "passthrough"):
                continue  # gathered on the host
            dt = (_I32 if v.type == AttrType.INT
                  else torch.bool if v.type == AttrType.BOOL else _F32)
            out[name] = _lane(v.fn(env_out), B, dev, dt).clone()
        if self.having is not None:
            fmask = fmask & _lane(self.having.fn(env_out), B, dev,
                                  torch.bool)
        return fmask, out

    def _finalize_aggs(self, env_out, wsum, wcnt, wsumsq=None, wmin=None,
                       wmax=None, fmin=None, fmax=None):
        """Reduced moments -> aggregator output lanes.  ``and`` is no
        false member (count == sum), ``or`` some true member (sum > 0)."""
        for ai, a in enumerate(self.aggs):
            k = a.kind
            if k == "sum":
                env_out[a.env_key] = wsum[:, ai]
            elif k == "count":
                env_out[a.env_key] = wcnt[:, 0]
            elif k == "avg":
                env_out[a.env_key] = wsum[:, ai] / wcnt[:, 0].clamp_min(1.0)
            elif k == "stdDev":
                # population stddev from (sum, sumsq, n) in float32
                nn = wcnt[:, 0].clamp_min(1.0)
                mean = wsum[:, ai] / nn
                var = (wsumsq[:, ai] / nn - mean * mean).clamp_min(0.0)
                env_out[a.env_key] = torch.sqrt(var)
            elif k == "min":
                env_out[a.env_key] = wmin[:, ai]
            elif k == "max":
                env_out[a.env_key] = wmax[:, ai]
            elif k == "minForever":
                env_out[a.env_key] = fmin[:, ai]
            elif k == "maxForever":
                env_out[a.env_key] = fmax[:, ai]
            elif k == "and":
                env_out[a.env_key] = (wcnt[:, 0] - wsum[:, ai]) < 0.5
            else:  # or
                env_out[a.env_key] = wsum[:, ai] > 0.5

    def _kinds(self):
        return {a.kind for a in self.aggs}

    @staticmethod
    def _masked_min(mask, vals):
        """``[n, B, A]`` masked min over the batch axis (inf if empty)."""
        return torch.where(mask[:, :, None], vals[None, :, :], _INF).amin(1)

    @staticmethod
    def _masked_max(mask, vals):
        return torch.where(mask[:, :, None], vals[None, :, :], -_INF).amax(1)

    def _prefix_minmax(self, argvals, grp, fmask, B, need_min, need_max):
        """Within-batch same-group running min/max including self."""
        tri = torch.ones((B, B), dtype=torch.bool,
                         device=argvals.device).tril()
        same = tri & (grp[:, None] == grp[None, :]) & fmask[None, :]
        pmin = self._masked_min(same, argvals) if need_min else None
        pmax = self._masked_max(same, argvals) if need_max else None
        return pmin, pmax

    def _forever_rows(self, state, argvals, grp, fmask, B,
                      pmin=None, pmax=None):
        """Per-row all-time min/max: the accumulator before the batch
        with the within-batch same-group prefix."""
        kinds = self._kinds()
        need_min = "minForever" in kinds and pmin is None
        need_max = "maxForever" in kinds and pmax is None
        if need_min or need_max:
            cmin, cmax = self._prefix_minmax(argvals, grp, fmask, B,
                                             need_min, need_max)
            pmin = pmin if pmin is not None else cmin
            pmax = pmax if pmax is not None else cmax
        fmin = fmax = None
        if "minForever" in kinds:
            fmin = torch.minimum(state["acc_minf"][grp], pmin)
        if "maxForever" in kinds:
            fmax = torch.maximum(state["acc_maxf"][grp], pmax)
        return fmin, fmax

    @staticmethod
    def _forever_scatter(state, argvals, grp, fmask):
        upd = fmask[:, None]
        if "acc_minf" in state:
            _scatter_(state["acc_minf"], grp,
                      torch.where(upd, argvals, _INF), "min")
        if "acc_maxf" in state:
            _scatter_(state["acc_maxf"], grp,
                      torch.where(upd, argvals, -_INF), "max")

    def _acc_scatter(self, state, argvals, grp, fmask):
        """The running/tumbling accumulators ⊕= the batch's passing
        rows, in place."""
        upd = fmask[:, None]
        if "acc_sum" in state:
            _scatter_(state["acc_sum"], grp,
                      torch.where(upd, argvals, 0.0), "sum")
        if "acc_sumsq" in state:
            _scatter_(state["acc_sumsq"], grp,
                      torch.where(upd, argvals * argvals, 0.0), "sum")
        _scatter_(state["acc_cnt"], grp,
                  upd.to(_F32).expand_as(argvals), "sum")
        if "acc_min" in state:
            _scatter_(state["acc_min"], grp,
                      torch.where(upd, argvals, _INF), "min")
        if "acc_max" in state:
            _scatter_(state["acc_max"], grp,
                      torch.where(upd, argvals, -_INF), "max")
        self._forever_scatter(state, argvals, grp, fmask)

    # -- steps ---------------------------------------------------------------

    def step(self, state, cols, ts, grp, wgrp, valid):
        """The per-event step (filter / running / sliding /
        keyed_sliding) with its count gate:

            (state, cols {lane: [B]}, ts [B] int32 relative ms, grp [B],
             wgrp [B] (partition mode), valid [B])
              -> (state, out_valid [B], {name: [B]}, n_match)

        ``n_match`` stays on the device until the deferred emit fetches
        it with the batch's other count gates."""
        new_state, ov, out = self._step(state, cols, ts, grp, wgrp, valid)
        n = (ov & valid).sum(dtype=_I32)
        return new_state, ov, out, n

    def _step(self, state, cols, ts, grp, wgrp, valid):
        B = ts.shape[0]
        env = self._base_env(cols, ts, B)
        fmask = self._filter_mask(env, valid)
        if self.kind == "filter":
            ov, out = self._emit(env, fmask, B)
            return state, ov, out
        if self.kind == "keyed_sliding":
            return self._keyed_sliding_step(state, env, fmask, ts, grp,
                                            wgrp, B)
        if self.kind == "sliding":
            return self._sliding_step(state, env, fmask, ts, grp, B)
        return self._running_step(state, env, fmask, grp, B)

    def _running_step(self, state, env, fmask, grp, B):
        """Running aggregates: the state before the batch plus the
        within-batch same-group prefix (including self), a masked
        ``[B, B]`` matmul."""
        argvals = self._arg_vals(env, B)
        f = fmask.to(_F32)
        m = (((grp[:, None] == grp[None, :]) & fmask[None, :])
             .to(torch.float64).tril())
        masked_vals = argvals * f[:, None]
        kinds = self._kinds()
        psum = _prefix_mm(m, masked_vals)
        pcnt = _prefix_mm(m, f[:, None])
        psumsq = (_prefix_mm(m, masked_vals * argvals)
                  if "acc_sumsq" in state else None)
        wsum = (state["acc_sum"][grp] + psum if "acc_sum" in state
                else psum)
        wcnt = state["acc_cnt"][grp][:, :1] + pcnt
        wsumsq = (state["acc_sumsq"][grp] + psumsq
                  if psumsq is not None else None)
        # one prefix pass covers min/max and the forever pair
        pmin, pmax = self._prefix_minmax(
            argvals, grp, fmask, B, bool(kinds & {"min", "minForever"}),
            bool(kinds & {"max", "maxForever"}))
        wmin = (torch.minimum(state["acc_min"][grp], pmin)
                if "min" in kinds else None)
        wmax = (torch.maximum(state["acc_max"][grp], pmax)
                if "max" in kinds else None)
        fmin, fmax = self._forever_rows(state, argvals, grp, fmask, B,
                                        pmin, pmax)
        env_out = dict(env)
        self._finalize_aggs(env_out, wsum, wcnt, wsumsq, wmin, wmax,
                            fmin, fmax)
        ov, out = self._emit(env_out, fmask, B)
        # every output is computed: the scatters may now write in place
        self._acc_scatter(state, argvals, grp, fmask)
        return state, ov, out

    def _sliding_step(self, state, env, fmask, ts, grp, B):
        """Global sliding window: compact the passing rows behind the
        ring buffer, gather each row's window ``[B, W]`` (the W entries
        ending at the row), reduce, and keep the last W entries."""
        W = self.W
        A = max(len(self.aggs), 1)
        dev = ts.device
        argvals = self._arg_vals(env, B)
        fi = fmask.to(_I32)
        pos = torch.cumsum(fi, 0, dtype=_I32) - 1
        n_pass = fi.sum(dtype=_I32)
        sidx = torch.where(fmask, pos, B).long()  # dump lane B

        def compact(vals, dtype, trail=()):
            buf = torch.zeros((B + 1,) + trail, dtype=dtype, device=dev)
            return buf.index_put_((sidx,), vals)[:B]

        cat_vals = torch.cat([state["win_vals"],
                              compact(argvals, _F32, (A,))], 0)
        cat_ts = torch.cat([state["win_ts"], compact(ts, _I32)], 0)
        cat_grp = torch.cat([state["win_grp"], compact(grp, _I32)], 0)
        cat_valid = torch.cat([state["win_valid"], compact(
            torch.ones(B, dtype=torch.bool, device=dev), torch.bool)], 0)
        gidx = (pos[:, None] + 1
                + torch.arange(W, device=dev, dtype=_I32)[None, :])
        gidx = gidx.clamp(0, W + B - 1).long()  # [B, W]
        w_vals = cat_vals[gidx]  # [B, W, A]
        member = cat_valid[gidx] & (cat_grp[gidx] == grp[:, None])
        if self.window_name == "time":
            member = member & (cat_ts[gidx] > ts[:, None] - self.window_param)
        mf = member.to(_F32)[:, :, None]
        kinds = self._kinds()
        wsum = (w_vals * mf).sum(1)
        wcnt = mf.sum(1)
        wsumsq = (w_vals * w_vals * mf).sum(1) if "stdDev" in kinds else None
        m3 = member[:, :, None]
        wmin = (torch.where(m3, w_vals, _INF).amin(1)
                if "min" in kinds else None)
        wmax = (torch.where(m3, w_vals, -_INF).amax(1)
                if "max" in kinds else None)
        fmin, fmax = self._forever_rows(state, argvals, grp, fmask, B)
        env_out = dict(env)
        self._finalize_aggs(env_out, wsum, wcnt, wsumsq, wmin, wmax,
                            fmin, fmax)
        ov, out = self._emit(env_out, fmask, B)
        # the new ring: the W entries ending at the batch's last passing
        # row, concat[n_pass : n_pass + W]
        keep = n_pass.clamp(0, B) + torch.arange(W, device=dev)
        new_state = dict(state)
        new_state["win_vals"] = cat_vals.index_select(0, keep)
        new_state["win_ts"] = cat_ts.index_select(0, keep)
        new_state["win_grp"] = cat_grp.index_select(0, keep)
        new_state["win_valid"] = cat_valid.index_select(0, keep)
        self._forever_scatter(new_state, argvals, grp, fmask)
        return new_state, ov, out

    def _keyed_sliding_step(self, state, env, fmask, ts, grp, wgrp, B):
        """Per-key sliding window (partition mode): each window group
        owns one ``[W]`` ring row, so a row's window is its key's last W
        passing events; aggregation masks restrict further to the
        composed (key, group-by) group.  The batch side is ``[B, B]``
        masks (the sums a matmul), the buffer side ``[B, W]``."""
        W = self.W
        dev = ts.device
        argvals = self._arg_vals(env, B)
        tril = torch.ones((B, B), dtype=torch.bool, device=dev).tril()
        samew = (wgrp[:, None] == wgrp[None, :]) & fmask[None, :]
        # passing rank within the row's window group (self included)
        r = (samew & tril).sum(1, dtype=_I32)
        n_w = samew.sum(1, dtype=_I32)
        # batch side: among the last W passing events of the row's group
        mb = samew & tril & ((r[:, None] - r[None, :]) < W)
        # buffer side: recency rank (0 = newest buffered), shifted by the
        # r arrivals of this batch that displace old entries
        b_vals = state["win_vals"][wgrp]  # [B, W, A]
        b_ts = state["win_ts"][wgrp]
        b_grp = state["win_grp"][wgrp]
        b_valid = state["win_valid"][wgrp]
        cnt = state["win_count"][wgrp]
        slots = torch.arange(W, device=dev, dtype=_I32)[None, :]
        rec = torch.remainder(cnt[:, None] - 1 - slots, W)
        mbuf = b_valid & ((rec + r[:, None]) < W)
        if self.window_name == "time":
            T = self.window_param
            mb = mb & (ts[None, :] > (ts[:, None] - T))
            mbuf = mbuf & (b_ts > (ts[:, None] - T))
        mba = mb & (grp[None, :] == grp[:, None])
        mbufa = mbuf & (b_grp == grp[:, None])
        kinds = self._kinds()
        mbaf = mba.to(torch.float64)
        mbufaf = mbufa.to(_F32)[:, :, None]
        bsum = _prefix_mm(mbaf, argvals)
        bsumsq = (_prefix_mm(mbaf, argvals * argvals)
                  if "stdDev" in kinds else None)
        wsum = bsum + (b_vals * mbufaf).sum(1)
        wcnt = (mba.sum(1, dtype=_I32).to(_F32)
                + mbufa.sum(1, dtype=_I32).to(_F32))[:, None]
        wsumsq = (bsumsq + (b_vals * b_vals * mbufaf).sum(1)
                  if bsumsq is not None else None)
        wmin = wmax = None
        if "min" in kinds:
            wmin = torch.minimum(
                self._masked_min(mba, argvals),
                torch.where(mbufa[:, :, None], b_vals, _INF).amin(1))
        if "max" in kinds:
            wmax = torch.maximum(
                self._masked_max(mba, argvals),
                torch.where(mbufa[:, :, None], b_vals, -_INF).amax(1))
        fmin, fmax = self._forever_rows(state, argvals, grp, fmask, B)
        env_out = dict(env)
        self._finalize_aggs(env_out, wsum, wcnt, wsumsq, wmin, wmax,
                            fmin, fmax)
        ov, out = self._emit(env_out, fmask, B)
        # the ring update, in place: a kept passing row writes its slot,
        # (count + r - 1) mod W; every other row (displaced within the
        # batch, filtered, padding) rewrites what its slot will hold,
        # the kept row's value or the slot's own, so no two writes to a
        # slot differ
        keep = fmask & ((n_w - r) < W)
        slot = torch.remainder(cnt + r - 1, W).long()
        w = wgrp.long()
        same = ((wgrp[:, None] == wgrp[None, :])
                & (slot[:, None] == slot[None, :]) & keep[None, :])
        has = same.any(1)
        src = same.to(torch.uint8).argmax(1)

        def put(arr, vals):
            cur = arr[w, slot]
            pick = (keep if vals.dim() == 1 else keep[:, None])
            hit = (has if vals.dim() == 1 else has[:, None])
            arr.index_put_((w, slot), torch.where(
                pick, vals, torch.where(hit, vals[src], cur)))

        put(state["win_vals"], argvals)
        put(state["win_ts"], ts)
        put(state["win_grp"], grp)
        put(state["win_valid"], torch.ones(B, dtype=torch.bool, device=dev))
        state["win_count"].index_add_(0, w, fmask.to(_I32))
        self._forever_scatter(state, argvals, grp, fmask)
        return state, ov, out

    def acc_step(self, state, cols, ts, grp, gkv, valid):
        """Tumbling accumulate: ``(state, cols, ts, grp, grp_key_vals
        [B, K], valid) -> (state, n_passing)``; the accumulators are
        written in place."""
        B = ts.shape[0]
        env = self._base_env(cols, ts, B)
        fmask = self._filter_mask(env, valid)
        argvals = self._arg_vals(env, B)
        self._acc_scatter(state, argvals, grp, fmask)
        g = grp.long()
        hits = torch.zeros(state["touched"].shape[0], dtype=_I32,
                           device=grp.device).index_add_(0, g, fmask.to(_I32))
        state["touched"] |= hits > 0
        # the numeric group keys of the groups with a passing row (each
        # row of a group writes the same value: the key, or the row's
        # own when no row of the group passed)
        gk = state["grp_keys"]
        hit = (hits[g] > 0)[:, None]
        gk.index_put_((g,), torch.where(hit, gkv, gk[g]))
        return state, fmask.sum(dtype=_I32)

    def flush_step(self, state):
        """Tumbling flush: ``state -> (state, flush_valid [G], {name:
        [G]}, n_match)``.  Sums, counts, min and max restart; the
        all-time accumulators survive.  The restarted accumulators are
        new tensors, so the outputs a pending emit holds stay intact."""
        G = state["acc_cnt"].shape[0]
        env = {N_KEY: G}
        self._finalize_aggs(
            env, state.get("acc_sum", state["acc_cnt"]),
            state["acc_cnt"][:, :1], state.get("acc_sumsq"),
            state.get("acc_min"), state.get("acc_max"),
            state.get("acc_minf"), state.get("acc_maxf"))
        for ki, i in enumerate(self._numeric_group_keys):
            g = self.group_raw[i]
            if isinstance(g, Variable):
                env[g.attribute] = state["grp_keys"][:, ki]
        ov, out = self._emit(env, state["touched"].clone(), G)
        new_state = dict(state)
        for k in ("acc_sum", "acc_cnt", "acc_sumsq"):
            if k in state:
                new_state[k] = torch.zeros_like(state[k])
        if "acc_min" in state:
            new_state["acc_min"] = torch.full_like(state["acc_min"], _INF)
        if "acc_max" in state:
            new_state["acc_max"] = torch.full_like(state["acc_max"], -_INF)
        new_state["touched"] = torch.zeros_like(state["touched"])
        return new_state, ov, out, ov.sum(dtype=_I32)

    # -- host wrapper --------------------------------------------------------

    # re-anchor before relative ms approach the int32 range (about 24.8
    # days of stream time), with room for a batch and a window horizon
    _REL_LIMIT = 2**31 - 2**24

    def _re_anchor(self, state, rel64: np.ndarray):
        """Shift ``base_ts`` forward so relative timestamps stay inside
        int32; live window entries and the open pane shift with it."""
        horizon = (int(self.window_param)
                   if self.window_name in ("time", "timeBatch") else 0)
        delta = int(rel64.min()) - 1 - horizon
        # every check before any change, so a caller catching the error
        # keeps a consistent (anchor, window state) pair
        if delta <= 0 or int(rel64.max()) - delta >= 2**31:
            raise SiddhiAppRuntimeError(
                "device query: timestamp span of one batch plus the window "
                "horizon exceeds the int32 relative-time range")
        self.base_ts += delta
        rel64 = rel64 - delta
        if "win_ts" in state:
            state = dict(state)
            # entries older than the horizon go negative and stay
            # excluded; a delta past int32 expires every entry, so the
            # shift clamps
            state["win_ts"] = state["win_ts"] - min(delta, 2**31 - 1)
        if self._pane_end is not None:
            self._pane_end -= delta
        return state, rel64

    def _host_env(self, cols: Dict[str, np.ndarray], ts: np.ndarray,
                  n: int) -> Dict:
        env = {a: np.asarray(cols[a]) for a in self.all_attrs if a in cols}
        env[TS_KEY] = np.asarray(ts)
        env[N_KEY] = n
        return env

    def _intern_groups(self, cols: Dict[str, np.ndarray], ts: np.ndarray,
                       n: int, pk: Optional[np.ndarray] = None,
                       now: Optional[int] = None) -> np.ndarray:
        """Group-key values (host-evaluated) -> dense ids; in partition
        mode (``pk``) the key is ``(partition key, *group keys)``."""
        if not self.group_exprs and pk is None:
            return np.zeros(n, dtype=np.int32)
        env = self._host_env(cols, ts, n)
        key_cols = [np.broadcast_to(np.asarray(g.fn(env)), (n,))
                    for g in self.group_exprs]
        if pk is not None:
            key_cols = [np.broadcast_to(pk, (n,))] + key_cols
        if len(key_cols) == 1 and pk is None:
            try:
                # one dict probe per unique value
                uniq, inv = np.unique(key_cols[0], return_inverse=True)
            except TypeError:  # unorderable (None in an object column)
                return self._intern_rows(key_cols, n, now, scalar=True)
            out_u = np.empty(len(uniq), dtype=np.int32)
            for i, k in enumerate(uniq.tolist()):
                out_u[i] = self._alloc_group(k, now)
            return out_u[inv].astype(np.int32, copy=False)
        # several or composed keys: combined per-column factor codes, one
        # dict probe per unique combination; the exact per-row probe when
        # a column is unorderable or the radix product would overflow
        try:
            code = np.zeros(n, dtype=np.int64)
            radix = 1
            for c in key_cols:
                u, inv = np.unique(c, return_inverse=True)
                radix *= len(u) + 1
                if radix > 2**62:
                    raise OverflowError("group-key radix product")
                code = code * (len(u) + 1) + inv
        except (TypeError, OverflowError):
            return self._intern_rows(key_cols, n, now)
        _uc, first, cinv = np.unique(code, return_index=True,
                                     return_inverse=True)
        out_u = np.empty(len(first), dtype=np.int32)
        for j, fi in enumerate(first.tolist()):
            k = tuple(c[fi].item() if hasattr(c[fi], "item") else c[fi]
                      for c in key_cols)
            out_u[j] = self._alloc_group(k, now)
        return out_u[cinv].astype(np.int32, copy=False)

    def _intern_rows(self, key_cols, n: int, now, scalar: bool = False
                     ) -> np.ndarray:
        """Exact per-row interning (unorderable or radix-overflowing key
        columns)."""
        out = np.empty(n, dtype=np.int32)
        for i in range(n):
            parts = tuple(c[i].item() if hasattr(c[i], "item") else c[i]
                          for c in key_cols)
            out[i] = self._alloc_group(parts[0] if scalar else parts, now)
        return out

    @staticmethod
    def _alloc_id(k, ids: Dict, vals: List, free: List[int], last,
                  limit: int, what: str, now: Optional[int]) -> int:
        """Free-listed id allocator shared by group and window-group
        interning (purged ids are reused once their rows are zeroed)."""
        gid = ids.get(k)
        if gid is None:
            if free:
                gid = free.pop()
                vals[gid] = k
            else:
                gid = len(vals)
                if gid >= limit:
                    raise SiddhiAppRuntimeError(what)
                vals.append(k)
            ids[k] = gid
        if now is not None:
            last[gid] = now
        return gid

    def _alloc_group(self, k, now: Optional[int] = None) -> int:
        return self._alloc_id(
            k, self._group_ids, self._group_vals, self._group_free,
            self._group_last, self.n_groups,
            f"device query: group cardinality exceeded "
            f"n_groups={self.n_groups}", now)

    _WGRP_CAP_MSG = (
        "device query: partition-key cardinality exceeded {cap} (raise "
        "@app:execution partitions or enable @purge)")

    def _intern_wgroups(self, pk: np.ndarray, now: int) -> np.ndarray:
        """Partition-key values -> dense window-group ids: one
        ``np.unique`` a batch, known keys through one ``searchsorted``
        against the sorted index, new keys through the allocator, the
        last-use stamps as one array write.  Object or mixed key dtypes
        fall back for good to exact dict probes."""
        arr = np.asarray(pk)
        if self._wgrp_vector:
            sk = self._wgrp_sorted_keys
            if arr.dtype.kind in ("O", "V"):
                self._wgrp_vector = False
            elif sk is not None and len(sk) and arr.dtype != sk.dtype:
                if np.can_cast(arr.dtype, sk.dtype, "safe"):
                    arr = arr.astype(sk.dtype)
                elif np.can_cast(sk.dtype, arr.dtype, "safe"):
                    self._wgrp_sorted_keys = sk.astype(arr.dtype)
                else:
                    self._wgrp_vector = False
        if not self._wgrp_vector:
            uniq, inv = np.unique(arr, return_inverse=True)
            out_u = np.empty(len(uniq), dtype=np.int32)
            for i, k in enumerate(uniq.tolist()):
                out_u[i] = self._alloc_wgrp(k, now)
            return out_u[inv].astype(np.int32, copy=False)

        uniq, inv = np.unique(arr, return_inverse=True)
        nu = len(uniq)
        out_u = np.empty(nu, dtype=np.int32)
        sk = self._wgrp_sorted_keys
        if sk is not None and len(sk):
            pos = np.searchsorted(sk, uniq)
            pos_c = np.minimum(pos, len(sk) - 1)
            found = sk[pos_c] == uniq
            out_u[found] = self._wgrp_sorted_ids[pos_c[found]]
            new_idx = np.flatnonzero(~found)
        else:
            new_idx = np.arange(nu)
        if len(new_idx):
            n_new = len(new_idx)
            take_free = min(len(self._wgrp_free), n_new)
            fresh = n_new - take_free
            if len(self._wgrp_vals) + fresh > self.n_wgroups:
                raise SiddhiAppRuntimeError(
                    self._WGRP_CAP_MSG.format(cap=self.n_wgroups))
            ids = np.empty(n_new, dtype=np.int32)
            if take_free:
                ids[:take_free] = self._wgrp_free[-take_free:][::-1]
                del self._wgrp_free[-take_free:]
            if fresh:
                base = len(self._wgrp_vals)
                ids[take_free:] = np.arange(base, base + fresh,
                                            dtype=np.int32)
                self._wgrp_vals.extend(uniq[new_idx][take_free:].tolist())
            new_keys = uniq[new_idx]
            for k, wid in zip(new_keys.tolist(), ids.tolist()):
                self._wgrp_ids[k] = wid
                self._wgrp_vals[wid] = k
            out_u[new_idx] = ids
            if sk is None or not len(sk):
                self._wgrp_sorted_keys = new_keys.copy()
                self._wgrp_sorted_ids = ids.copy()
            else:
                ins = np.searchsorted(sk, new_keys)
                self._wgrp_sorted_keys = np.insert(sk, ins, new_keys)
                self._wgrp_sorted_ids = np.insert(
                    self._wgrp_sorted_ids, ins, ids)
        self._wgrp_last[out_u] = now
        self._wgrp_in_use[out_u] = True
        return out_u[inv].astype(np.int32, copy=False)

    def _alloc_wgrp(self, k, now: int) -> int:
        wid = self._alloc_id(
            k, self._wgrp_ids, self._wgrp_vals, self._wgrp_free,
            self._wgrp_last, self.n_wgroups,
            self._WGRP_CAP_MSG.format(cap=self.n_wgroups), now)
        self._wgrp_in_use[wid] = True
        return wid

    def purge_idle_keys(self, state, now: int, idle_ms: Optional[int]):
        """Reclaim the state rows of partition keys idle for ``idle_ms``
        (the reference drops their per-key instances): the rows are reset
        in place and the ids return to the free lists.  Returns
        ``(state, n_purged_keys)``."""
        if not self.partition_mode or idle_ms is None:
            return state, 0
        dead_w = np.flatnonzero(
            self._wgrp_in_use & (now - self._wgrp_last >= idle_ms)).tolist()
        if not dead_w:
            return state, 0
        dead_pk = {self._wgrp_vals[w] for w in dead_w}
        if self.group_exprs:
            # composed groups die with their partition key
            dead_g = [gid for k, gid in self._group_ids.items()
                      if k[0] in dead_pk]
        else:
            dead_g = list(dead_w)  # grp is wgrp
        gi, wi = staged_put(
            (np.asarray(dead_g, dtype=np.int64),
             np.asarray(dead_w, dtype=np.int64)), self.device,
            self.ingest_stats)
        if dead_g:
            for key, init in (("acc_sum", 0.0), ("acc_cnt", 0.0),
                              ("acc_sumsq", 0.0), ("acc_min", _INF),
                              ("acc_minf", _INF), ("acc_max", -_INF),
                              ("acc_maxf", -_INF)):
                if key in state:
                    state[key][gi] = init
        if self.kind == "keyed_sliding":
            state["win_valid"][wi] = False
            state["win_count"][wi] = 0
        for w in dead_w:
            del self._wgrp_ids[self._wgrp_vals[w]]
            self._wgrp_vals[w] = None
            self._wgrp_free.append(w)
        self._wgrp_in_use[dead_w] = False
        if self._wgrp_sorted_keys is not None and len(self._wgrp_sorted_keys):
            keep = ~np.isin(self._wgrp_sorted_ids,
                            np.asarray(dead_w, dtype=np.int32))
            self._wgrp_sorted_keys = self._wgrp_sorted_keys[keep]
            self._wgrp_sorted_ids = self._wgrp_sorted_ids[keep]
        if self.group_exprs:
            for gid in dead_g:
                del self._group_ids[self._group_vals[gid]]
                self._group_vals[gid] = None
                self._group_free.append(gid)
                self._group_last.pop(gid, None)
        return state, len(dead_w)

    def host_lane_cols(self, cols, n: int) -> Dict[str, np.ndarray]:
        """Raw input columns -> the device lanes as numpy columns (lane
        dtypes, LONG hi/lo splits), unpadded."""
        out: Dict[str, np.ndarray] = {}
        for k in self.attrs:
            lane = self._lane_dtype[k]
            out[k] = (np.asarray(cols[k])[:n].astype(lane, copy=False)
                      if k in cols else np.zeros(n, dtype=lane))
        for k in self.long_attrs:
            if k in cols:
                hi, lo = _split_i64(np.asarray(cols[k])[:n])
            else:
                hi = np.zeros(n, dtype=np.int32)
                lo = np.zeros(n, dtype=np.int32)
            out[k + "|hi"], out[k + "|lo"] = hi, lo
        return out

    def _pad(self, cols, rel, grp, n, wgrp=None, extra=None):
        """One chunk padded to a power of two (at least 16) and put on
        the device in one ``staged_put``; ``extra`` (already padded)
        rides in the window-group slot."""
        B = _pow2(n)
        valid = np.zeros(B, dtype=bool)
        valid[:n] = True
        c = {}
        for k, lane in self.host_lane_cols(cols, n).items():
            col = np.zeros(B, dtype=lane.dtype)
            col[:n] = lane
            c[k] = col
        t = np.zeros(B, dtype=np.int32)
        t[:n] = rel[:n]
        g = np.zeros(B, dtype=np.int32)
        g[:n] = grp[:n]
        wg = np.zeros(B, dtype=np.int32)
        if wgrp is not None:
            wg[:n] = wgrp[:n]
        c, t, g, wg, valid = staged_put(
            (c, t, g, wg if extra is None else extra, valid), self.device,
            self.ingest_stats)
        return c, t, g, wg, valid, B

    def _out_columns(self, vals, sel, gids, in_cols, in_sel, host_env=None,
                     key_cols=None, gvals=None) -> Dict[str, np.ndarray]:
        """Output columns (declared dtypes) of the selected rows.
        ``vals``: fetched ``{name: [*]}`` columns, ``sel`` row indices
        into them; ``gids`` the group id of each output row (None for the
        filter kind, whose group keys come from ``host_env`` or
        ``key_cols``); ``in_cols``/``in_sel`` the input columns and rows
        of passthrough items; ``gvals`` group-key values captured when
        the emit resolved (an id recycled meanwhile cannot alias)."""
        cols: Dict[str, np.ndarray] = {}
        for oi, (kind, v, name) in enumerate(self.out_spec):
            t = self.out_types[oi]
            if kind == "group_key":
                if gids is None and gvals is None:
                    if key_cols is not None:
                        col = key_cols[v]
                    else:
                        n = host_env[N_KEY]
                        col = np.broadcast_to(
                            np.asarray(self.group_exprs[v].fn(host_env)),
                            (n,))
                    cols[name] = col[in_sel].astype(t.np_dtype, copy=False)
                    continue
                comp = (list(gvals) if gvals is not None
                        else [self._group_vals[int(g)] for g in gids])
                if self.partition_mode:
                    comp = [k[v + 1] for k in comp]
                else:
                    comp = [k[v] if isinstance(k, tuple) else k
                            for k in comp]
                cols[name] = (np.asarray(comp, dtype=t.np_dtype) if comp
                              else np.empty(0, dtype=t.np_dtype))
            elif kind == "passthrough":
                cols[name] = np.asarray(in_cols[v])[in_sel].astype(
                    t.np_dtype, copy=False)
            else:
                cols[name] = vals[name][sel].astype(t.np_dtype)
        return cols

    def _empty_cols(self) -> Dict[str, np.ndarray]:
        return {name: np.empty(0, dtype=self.out_types[oi].np_dtype)
                for oi, (_k, _v, name) in enumerate(self.out_spec)}

    # the group-key side channel of the latest ``process_batch`` call
    # (aligned with its output rows): per-group rate limiters read it as
    # batch.aux['group_keys'].  None without group by, and in partition
    # mode (whose rate limits are refused at plan time).
    last_group_keys: Optional[List] = None

    def _keys_for_gids(self, gids) -> List:
        return [self._group_vals[int(g)] for g in gids]

    def _concat_chunks(self, chunks):
        """``[(cols, ts, n_rows, keys|None)]`` -> ``(cols, ts)``; sets
        ``last_group_keys`` from the chunks' key lists."""
        chunks = [c for c in chunks if c[2]]
        if not chunks:
            self.last_group_keys = [] if self.group_exprs else None
            return self._empty_cols(), np.empty(0, dtype=np.int64)
        out_cols = {nm: np.concatenate([c[0][nm] for c in chunks])
                    for nm in self.output_names}
        out_ts = np.concatenate(
            [np.full(c[2], c[1], dtype=np.int64) for c in chunks])
        self.last_group_keys = ([k for c in chunks for k in (c[3] or [])]
                                if self.group_exprs else None)
        return out_cols, out_ts

    def process_batch(self, state, cols: Dict[str, np.ndarray],
                      ts: np.ndarray, part_keys: Optional[np.ndarray] = None):
        """Columnar entry point: ``(state, out_cols, out_ts)`` with the
        output columns in their declared types.  ``part_keys``
        (partition mode): the raw partition key of each row.  The
        synchronous form of the deferred path: one count-gated,
        coalesced fetch a call."""
        state, pending = self.process_batch_deferred(state, cols, ts,
                                                     part_keys)
        if pending is not None and pending.resolve() == 0:
            pending = None
        if pending is None:
            self.last_group_keys = (
                [] if self.group_exprs and not self.partition_mode else None)
            return state, self._empty_cols(), np.empty(0, dtype=np.int64)
        out_cols, out_ts, keys = pending.materialize(
            fetch_coalesced(pending.device_arrays()))
        self.last_group_keys = keys
        return state, out_cols, out_ts

    def process_batch_deferred(self, state, cols: Dict[str, np.ndarray],
                               ts: np.ndarray,
                               part_keys: Optional[np.ndarray] = None):
        """Run the step(s) and keep the outputs on the device: nothing is
        fetched here, not even a chunk's match count, until
        ``DeferredDeviceEmit.resolve()``.  Empty input returns
        ``(state, None)``."""
        ts = np.asarray(ts, dtype=np.int64)
        n = len(ts)
        if n == 0:
            return state, None
        if self.partition_mode and part_keys is None:
            raise SiddhiAppRuntimeError(
                "partitioned device query needs per-row partition keys")
        pk = np.asarray(part_keys) if part_keys is not None else None
        pending = DeferredDeviceEmit(self)
        # the chunk bound is for the [B, B] masks of the running and
        # keyed-sliding kinds and sliding's [B, W + B] gathers; the
        # filter kind is per row, one dispatch
        if n > MAX_DEVICE_BATCH and self.kind not in ("tumbling", "filter"):
            for i in range(0, n, MAX_DEVICE_BATCH):
                sl = slice(i, i + MAX_DEVICE_BATCH)
                state = self._deferred_chunk(
                    state, {k: np.asarray(v)[sl] for k, v in cols.items()},
                    ts[sl], pk[sl] if pk is not None else None, pending)
        else:
            state = self._deferred_chunk(state, cols, ts, pk, pending)
        return state, (pending if pending.chunks else None)

    def _deferred_chunk(self, state, cols, ts, pk, pending):
        """One chunk of at most MAX_DEVICE_BATCH rows; its outputs join
        ``pending`` as device tensors."""
        n = len(ts)
        if self.base_ts is None:
            self.base_ts = int(ts[0]) - 1
        rel64 = ts - self.base_ts
        if int(rel64.max()) >= self._REL_LIMIT:
            state, rel64 = self._re_anchor(state, rel64)
        rel = rel64.astype(np.int32)
        now = int(ts.max())
        if self.kind == "filter":
            # stateless: no interning; group-key select items are
            # evaluated on the host when the emit materializes
            grp = wgrp = np.zeros(n, dtype=np.int32)
        elif self.partition_mode:
            wgrp = self._intern_wgroups(pk, now)
            grp = (self._intern_groups(cols, ts, n, pk=pk, now=now)
                   if self.group_exprs else wgrp)
        else:
            wgrp = None
            grp = self._intern_groups(cols, ts, n)
        if self.kind == "tumbling":
            state, out_cols, out_ts = self._process_tumbling(
                state, cols, rel, grp, n)
            if len(out_ts):
                pending.chunks.append({
                    "kind": "host", "cols": out_cols, "ts": out_ts,
                    "keys": self.last_group_keys})
            return state
        c, t, g, wg, valid, _B = self._pad(cols, rel, grp, n, wgrp)
        state, ov, out, n_match = self.step(state, c, t, g, wg, valid)
        # the group ids stay on the host, so resolve can capture the key
        # values of surviving chunks before any purge or intern could
        # recycle an id (runtimes flush the ingest stage first)
        gids = (grp[:n].copy()
                if self.group_exprs and self.kind != "filter" else None)
        pending.chunks.append({
            "kind": "device", "ov": ov, "out": dict(out),
            "names": list(out), "n": n, "count": n_match, "gids": gids,
            "ts": ts, "cols": {k: np.asarray(v) for k, v in cols.items()}})
        return state

    def process(self, state, cols: Dict[str, np.ndarray], ts: np.ndarray,
                part_keys: Optional[np.ndarray] = None):
        """Host entry point: ``(state, rows)``, the emitted output dicts
        in emission order."""
        state, out_cols, out_ts = self.process_batch(state, cols, ts,
                                                     part_keys)
        names = self.output_names
        rows = [{nm: out_cols[nm][i] for nm in names}
                for i in range(len(out_ts))]
        return state, rows

    # -- tumbling host logic -------------------------------------------------

    def _gk_vals(self, grp: np.ndarray) -> np.ndarray:
        """The numeric group keys of each row as float32 ``[n, K]``."""
        K = max(len(self._numeric_group_keys), 1)
        out = np.zeros((len(grp), K), dtype=np.float32)
        if not self._numeric_group_keys:
            return out
        uniq, inv = np.unique(grp, return_inverse=True)
        per = np.zeros((len(uniq), K), dtype=np.float32)
        for u, gid in enumerate(uniq.tolist()):
            k = self._group_vals[gid]
            for ki, i in enumerate(self._numeric_group_keys):
                per[u, ki] = np.float32(k[i] if isinstance(k, tuple) else k)
        out[:] = per[inv]
        return out

    def _flush_cols(self, state):
        state, ov, out, n_match = self.flush_step(state)
        if int(fetch_coalesced([n_match])[0]) == 0:
            # count gate: an empty pane fetches no column
            return state, self._empty_cols(), 0, (
                [] if self.group_exprs else None)
        names = list(out)
        host = fetch_coalesced([ov] + [out[k] for k in names])
        gidx = np.flatnonzero(host[0])
        out_np = dict(zip(names, host[1:]))
        out_cols = self._out_columns(out_np, gidx, gidx, None, None)
        keys = self._keys_for_gids(gidx) if self.group_exprs else None
        return state, out_cols, len(gidx), keys

    def _advance_pane(self):
        """timeBatch pane bookkeeping after a flush (the host
        TimeBatchWindow's): boundaries advance by T while panes stay
        non-empty; after two empty panes in a row the window goes idle
        and re-anchors at the next event."""
        if self._pane_fill == 0 and self._prev_pane_fill == 0:
            self._pane_end = None
        else:
            self._pane_end += int(self.window_param)
            self._prev_pane_fill = self._pane_fill
            self._pane_fill = 0

    def pane_wakeup(self) -> Optional[int]:
        """Absolute ms at which the open timeBatch pane closes (the
        scheduler's timer flush); None when nothing is pending."""
        if (self.window_name != "timeBatch" or self._pane_end is None
                or self.base_ts is None):
            return None
        return self.base_ts + self._pane_end

    def flush_due(self, state, now: int):
        """Timer flush: close every pane whose boundary is <= ``now``.
        Returns ``(state, out_cols, out_ts)``."""
        chunks = []
        while True:
            w = self.pane_wakeup()
            if w is None or w > now:
                break
            state, fcols, nf, keys = self._flush_cols(state)
            chunks.append((fcols, w, nf, keys))
            self._advance_pane()
        out_cols, out_ts = self._concat_chunks(chunks)
        return state, out_cols, out_ts

    def _acc_segment(self, state, cols, rel, grp, idx, count: bool):
        """Accumulate rows ``idx``; their passing count is fetched only
        when ``count`` (timeBatch's idle detection reads it)."""
        n = len(idx)
        # the padding rows sit on group 0 and carry its key too: every
        # row of a group writes the same key register
        g_pad = np.zeros(_pow2(n), dtype=np.int32)
        g_pad[:n] = grp[idx]
        c, t, g, gkv, valid, _B = self._pad(
            {k: np.asarray(v)[idx] for k, v in cols.items()},
            rel[idx], grp[idx], n, extra=self._gk_vals(g_pad))
        state, n_pass = self.acc_step(state, c, t, g, gkv, valid)
        return state, (int(fetch_coalesced([n_pass])[0]) if count else None)

    def _pane_sweep(self, state, cols, rel, grp, n, flush_pane):
        """Walk one batch: accumulate the segments inside a pane and
        close each crossed boundary with ``flush_pane(state, abs_ts)``."""
        if self.window_name == "timeBatch":
            # the first event anchors the boundary; flushes are stamped
            # with the boundary time, as on the timer path
            T = int(self.window_param)
            i = 0
            while i < n:
                if self._pane_end is None:
                    self._pane_end = int(rel[i]) + T
                    self._pane_fill = 0
                    self._prev_pane_fill = 0
                j = int(np.searchsorted(rel[i:], self._pane_end,
                                        side="left")) + i
                if j > i:
                    state, n_pass = self._acc_segment(
                        state, cols, rel, grp, np.arange(i, j), True)
                    self._pane_fill += n_pass
                    i = j
                if i < n:  # the remaining events cross the boundary
                    state = flush_pane(state, self.base_ts + self._pane_end)
                    self._advance_pane()
            return state
        # lengthBatch: boundaries fall on passing events, so the filter
        # mask is evaluated on the host first, as in the reference
        L = int(self.window_param)
        fmask = self._host_filter_mask(cols, rel, n)
        i = 0
        while i < n:
            remaining = L - self._pane_fill
            pass_pos = np.flatnonzero(fmask[i:])
            if len(pass_pos) < remaining:
                state, _ = self._acc_segment(state, cols, rel, grp,
                                             np.arange(i, n), False)
                self._pane_fill += len(pass_pos)
                break
            j = i + int(pass_pos[remaining - 1]) + 1
            state, _ = self._acc_segment(state, cols, rel, grp,
                                         np.arange(i, j), False)
            state = flush_pane(state, self.base_ts + int(rel[j - 1]))
            self._pane_fill = 0
            i = j
        return state

    def _process_tumbling(self, state, cols, rel, grp, n):
        chunks = []  # (cols, abs_ts, n_rows, keys|None)

        def flush_pane(st, when):
            st, fcols, nf, keys = self._flush_cols(st)
            chunks.append((fcols, when, nf, keys))
            return st

        state = self._pane_sweep(state, cols, rel, grp, n, flush_pane)
        out_cols, out_ts = self._concat_chunks(chunks)
        return state, out_cols, out_ts

    def _host_filter_mask(self, cols, rel, n) -> np.ndarray:
        """The filters over the raw numpy columns at their native width
        (the reference places lengthBatch boundaries with this mask)."""
        env = {a: np.asarray(cols[a]) for a in self.all_attrs if a in cols}
        for a in self.long_attrs:  # pair-compiled filters read hi/lo
            if a in cols:
                env[a + "|hi"], env[a + "|lo"] = _split_i64(
                    np.asarray(cols[a])[:n])
        env[TS_KEY] = np.asarray(rel)
        env[N_KEY] = n
        m = np.ones(n, dtype=bool)
        for f in self.filters:
            m = m & np.broadcast_to(np.asarray(f.fn(env)).astype(bool), (n,))
        return m

    # -- host bookkeeping snapshot (the runtime snapshots the device
    # state) ----------------------------------------------------------------

    def host_snapshot(self) -> Dict:
        return {
            "base_ts": self.base_ts,
            "group_ids": dict(self._group_ids),
            "group_vals": list(self._group_vals),
            "group_free": list(self._group_free),
            "group_last": dict(self._group_last),
            "wgrp_ids": dict(self._wgrp_ids),
            "wgrp_vals": list(self._wgrp_vals),
            "wgrp_free": list(self._wgrp_free),
            "wgrp_last": self._wgrp_last.copy(),
            "wgrp_in_use": self._wgrp_in_use.copy(),
            "pane_end": self._pane_end,
            "pane_fill": self._pane_fill,
            "prev_pane_fill": self._prev_pane_fill,
        }

    def host_restore(self, s: Dict):
        """Restore a host snapshot of this engine or of the
        reference's."""
        self.base_ts = s["base_ts"]
        self._group_ids = dict(s["group_ids"])
        self._group_vals = list(s["group_vals"])
        self._group_free = list(s.get("group_free", []))
        self._group_last = dict(s.get("group_last", {}))
        self._wgrp_ids = dict(s.get("wgrp_ids", {}))
        self._wgrp_vals = list(s.get("wgrp_vals", []))
        self._wgrp_free = list(s.get("wgrp_free", []))
        last = s.get("wgrp_last")
        self._wgrp_last = np.zeros(self.n_wgroups, dtype=np.int64)
        self._wgrp_in_use = np.zeros(self.n_wgroups, dtype=bool)
        if isinstance(last, dict):
            # the reference's older dict form
            for wid, t in last.items():
                self._wgrp_last[wid] = t
                self._wgrp_in_use[wid] = True
        elif last is not None:
            self._wgrp_last = np.asarray(last, dtype=np.int64).copy()
            in_use = s.get("wgrp_in_use")
            if in_use is not None:
                self._wgrp_in_use = np.asarray(in_use, dtype=bool).copy()
        # rebuild the sorted intern index; mixed python key types (7 and
        # '7' would alias in one numpy array) keep the dict fallback
        self._wgrp_sorted_keys = None
        self._wgrp_sorted_ids = None
        self._wgrp_vector = True
        if self._wgrp_ids:
            if len({type(k) for k in self._wgrp_ids}) > 1:
                self._wgrp_vector = False
            else:
                keys = np.asarray(list(self._wgrp_ids.keys()))
                if keys.dtype.kind in ("O", "V"):
                    self._wgrp_vector = False
                else:
                    order = np.argsort(keys)
                    self._wgrp_sorted_keys = keys[order]
                    self._wgrp_sorted_ids = np.asarray(
                        list(self._wgrp_ids.values()),
                        dtype=np.int32)[order]
        self._pane_end = s["pane_end"]
        self._pane_fill = s["pane_fill"]
        self._prev_pane_fill = s["prev_pane_fill"]

    @property
    def output_names(self) -> List[str]:
        return [name for _k, _v, name in self.out_spec]


class DeferredDeviceEmit:
    """The device-resident outputs of one ``process_batch_deferred``
    call (one junction batch, maybe several chunks).  ``resolve()``
    fetches the chunks' count gates in one ``fetch_coalesced``; the emit
    queue then fetches ``device_arrays()`` in one coalesced copy and
    hands the host arrays to ``materialize``, whose result is what the
    synchronous ``process_batch`` returns."""

    __slots__ = ("engine", "chunks", "_total")

    def __init__(self, engine: DeviceQueryEngine):
        self.engine = engine
        self.chunks: List[dict] = []
        self._total: Optional[int] = None

    def resolve(self) -> int:
        """Fetch the count gates, drop zero-match chunks (their columns
        are never fetched) and capture the group-key values of the rest.
        Idempotent; returns the total match count."""
        if self._total is not None:
            return self._total
        dev = [i for i, ch in enumerate(self.chunks)
               if ch["kind"] == "device"]
        counts = {}
        if dev:
            host = fetch_coalesced([self.chunks[i]["count"] for i in dev])
            counts = {i: int(c) for i, c in zip(dev, host)}
        keep = []
        total = 0
        for i, ch in enumerate(self.chunks):
            if ch["kind"] == "host":
                total += len(ch["ts"])
                keep.append(ch)
                continue
            c = counts[i]
            if c == 0:
                continue  # count gate: no column is fetched
            total += c
            gids = ch.pop("gids", None)
            ch["gvals"] = (self.engine._keys_for_gids(gids)
                           if gids is not None else None)
            keep.append(ch)
        self.chunks = keep
        self._total = total
        return total

    def device_arrays(self) -> List:
        arrs: List = []
        for ch in self.chunks:
            if ch["kind"] == "device":
                arrs.append(ch["ov"])
                arrs.extend(ch["out"][nm] for nm in ch["names"])
        return arrs

    def materialize(self, host_arrays):
        """``host_arrays``: the fetched ``device_arrays()``.  Returns
        ``(out_cols, out_ts, keys)``, keys the group-key side channel
        (None when the query has none)."""
        eng = self.engine
        pos = 0
        parts = []  # (out_cols, out_ts, keys|None)
        for ch in self.chunks:
            if ch["kind"] == "host":
                parts.append((ch["cols"], ch["ts"], ch["keys"]))
                continue
            n = ch["n"]
            ov_np = np.asarray(host_arrays[pos])[:n]
            pos += 1
            out_np = {}
            for nm in ch["names"]:
                out_np[nm] = np.asarray(host_arrays[pos])[:n]
                pos += 1
            idx = np.flatnonzero(ov_np)
            cols, ts = ch["cols"], ch["ts"]
            if eng.kind == "filter":
                host_env = eng._host_env(cols, ts, n)
                key_cols = ([np.broadcast_to(np.asarray(g.fn(host_env)),
                                             (n,))
                             for g in eng.group_exprs]
                            if eng.group_exprs else None)
                out_cols = eng._out_columns(
                    out_np, idx, None, cols, idx, host_env=host_env,
                    key_cols=key_cols)
                if key_cols and not eng.partition_mode:
                    from siddhi_tpu_torch.core.query import format_group_keys

                    keys = format_group_keys(key_cols, idx)
                else:
                    keys = None
            else:
                gvals = ch["gvals"]
                sel_vals = ([gvals[int(i)] for i in idx]
                            if gvals is not None else None)
                out_cols = eng._out_columns(out_np, idx, None, cols, idx,
                                            gvals=sel_vals)
                keys = (sel_vals
                        if eng.group_exprs and not eng.partition_mode
                        else None)
            parts.append((out_cols, ts[idx], keys))
        return self._concat_parts(parts)

    def _concat_parts(self, parts):
        eng = self.engine
        parts = [p for p in parts if len(p[1])]
        if not parts:
            return (eng._empty_cols(), np.empty(0, dtype=np.int64),
                    [] if eng.group_exprs and not eng.partition_mode
                    else None)
        out_cols = {nm: np.concatenate([p[0][nm] for p in parts])
                    for nm in eng.output_names}
        out_ts = np.concatenate([np.asarray(p[1], dtype=np.int64)
                                 for p in parts])
        key_lists = [p[2] for p in parts]
        keys = ([k for kl in key_lists for k in (kl or [])]
                if any(k is not None for k in key_lists) else None)
        return out_cols, out_ts, keys


def compile_query(app_str: str, query_name: Optional[str] = None,
                  n_groups: int = 1024, window_capacity: int = 1024,
                  partition_mode: bool = False,
                  n_wgroups: Optional[int] = None,
                  device=None) -> DeviceQueryEngine:
    """Compile a SiddhiQL single-stream query into a DeviceQueryEngine on
    ``device`` (``cuda`` unless the caller passes another)."""
    from siddhi_tpu_torch.compiler import SiddhiCompiler
    from siddhi_tpu_torch.query_api.annotation import find_annotation

    app = SiddhiCompiler.parse(app_str)
    query = None
    for i, q in enumerate(app.queries):
        info = find_annotation(q.annotations, "info")
        nm = (info.element("name") if info else None) or f"query_{i}"
        if query_name is None or nm == query_name:
            query = q
            break
    if query is None:
        raise SiddhiAppCreationError(f"query '{query_name}' not found")
    s = query.input_stream
    if not isinstance(s, SingleInputStream):
        raise SiddhiAppCreationError(
            "compile_query needs a single-input-stream query")
    d = app.stream_definitions.get(s.stream_id)
    if d is None:
        raise SiddhiAppCreationError(f"stream '{s.stream_id}' is not defined")
    return DeviceQueryEngine(
        query, d, n_groups=n_groups, window_capacity=window_capacity,
        partition_mode=partition_mode, n_wgroups=n_wgroups, device=device)
