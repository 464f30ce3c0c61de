"""Pattern lowering: state-element tree -> linear node chain.

The lowering half of the JAX package's ``ops/nfa.py`` (``Spec``,
``Node``, ``PatternScope``, ``flatten_chain``, ``NFABuilder``,
``_collect_presence``), kept as a copy so the port imports nothing of
that package.  The host ``PatternProcessor`` is not part of the port yet.

The chain is what ``ops/dense_nfa.py`` compiles: stream / logical /
absent nodes with count ranges, ``every`` re-arm markers, and per-spec
filters (compiled to tensor closures by ``planner/expr.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.planner.expr import (
    CompiledExpression,
    ExpressionCompiler,
    Scope,
)
from siddhi_tpu_torch.query_api import (
    AbsentStreamStateElement,
    AttrType,
    CountStateElement,
    EveryStateElement,
    Filter,
    LogicalStateElement,
    NextStateElement,
    StateElement,
    StateInputStream,
    StreamStateElement,
    Variable,
)
from siddhi_tpu_torch.query_api.definition import StreamDefinition

ANY = CountStateElement.ANY  # -1 == unbounded


# ---------------------------------------------------------------------------
# Lowered NFA structure
# ---------------------------------------------------------------------------


@dataclass
class Spec:
    """One event-capturing sub-state."""

    ref: str
    stream_key: str  # junction key
    stream_def: StreamDefinition = None
    filter_compiled: Optional[CompiledExpression] = None
    # env entries the filter needs: key -> (ref, idx|None, attr) for captured
    filter_capture_keys: Dict[str, Tuple[str, Optional[int], str]] = field(default_factory=dict)
    # presence-check keys: key -> (ref, idx)
    filter_presence_keys: Dict[str, Tuple[str, int]] = field(default_factory=dict)
    is_absent: bool = False
    waiting_ms: Optional[int] = None
    # un-compiled filter expression (re-compiled by the dense engine
    # against register slots)
    raw_filter: object = None


@dataclass
class Node:
    pos: int
    kind: str  # 'stream' | 'logical' | 'absent'
    specs: List[Spec] = field(default_factory=list)
    logical_op: Optional[str] = None  # 'and' | 'or'
    min_count: int = 1
    max_count: int = 1  # ANY == unbounded
    # `every` re-arm: when this node first completes, arm a fresh instance
    # at node `rearm_to` keeping captures of nodes < rearm_to
    rearm_to: Optional[int] = None


# ---------------------------------------------------------------------------
# Filter scope: resolves pattern variables, recording needed env keys
# ---------------------------------------------------------------------------


class PatternScope(Scope):
    """Scope over pattern event refs.  ``cand_ref`` names the spec whose
    candidate event is being filtered (bare attributes resolve to it);
    None for the selector scope (bare attrs resolve when unambiguous)."""

    def __init__(
        self,
        ref_defs: Dict[str, StreamDefinition],
        stream_to_ref: Dict[str, Optional[str]],
        cand_def: Optional[StreamDefinition] = None,
        cand_ref: Optional[str] = None,
    ):
        super().__init__()
        self.ref_defs = ref_defs
        self.stream_to_ref = stream_to_ref
        self.cand_def = cand_def
        self.cand_ref = cand_ref
        # recorded needs: key -> (ref, idx|None, attr, AttrType)
        self.used_captures: Dict[str, Tuple[str, Optional[int], str, AttrType]] = {}

    def _ref_for(self, stream_id: str) -> Optional[str]:
        if stream_id in self.ref_defs:
            return stream_id
        if stream_id in self.stream_to_ref:
            r = self.stream_to_ref[stream_id]
            if r is None:
                raise SiddhiAppCreationError(
                    f"stream '{stream_id}' matches several pattern states; use event references"
                )
            return r
        return None

    def resolve(self, var: Variable):
        if var.stream_id is None:
            # synthetic bare names first (aggregation outputs, select aliases)
            hit = self._bare.get(var.attribute)
            if hit is not None:
                return hit
            if self.cand_def is not None and var.attribute in self.cand_def.attribute_names:
                t = self.cand_def.attribute_type(var.attribute)
                return "__cand." + var.attribute, t
            # unambiguous across refs?
            hits = [
                (r, d.attribute_type(var.attribute))
                for r, d in self.ref_defs.items()
                if var.attribute in d.attribute_names
            ]
            if len(hits) == 1:
                r, t = hits[0]
                key = f"{r}.{var.attribute}"
                self.used_captures[key] = (r, None, var.attribute, t)
                return key, t
            raise SiddhiAppCreationError(
                f"cannot resolve attribute '{var.attribute}' in pattern scope"
                + (" (ambiguous)" if len(hits) > 1 else "")
            )
        if (
            self.cand_ref is not None
            and var.stream_id == self.cand_ref
            and var.stream_index is None
            and self.cand_def is not None
            and var.attribute in self.cand_def.attribute_names
        ):
            # a state's own ref inside its own filter is the INCOMING
            # event (reference: ExpressionParser resolves the current
            # state's ref to the candidate, e.g.
            # `e2=S[e1.symbol==e2.symbol]` — CountPatternTestCase.testQuery13)
            return "__cand." + var.attribute, self.cand_def.attribute_type(var.attribute)
        ref = self._ref_for(var.stream_id)
        if ref is None:
            raise SiddhiAppCreationError(
                f"unknown event reference '{var.stream_id}' in pattern"
            )
        d = self.ref_defs[ref]
        t = d.attribute_type(var.attribute)
        if var.stream_index is None:
            key = f"{ref}.{var.attribute}"
            self.used_captures[key] = (ref, None, var.attribute, t)
        else:
            key = f"{ref}[{var.stream_index}].{var.attribute}"
            self.used_captures[key] = (ref, var.stream_index, var.attribute, t)
        return key, t


# ---------------------------------------------------------------------------
# Lowering: StateElement tree -> node chain
# ---------------------------------------------------------------------------


def flatten_chain(element: StateElement) -> List[StateElement]:
    """Right-nested NextStateElement chain -> ordered element list."""
    out: List[StateElement] = []

    def walk(e: StateElement):
        if isinstance(e, NextStateElement):
            walk(e.element)
            walk(e.next)
        else:
            out.append(e)

    walk(element)
    return out


class NFABuilder:
    """Lowers a StateInputStream to the node chain + compiled filters."""

    def __init__(self, state_input: StateInputStream, resolve_def: Callable[[object], StreamDefinition]):
        self.state_input = state_input
        self.resolve_def = resolve_def
        self.ref_defs: Dict[str, StreamDefinition] = {}
        self.stream_to_ref: Dict[str, Optional[str]] = {}
        self.ref_counts: Dict[str, Tuple[int, int]] = {}  # ref -> (min,max)
        self.nodes: List[Node] = []
        self._anon = 0

    def build(self) -> List[Node]:
        elements = flatten_chain(self.state_input.state)
        # handle `every` at any chain position: group members tracked
        plan: List[Tuple[StateElement, Optional[int]]] = []  # (elem, group_start_pos)
        pos = 0
        for el in elements:
            if isinstance(el, EveryStateElement):
                inner = flatten_chain(el.element)
                start = pos
                for sub in inner:
                    plan.append((sub, None))
                    pos += 1
                # mark last node of the group for re-arming
                plan[-1] = (plan[-1][0], start)
            else:
                plan.append((el, None))
                pos += 1

        # pass 1: register refs so filters can reference later-declared
        # streams of earlier states only (reference behaves the same)
        for el, _ in plan:
            self._register_refs(el)

        for i, (el, rearm) in enumerate(plan):
            node = self._lower_element(el, i)
            node.rearm_to = rearm
            self.nodes.append(node)
        return self.nodes

    # -- ref registration ----------------------------------------------------

    def _reg(self, sse: StreamStateElement) -> str:
        ref = sse.event_ref
        if ref is None:
            ref = f"__s{self._anon}"
            self._anon += 1
            sse.event_ref = ref
        d = self.resolve_def(sse.stream)
        self.ref_defs[ref] = d
        sid = sse.stream.stream_id
        if sid in self.stream_to_ref and self.stream_to_ref[sid] != ref:
            self.stream_to_ref[sid] = None  # ambiguous
        elif sid not in self.stream_to_ref:
            self.stream_to_ref[sid] = ref
        return ref

    def _register_refs(self, el: StateElement):
        if isinstance(el, CountStateElement):
            self._reg(el.stream_state)
        elif isinstance(el, LogicalStateElement):
            for side in (el.element1, el.element2):
                if isinstance(side, (StreamStateElement,)):
                    self._reg(side)
                elif isinstance(side, CountStateElement):
                    self._reg(side.stream_state)
        elif isinstance(el, StreamStateElement):  # incl. Absent
            self._reg(el)
        else:
            raise SiddhiAppCreationError(f"unsupported state element {type(el).__name__}")

    # -- lowering ------------------------------------------------------------

    def _make_spec(self, sse: StreamStateElement) -> Spec:
        d = self.resolve_def(sse.stream)
        prefix = "#" if sse.stream.is_inner else ("!" if sse.stream.is_fault else "")
        spec = Spec(
            ref=sse.event_ref,
            stream_key=prefix + sse.stream.stream_id,
            stream_def=d,
            is_absent=isinstance(sse, AbsentStreamStateElement),
            waiting_ms=getattr(sse, "waiting_time_ms", None),
        )
        # compile pre-filters ANDed together
        filters = [h.expression for h in sse.stream.handlers if isinstance(h, Filter)]
        if len(sse.stream.handlers) != len(filters):
            raise SiddhiAppCreationError("only [filter] handlers are supported in pattern states")
        if filters:
            from siddhi_tpu_torch.query_api import AndOp, IsNullStream

            expr = filters[0]
            for f in filters[1:]:
                expr = AndOp(expr, f)
            scope = PatternScope(self.ref_defs, self.stream_to_ref, cand_def=d,
                                 cand_ref=sse.event_ref)
            compiler = ExpressionCompiler(scope)
            spec.raw_filter = expr
            spec.filter_compiled = compiler.compile(expr)
            spec.filter_capture_keys = {
                k: (r, i, a) for k, (r, i, a, _t) in scope.used_captures.items()
            }
            self._capture_types = getattr(self, "_capture_types", {})
            for k, (r, i, a, t) in scope.used_captures.items():
                self._capture_types[k] = t
            # presence keys for IsNullStream nodes
            spec.filter_presence_keys = _collect_presence(expr, self.ref_defs, self.stream_to_ref)
        return spec

    def _lower_element(self, el: StateElement, pos: int) -> Node:
        if isinstance(el, CountStateElement):
            spec = self._make_spec(el.stream_state)
            return Node(
                pos=pos, kind="stream", specs=[spec],
                min_count=el.min_count,
                max_count=el.max_count,
            )
        if isinstance(el, LogicalStateElement):
            sides = []
            for side in (el.element1, el.element2):
                if isinstance(side, CountStateElement):
                    raise SiddhiAppCreationError("count states inside logical and/or are not supported")
                sides.append(self._make_spec(side))
            if el.operator == "or" and any(s.is_absent for s in sides):
                if any(s.is_absent and s.waiting_ms is None for s in sides):
                    # `not B or C` without a 'for' window can never
                    # complete via the absent branch; the reference only
                    # supports the timed race (`not B for t or C`)
                    raise SiddhiAppCreationError(
                        "'or' with an absent state needs a 'for' duration")
                if all(s.is_absent for s in sides):
                    # two racing absences share one deadline register and
                    # one violation kill — not representable
                    raise SiddhiAppCreationError(
                        "'or' of two absent states is not supported")
            return Node(pos=pos, kind="logical", specs=sides, logical_op=el.operator)
        if isinstance(el, AbsentStreamStateElement):
            spec = self._make_spec(el)
            return Node(pos=pos, kind="absent", specs=[spec])
        if isinstance(el, StreamStateElement):
            spec = self._make_spec(el)
            return Node(pos=pos, kind="stream", specs=[spec])
        raise SiddhiAppCreationError(f"unsupported state element {type(el).__name__}")

    def capture_type(self, key: str) -> AttrType:
        return getattr(self, "_capture_types", {}).get(key, AttrType.OBJECT)


def _collect_presence(expr, ref_defs, stream_to_ref) -> Dict[str, Tuple[str, int]]:
    from siddhi_tpu_torch.query_api import (
        AndOp, ArithmeticOp, CompareOp, FunctionCall, InOp, IsNull,
        IsNullStream, NotOp, OrOp,
    )

    out: Dict[str, Tuple[str, int]] = {}

    def walk(e):
        if isinstance(e, IsNullStream):
            ref = e.stream_id if e.stream_id in ref_defs else stream_to_ref.get(e.stream_id)
            if ref is None:
                raise SiddhiAppCreationError(f"unknown event reference '{e.stream_id}'")
            idx = e.stream_index if e.stream_index is not None else 0
            out[f"__present.{e.stream_id}[{idx}]"] = (ref, idx)
        elif isinstance(e, (AndOp, OrOp)):
            walk(e.left)
            walk(e.right)
        elif isinstance(e, NotOp):
            walk(e.expr)
        elif isinstance(e, IsNull):
            walk(e.expr)
        elif isinstance(e, (ArithmeticOp, CompareOp)):
            walk(e.left)
            walk(e.right)
        elif isinstance(e, FunctionCall):
            for a in e.args:
                walk(a)
        elif isinstance(e, InOp):
            walk(e.expr)

    walk(expr)
    return out
