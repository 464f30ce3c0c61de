"""Pattern/sequence NFA: lowering and the host engine.

Port of the JAX package's ``ops/nfa.py``, kept as a copy so the port
imports nothing of that package.  Its lowering half (``Spec``, ``Node``,
``PatternScope``, ``flatten_chain``, ``NFABuilder``,
``_collect_presence``) turns the state-element tree into a linear chain
of stream / logical / absent nodes with count ranges, ``every`` re-arm
markers and per-spec filters.  ``ops/dense_nfa.py`` compiles that chain
for the device; its host half (``Instance``, ``PatternProcessor``) runs
it on Python objects, one event at a time, and is the correctness
reference the dense engine is held to (the reference's chain of
processors: StreamPreStateProcessor.java:46,
StreamPostStateProcessor.java:64, LogicalPreStateProcessor.java:33,
CountPreStateProcessor.java:34, AbsentStreamPreStateProcessor.java:35):

- pattern mode: non-matching events are ignored; instances persist.
- sequence mode: an event an instance cannot use kills it (strict
  continuity); the start node is kept armed; only one pending per state.
- ``every`` groups re-arm a fresh instance at the group start (keeping
  captures of nodes before the group) when the group's last node first
  completes.
- count nodes ``<min:max>`` capture greedily; once count >= min the
  instance is also pending on the following node(s); advancing clones
  the instance, the original keeps capturing while below max.
- non-every patterns and sequences stop after the first emitted match.
- ``within t`` drops partial matches older than t, on each event.
- absent nodes (``not X for t``) complete through the app scheduler
  (``on_time``, ``next_wakeup``); a matching X before the deadline
  kills the instance.

The builder compiles each spec's filter with the host compiler
(``planner/host_expr.py``), as the JAX package compiles it with its one
numpy compiler: the host engine evaluates it on Python scalars (a
float32 column value arrives widened to a Python float through
``_unbox``, a DOUBLE constant is ``np.float64``, a comparison that raises
``TypeError`` on a null is False).  The dense engine re-compiles the raw
filter against its register lanes (``DenseExprCompiler``, float32).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.planner.host_expr import (
    N_KEY,
    TS_KEY,
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


class Instance:
    __slots__ = (
        "pos", "captured", "count", "matched_sides", "violated",
        "first_ts", "enter_ts", "deadline", "emitted_at_node", "alive",
    )

    def __init__(self, pos: int, enter_ts: int):
        self.pos = pos
        self.captured: Dict[str, List[dict]] = {}
        self.count = 0  # captures at current node
        self.matched_sides: Set[int] = set()  # logical progress
        self.violated = False
        self.first_ts: Optional[int] = None
        self.enter_ts = enter_ts
        self.deadline: Optional[int] = None  # absent node deadline
        self.emitted_at_node: Set[int] = set()
        self.alive = True

    def clone(self) -> "Instance":
        c = Instance(self.pos, self.enter_ts)
        c.captured = {k: list(v) for k, v in self.captured.items()}
        c.count = self.count
        c.matched_sides = set(self.matched_sides)
        c.violated = self.violated
        c.first_ts = self.first_ts
        c.deadline = self.deadline
        c.emitted_at_node = set(self.emitted_at_node)
        return c

    def is_virgin(self) -> bool:
        return self.pos == 0 and not self.captured and self.count == 0


def instance_from_plain(d: Dict) -> Instance:
    """An ``Instance`` from the dict of its ``__slots__`` values.  The
    capture lists are taken as they are, so two instances sharing one
    (an open count forwarded into an absent node) keep sharing it."""
    inst = Instance(d["pos"], d["enter_ts"])
    for slot in Instance.__slots__:
        setattr(inst, slot, d[slot])
    return inst


def _extract(captured: Dict[str, List[dict]], ref: str, idx: Optional[int], attr: str, attr_type: AttrType):
    rows = captured.get(ref)
    if not rows:
        row = None
    else:
        i = 0 if idx is None else (len(rows) + idx if idx < 0 else idx)
        row = rows[i] if 0 <= i < len(rows) else None
    if row is None:
        # null representation: NaN for numerics, None for objects
        if attr_type in (AttrType.FLOAT, AttrType.DOUBLE, AttrType.INT, AttrType.LONG):
            return math.nan
        return None
    return row.get(attr)


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


# ---------------------------------------------------------------------------
# Runtime engine
# ---------------------------------------------------------------------------


class PatternProcessor:
    """Executes the lowered NFA over incoming events.

    Instances MOVE off a node once it can accept no more events
    (count == max); an in-progress count node (min <= count < max) is
    dually pending: it can capture more events AND spawn an advancing
    clone when an event matches a successor (the reference's shared
    linked-list forwarding, CountPreStateProcessor).

    ``emit(match_batch)`` receives a columnar batch whose columns are the
    capture keys requested by the planner (e.g. ``e1.price``).
    """

    def __init__(
        self,
        nodes: List[Node],
        mode: str,  # 'pattern' | 'sequence'
        within_ms: Optional[int],
        ref_defs: Dict[str, StreamDefinition],
        # output spec: key -> (ref, idx|None, attr, AttrType)
        output_keys: Dict[str, Tuple[str, Optional[int], str, AttrType]],
        presence_keys: Dict[str, Tuple[str, int]],
        emit: Callable[[EventBatch], None],
        out_stream_id: str = "#pattern_matches",
    ):
        self.nodes = nodes
        self.mode = mode
        self.within_ms = within_ms
        self.ref_defs = ref_defs
        self.output_keys = output_keys
        self.presence_keys = presence_keys
        self.emit_cb = emit
        self.out_stream_id = out_stream_id
        self.instances: List[Instance] = []
        self.matched_once = False
        self.has_every = any(n.rearm_to is not None for n in self.nodes)
        self._now = 0
        self._pending_matches: List[Tuple[Instance, int]] = []
        self._arm_fresh(0, 0)

    # -- state plumbing (snapshot contract) ---------------------------------

    def snapshot(self) -> Dict:
        return {"instances": self.instances, "matched_once": self.matched_once}

    def restore(self, state: Dict):
        """``state`` as ``snapshot`` gives it, or its plain form: each
        instance a dict of its ``Instance.__slots__`` values (the JAX
        package's snapshot carries its own Instance objects)."""
        self.instances = [instance_from_plain(i) if isinstance(i, dict)
                          else i for i in state["instances"]]
        self.matched_once = state["matched_once"]

    # -- arming -------------------------------------------------------------

    def _arm_fresh(self, pos: int, now: int, src: Optional[Instance] = None):
        """Arm an instance at `pos` (virgin or every-rearm), keeping the
        captures of nodes before `pos` from `src`."""
        inst = Instance(pos, now)
        if src is not None and pos > 0:
            keep_refs = set()
            for n in self.nodes[:pos]:
                for s in n.specs:
                    keep_refs.add(s.ref)
            inst.captured = {r: list(v) for r, v in src.captured.items() if r in keep_refs}
            if inst.captured:
                inst.first_ts = src.first_ts
        # single pending per state for sequences; dedupe identical virgins
        if self.mode == "sequence" and any(
            i.alive and i.pos == pos for i in self.instances
        ):
            return
        if pos == 0 and not inst.captured and any(
            i.alive and i.is_virgin() for i in self.instances
        ):
            return
        self._enter_node(inst, pos, now)
        self.instances.append(inst)

    def _pend_match(self, inst: Instance, ts: int):
        if not any(i is inst for i, _ in self._pending_matches):
            self._pending_matches.append((inst, ts))

    def _enter_node(self, inst: Instance, pos: int, now: int):
        """Instance arrives at node `pos` with no captures there yet."""
        inst.pos = pos
        inst.count = 0
        inst.matched_sides = set()
        inst.enter_ts = now
        inst.deadline = None
        if pos >= len(self.nodes):
            return
        node = self.nodes[pos]
        for s in node.specs:
            if s.is_absent and s.waiting_ms is not None:
                inst.deadline = now + s.waiting_ms
        # min==0 stream nodes are satisfied on entry: handle every-rearm and
        # end-of-chain emission cascades
        if node.kind == "stream" and node.min_count == 0:
            if node.rearm_to is not None and node.rearm_to != pos:
                self._arm_fresh(node.rearm_to, now, src=inst)
            if self._end_reachable(pos + 1) and pos not in inst.emitted_at_node:
                inst.emitted_at_node.add(pos)
                self._pend_match(inst, now)

    # -- chain reachability -------------------------------------------------

    def _end_reachable(self, pos: int) -> bool:
        p = pos
        while p < len(self.nodes):
            n = self.nodes[p]
            if n.kind == "stream" and n.min_count == 0:
                p += 1
                continue
            return False
        return True

    def _successors(self, pos: int) -> List[int]:
        """Nodes testable after a satisfied node at `pos`: next node plus
        any reachable through zero-min stream nodes (absent stops the
        scan: it completes only by timer)."""
        out: List[int] = []
        p = pos + 1
        while p < len(self.nodes):
            n = self.nodes[p]
            if n.kind == "absent":
                break
            out.append(p)
            if n.kind == "stream" and n.min_count == 0:
                p += 1
                continue
            break
        return out

    # -- filters ------------------------------------------------------------

    def _filter_pass(self, spec: Spec, inst: Instance, row: dict, ts: int) -> bool:
        if spec.filter_compiled is None:
            return True
        env = {}
        for a in spec.stream_def.attribute_names:
            env["__cand." + a] = row.get(a)
        for key, (ref, idx, attr) in spec.filter_capture_keys.items():
            d = self.ref_defs[ref]
            t = d.attribute_type(attr) if attr in d.attribute_names else AttrType.OBJECT
            env[key] = _extract(inst.captured, ref, idx, attr, t)
        for key, (ref, idx) in spec.filter_presence_keys.items():
            rows = inst.captured.get(ref, [])
            i = len(rows) + idx if idx < 0 else idx
            env[key] = np.bool_(0 <= i < len(rows))
        env[TS_KEY] = ts
        env[N_KEY] = 1
        try:
            return bool(spec.filter_compiled.fn(env))
        except TypeError:
            return False  # null in comparison — no match

    # -- event processing ---------------------------------------------------

    def process_stream_batch(self, stream_key: str, batch: EventBatch):
        names = batch.attribute_names
        for i in range(len(batch)):
            if batch.types[i] != ev.CURRENT:
                continue
            row = {a: _unbox(batch.columns[a][i]) for a in names}
            self._process_event(stream_key, row, int(batch.timestamps[i]))

    def _process_event(self, stream_key: str, row: dict, ts: int):
        if self.matched_once and not self.has_every:
            return
        self._now = ts
        self._expire(ts)
        staged: List[Instance] = []

        for inst in list(self.instances):
            if not inst.alive:
                continue
            was_virgin = inst.is_virgin()
            used = False
            captured = False
            if inst.pos < len(self.nodes):
                node = self.nodes[inst.pos]
                # 1) dual-pending advances (tested against pre-capture state)
                if node.kind == "stream" and inst.count >= node.min_count and (
                    node.max_count == ANY or inst.count < node.max_count
                ):
                    advanced = False
                    for sp in self._successors(inst.pos):
                        advanced |= self._try_enter(
                            inst, self.nodes[sp], stream_key, row, ts, staged, via_clone=True
                        )
                    if advanced:
                        # the forwarded instance is SHARED with the
                        # successor — once the successor captures, the
                        # count state drops its copy and the arm emits at
                        # most once, in BOTH modes, even when the event
                        # could also have extended the count (reference
                        # CountPreStateProcessor.removeIfNextState-
                        # Processed runs before capture; pinned by
                        # ComplexPatternTestCase.testQuery3's three
                        # non-repeating matches and the peak corpus
                        # SequenceTestCase.testQuery20/23 restarts)
                        inst.alive = False
                    used |= advanced
                # 2) capture at current node
                if inst.alive:
                    captured = self._try_capture(inst, node, stream_key, row, ts)
                    used |= captured
                # 3) absent violation
                for s in node.specs:
                    if (
                        s.is_absent
                        and s.stream_key == stream_key
                        and self._filter_pass(s, inst, row, ts)
                    ):
                        if (
                            node.kind == "logical"
                            and node.logical_op == "or"
                            and any(not sp.is_absent for sp in node.specs)
                        ):
                            # `not B for t or C`: B only disables the
                            # absent branch — C may still win the race
                            # (LogicalAbsentPatternTestCase.
                            # testQueryAbsent15/16)
                            inst.violated = True
                        else:
                            inst.alive = False
                        used = True
            # strict continuity for sequences: only a CAPTURE keeps an
            # instance alive — an arm whose clone advanced via the
            # dual-pending path but which could not use the event itself
            # dies (reference: resetState clears all pendings each event;
            # only addState'd instances survive — the peak-detection
            # corpus SequenceTestCase.testQuery20 pins the restart).
            # Arms WAITING at an absent node are immune: the waiting
            # state consumes no events, and only a filter-matching
            # absent-stream event (the violation above) or the timer may
            # resolve it (AbsentSequenceTestCase.testQueryAbsent4/13)
            at_absent = (
                inst.pos < len(self.nodes)
                and self.nodes[inst.pos].kind == "absent"
            )
            if (self.mode == "sequence" and not captured and not was_virgin
                    and inst.alive and not at_absent):
                inst.alive = False

        self.instances = [i for i in self.instances if i.alive]
        self.instances.extend(i for i in staged if i.alive)
        self._flush_matches()  # consume emitted instances first
        if self.mode == "sequence":
            # single pending per state (reference keeps one,
            # StreamPreStateProcessor.addState for SEQUENCE)
            seen_pos = set()
            for i in self.instances:
                if i.pos in seen_pos:
                    i.alive = False
                else:
                    seen_pos.add(i.pos)
            self.instances = [i for i in self.instances if i.alive]
        if self.mode == "sequence" and self.has_every:
            # only `every` sequences re-arm the start per event; a
            # non-every sequence arms once and dies with its arm
            # (reference: init() re-arms only when
            # nextEveryStatePreProcessor != null —
            # SequenceTestCase.testQuery31 expects zero matches)
            if not any(i.alive and i.pos == 0 for i in self.instances):
                self._arm_fresh(0, ts)

    def _try_capture(self, inst: Instance, node: Node, stream_key: str, row: dict, ts: int) -> bool:
        if node.kind == "stream":
            spec = node.specs[0]
            if spec.is_absent or spec.stream_key != stream_key:
                return False
            if node.max_count != ANY and inst.count >= node.max_count:
                return False
            if not self._filter_pass(spec, inst, row, ts):
                return False
            was_satisfied = inst.count >= node.min_count
            inst.captured.setdefault(spec.ref, []).append(dict(row, __ts=ts))
            inst.count += 1
            if inst.first_ts is None:
                inst.first_ts = ts
            if inst.count >= node.min_count and not was_satisfied:
                if node.rearm_to is not None:
                    self._arm_fresh(node.rearm_to, ts, src=inst)
                if self._end_reachable(node.pos + 1) and node.pos not in inst.emitted_at_node:
                    inst.emitted_at_node.add(node.pos)
                    self._pend_match(inst, ts)
                # an open count forwards ONCE into a following absent
                # node at min-satisfaction (reference
                # processMinCountReached / SEQUENCE addState), with
                # SHARED capture lists so later captures are visible
                # when the deadline fires
                # (AbsentSequenceTestCase.testQueryAbsent36)
                open_count = (
                    node.max_count == ANY or node.max_count > node.min_count
                )
                if (
                    open_count
                    and node.pos + 1 < len(self.nodes)
                    and self.nodes[node.pos + 1].kind == "absent"
                ):
                    fwd = Instance(node.pos + 1, ts)
                    fwd.captured = inst.captured  # shared, not copied
                    fwd.first_ts = inst.first_ts
                    self._enter_node(fwd, node.pos + 1, ts)
                    self.instances.append(fwd)
            if node.max_count != ANY and inst.count >= node.max_count:
                # node full: move on (enter may cascade emits for min-0 tails)
                self._enter_node(inst, node.pos + 1, ts)
            return True
        if node.kind == "logical":
            got = False
            for si, spec in enumerate(node.specs):
                if spec.is_absent or si in inst.matched_sides:
                    continue
                if spec.stream_key == stream_key and self._filter_pass(spec, inst, row, ts):
                    inst.captured.setdefault(spec.ref, []).append(dict(row, __ts=ts))
                    inst.matched_sides.add(si)
                    if inst.first_ts is None:
                        inst.first_ts = ts
                    got = True
                    # 'and': ONE event can satisfy BOTH sides (reference
                    # partner processors each see it —
                    # LogicalPatternTestCase.testQuery5); 'or' consumes
                    # the first matching side only (testQuery3)
                    if node.logical_op == "or":
                        break
            if got and self._logical_complete(node, inst):
                self._complete_logical(inst, node, ts)
            return got
        return False

    def _try_enter(
        self, src: Instance, node: Node, stream_key: str, row: dict, ts: int,
        staged: List[Instance], via_clone: bool,
    ) -> bool:
        """An event enters successor `node` from dually-pending `src`."""
        if node.kind == "stream":
            spec = node.specs[0]
            if spec.is_absent or spec.stream_key != stream_key:
                return False
            if not self._filter_pass(spec, src, row, ts):
                return False
            inst = src.clone()
            self._enter_node_quiet(inst, node.pos, ts)
            inst.captured.setdefault(spec.ref, []).append(dict(row, __ts=ts))
            inst.count = 1
            if inst.first_ts is None:
                inst.first_ts = ts
            staged.append(inst)
            if inst.count >= node.min_count:
                if node.rearm_to is not None:
                    self._arm_fresh(node.rearm_to, ts, src=inst)
                if self._end_reachable(node.pos + 1):
                    inst.emitted_at_node.add(node.pos)
                    self._pend_match(inst, ts)
                if node.max_count != ANY and inst.count >= node.max_count:
                    self._enter_node(inst, node.pos + 1, ts)
            return True
        if node.kind == "logical":
            hits = []
            for si, spec in enumerate(node.specs):
                if spec.is_absent:
                    continue
                if spec.stream_key == stream_key and self._filter_pass(spec, src, row, ts):
                    hits.append(si)
                    if node.logical_op == "or":
                        break
            if not hits:
                return False
            inst = src.clone()
            self._enter_node_quiet(inst, node.pos, ts)
            for si in hits:
                inst.captured.setdefault(node.specs[si].ref, []).append(dict(row, __ts=ts))
            inst.matched_sides = set(hits)
            if inst.first_ts is None:
                inst.first_ts = ts
            staged.append(inst)
            if self._logical_complete(node, inst):
                self._complete_logical(inst, node, ts)
            return True
        return False

    def _enter_node_quiet(self, inst: Instance, pos: int, now: int):
        """enter without min-0 emission cascade (the entering event's own
        capture decides emission)."""
        inst.pos = pos
        inst.count = 0
        inst.matched_sides = set()
        inst.enter_ts = now
        inst.deadline = None
        if pos < len(self.nodes):
            for s in self.nodes[pos].specs:
                if s.is_absent and s.waiting_ms is not None:
                    inst.deadline = now + s.waiting_ms

    def _logical_complete(self, node: Node, inst: Instance) -> bool:
        present = [i for i, s in enumerate(node.specs) if not s.is_absent]
        if node.logical_op == "or":
            return any(i in inst.matched_sides for i in present)
        if not all(i in inst.matched_sides for i in present):
            return False
        # and-not with `for t`: absence must hold the full window
        if inst.deadline is not None:
            return self._now >= inst.deadline
        return True

    def _complete_logical(self, inst: Instance, node: Node, ts: int):
        if node.rearm_to is not None:
            self._arm_fresh(node.rearm_to, ts, src=inst)
        if self._end_reachable(node.pos + 1):
            inst.emitted_at_node.add(node.pos)
            self._pend_match(inst, ts)
        else:
            self._enter_node(inst, node.pos + 1, ts)

    # -- expiry / timers ----------------------------------------------------

    def _expire(self, now: int):
        if self.within_ms is None:
            return
        expired_src: Optional[Instance] = None
        for inst in self.instances:
            if inst.first_ts is not None and now - inst.first_ts > self.within_ms:
                inst.alive = False
                expired_src = inst
        self.instances = [i for i in self.instances if i.alive]
        if (
            expired_src is not None
            and self.mode == "pattern"
            and self.has_every
        ):
            # an every-pattern whose pending arm ran out of its within
            # window re-arms a fresh start (reference: expireEvents →
            # withinEveryPreStateProcessor.addEveryState, one re-arm per
            # tick; keeps captures before the every-group start).
            # _arm_fresh dedupes against an existing virgin, so patterns
            # that already keep a standing virgin are unaffected
            # (WithinPatternTestCase.testQuery1 vs testQuery4).
            restart = min(
                n.rearm_to for n in self.nodes if n.rearm_to is not None
            )
            self._arm_fresh(restart, now, src=expired_src)

    def on_time(self, now: int):
        """Scheduler tick: absent-node deadlines fire."""
        if self.matched_once and not self.has_every:
            return
        self._now = now
        self._expire(now)
        for inst in list(self.instances):
            if not inst.alive or inst.deadline is None or now < inst.deadline:
                continue
            if inst.pos >= len(self.nodes):
                continue
            node = self.nodes[inst.pos]
            fire_ts = inst.deadline
            inst.deadline = None
            if node.kind == "absent":
                if node.rearm_to is not None:
                    self._arm_fresh(node.rearm_to, fire_ts, src=inst)
                if self._end_reachable(node.pos + 1):
                    inst.emitted_at_node.add(node.pos)
                    self._pend_match(inst, fire_ts)
                else:
                    self._enter_node(inst, node.pos + 1, fire_ts)
            elif node.kind == "logical":
                if self._logical_complete(node, inst):
                    self._complete_logical(inst, node, fire_ts)
                elif (
                    node.logical_op == "or"
                    and not inst.violated
                    and any(s.is_absent for s in node.specs)
                ):
                    # `not B for t or C`: the absence window passed
                    # unviolated before any present side matched — the
                    # absent branch wins with null present captures
                    # (LogicalAbsentPatternTestCase.testQueryAbsent13)
                    self._complete_logical(inst, node, fire_ts)
        self._flush_matches()

    def next_wakeup(self) -> Optional[int]:
        deadlines = [i.deadline for i in self.instances if i.alive and i.deadline is not None]
        return min(deadlines) if deadlines else None

    def stats(self) -> Dict:
        """Ops introspection — same shape as the dense runtime's so the
        REST/on-demand surface is engine-agnostic."""
        return {
            "engine": "host",
            "active_instances": sum(1 for i in self.instances if i.alive),
            "matched_once": self.matched_once,
        }

    def fire(self, now: int):
        self.on_time(now)

    def on_start(self, now: int):
        """App start: (re)base deadlines of initially-armed instances —
        leading absent nodes count their window from start time."""
        for inst in self.instances:
            if inst.deadline is not None:
                node = self.nodes[inst.pos]
                wait = None
                for sp in node.specs:
                    if sp.is_absent and sp.waiting_ms is not None:
                        wait = sp.waiting_ms
                if wait is not None:
                    inst.enter_ts = now
                    inst.deadline = now + wait

    # -- emission -----------------------------------------------------------

    def _flush_matches(self):
        matches, self._pending_matches = self._pending_matches, []
        if not matches:
            return
        rows = []
        for inst, ts in matches:
            row = {"__ts": ts}
            for key, (ref, idx, attr, t) in self.output_keys.items():
                row[key] = _extract(inst.captured, ref, idx, attr, t)
            for key, (ref, idx) in self.presence_keys.items():
                caps = inst.captured.get(ref, [])
                i = len(caps) + idx if idx < 0 else idx
                row[key] = np.bool_(0 <= i < len(caps))
            rows.append(row)
            # matched instance is consumed unless it is an in-progress count
            # node still capturing (dual pending, shared-list analog)
            inst_node = self.nodes[inst.pos] if inst.pos < len(self.nodes) else None
            dual = (
                inst_node is not None
                and inst_node.kind == "stream"
                and inst_node.pos in inst.emitted_at_node
                and (inst_node.max_count == ANY or inst.count < inst_node.max_count)
                and inst.count > 0
            )
            if not dual:
                inst.alive = False
        if not self.has_every:
            self.matched_once = True
            for i in self.instances:
                i.alive = False
        self.instances = [i for i in self.instances if i.alive]
        # columnar match batch
        keys = list(self.output_keys) + list(self.presence_keys)
        cols: Dict[str, np.ndarray] = {}
        for key in keys:
            vals = [r.get(key) for r in rows]
            if key in self.output_keys:
                cols[key] = _column(vals, self.output_keys[key][3])
            else:
                cols[key] = np.asarray(vals, dtype=bool)
        batch = EventBatch(
            self.out_stream_id,
            keys,
            cols,
            np.asarray([r["__ts"] for r in rows], dtype=np.int64),
        )
        self.emit_cb(batch)


def _column(vals: List, t: AttrType) -> np.ndarray:
    has_null = any(v is None or (isinstance(v, float) and math.isnan(v)) for v in vals)
    if has_null or t in (AttrType.STRING, AttrType.OBJECT):
        # unmatched slots surface as nulls (reference emits null), so the
        # column falls back to object dtype
        out = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals):
            out[i] = None if (isinstance(v, float) and math.isnan(v)) else v
        return out
    return np.asarray(vals, dtype=t.np_dtype)


def _unbox(v):
    return v.item() if isinstance(v, np.generic) else v
