"""Execution elements: queries, input streams (single/join/state),
pattern/sequence state-element trees, output streams, rate limits,
partitions, and on-demand (store) queries.

Mirrors ``io.siddhi.query.api.execution.*`` (SURVEY.md §1 L0): the state
element tree here is what the planner lowers to the dense NFA (the
reference instead walks it into a chain-of-processors NFA in
util/parser/StateInputStreamParser.java:73).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

from siddhi_tpu_torch.query_api.annotation import Annotation
from siddhi_tpu_torch.query_api.expression import Expression, FunctionCall, Variable


# ---------------------------------------------------------------------------
# Stream handlers (filters / stream functions / windows on a source)
# ---------------------------------------------------------------------------


class StreamHandler:
    __slots__ = ()


@dataclass
class Filter(StreamHandler):
    expression: Expression


@dataclass
class StreamFunction(StreamHandler):
    """``#ns:fn(args)`` stream processor call."""

    namespace: Optional[str]
    name: str
    args: tuple = ()


@dataclass
class WindowHandler(StreamHandler):
    """``#window.ns:fn(args)``."""

    namespace: Optional[str]
    name: str
    args: tuple = ()


# ---------------------------------------------------------------------------
# Input streams
# ---------------------------------------------------------------------------


class InputStream:
    __slots__ = ()


@dataclass
class SingleInputStream(InputStream):
    stream_id: str
    is_inner: bool = False
    is_fault: bool = False
    handlers: List[StreamHandler] = field(default_factory=list)
    alias: Optional[str] = None

    @property
    def window(self) -> Optional[WindowHandler]:
        for h in self.handlers:
            if isinstance(h, WindowHandler):
                return h
        return None

    @property
    def unique_id(self) -> str:
        return self.alias or self.stream_id


@dataclass
class AnonymousInputStream(InputStream):
    """``from (from X select ... return)`` inner query as a source."""

    query: "Query" = None


@dataclass
class JoinInputStream(InputStream):
    JOIN = "join"
    INNER_JOIN = "inner_join"
    LEFT_OUTER = "left_outer"
    RIGHT_OUTER = "right_outer"
    FULL_OUTER = "full_outer"

    left: SingleInputStream = None
    join_type: str = "join"
    right: SingleInputStream = None
    on_condition: Optional[Expression] = None
    # UNIDIRECTIONAL marker: 'left' | 'right' | None
    trigger: Optional[str] = None
    within: Optional[Expression] = None
    per: Optional[Expression] = None


# --- pattern / sequence state elements -------------------------------------


class StateElement:
    __slots__ = ()


@dataclass
class StreamStateElement(StateElement):
    """A single event-capturing state: ``e1=Stream[filter]``."""

    stream: SingleInputStream = None
    event_ref: Optional[str] = None  # e1
    within: Optional[int] = None  # ms (pattern-level withins pushed down)


@dataclass
class AbsentStreamStateElement(StreamStateElement):
    """``not Stream[filter] for 5 sec`` — absence detection."""

    waiting_time_ms: Optional[int] = None


@dataclass
class CountStateElement(StateElement):
    """``e=S[f]<2:5>`` (pattern count) or sequence ``*``/``+``/``?``."""

    ANY = -1

    stream_state: StreamStateElement = None
    min_count: int = 1
    max_count: int = 1  # ANY for unbounded


@dataclass
class LogicalStateElement(StateElement):
    """``A and B`` / ``A or B`` over two stream states."""

    element1: StateElement = None
    operator: str = "and"  # 'and' | 'or'
    element2: StateElement = None


@dataclass
class NextStateElement(StateElement):
    """Pattern ``A -> B`` or sequence ``A , B``."""

    element: StateElement = None
    next: StateElement = None


@dataclass
class EveryStateElement(StateElement):
    """``every (A -> B)`` — re-arming start state."""

    element: StateElement = None


@dataclass
class StateInputStream(InputStream):
    PATTERN = "pattern"
    SEQUENCE = "sequence"

    type: str = PATTERN
    state: StateElement = None
    within_ms: Optional[int] = None

    def stream_ids(self) -> List[str]:
        out: List[str] = []

        def walk(e: StateElement):
            if isinstance(e, StreamStateElement):
                out.append(e.stream.stream_id)
            elif isinstance(e, CountStateElement):
                walk(e.stream_state)
            elif isinstance(e, LogicalStateElement):
                walk(e.element1)
                walk(e.element2)
            elif isinstance(e, NextStateElement):
                walk(e.element)
                walk(e.next)
            elif isinstance(e, EveryStateElement):
                walk(e.element)

        walk(self.state)
        return out


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------


@dataclass
class OutputAttribute:
    expression: Expression
    rename: Optional[str] = None

    @property
    def name(self) -> str:
        if self.rename:
            return self.rename
        e = self.expression
        if isinstance(e, Variable):
            return e.attribute
        raise ValueError(f"output attribute needs 'as' rename: {e}")


@dataclass
class OrderByAttribute:
    variable: Variable
    ascending: bool = True


@dataclass
class Selector:
    # None means `select *`
    selection: Optional[List[OutputAttribute]] = None
    group_by: List[Variable] = field(default_factory=list)
    having: Optional[Expression] = None
    order_by: List[OrderByAttribute] = field(default_factory=list)
    limit: Optional[Expression] = None
    offset: Optional[Expression] = None

    @property
    def is_select_all(self) -> bool:
        return self.selection is None


# ---------------------------------------------------------------------------
# Output streams & rate limiting
# ---------------------------------------------------------------------------


class OutputStream:
    __slots__ = ()


@dataclass
class InsertIntoStream(OutputStream):
    target: str = ""
    # which events flow out: 'current' | 'expired' | 'all'
    event_type: str = "current"
    is_inner: bool = False
    is_fault: bool = False


@dataclass
class ReturnStream(OutputStream):
    event_type: str = "current"


@dataclass
class SetAttribute:
    variable: Variable
    expression: Expression


@dataclass
class DeleteStream(OutputStream):
    target: str = ""
    event_type: str = "current"
    on_condition: Optional[Expression] = None


@dataclass
class UpdateStream(OutputStream):
    target: str = ""
    event_type: str = "current"
    set_clause: Optional[List[SetAttribute]] = None
    on_condition: Optional[Expression] = None


@dataclass
class UpdateOrInsertStream(OutputStream):
    target: str = ""
    event_type: str = "current"
    set_clause: Optional[List[SetAttribute]] = None
    on_condition: Optional[Expression] = None


class OutputRate:
    __slots__ = ()


@dataclass
class EventOutputRate(OutputRate):
    events: int = 1
    type: str = "all"  # all | first | last


@dataclass
class TimeOutputRate(OutputRate):
    value_ms: int = 0
    type: str = "all"


@dataclass
class SnapshotOutputRate(OutputRate):
    value_ms: int = 0


# ---------------------------------------------------------------------------
# Query / partition / on-demand query
# ---------------------------------------------------------------------------


@dataclass
class Query:
    input_stream: InputStream = None
    selector: Selector = field(default_factory=Selector)
    output_stream: OutputStream = None
    output_rate: Optional[OutputRate] = None
    annotations: List[Annotation] = field(default_factory=list)


class PartitionType:
    __slots__ = ()


@dataclass
class ValuePartitionType(PartitionType):
    stream_id: str = ""
    expression: Expression = None


@dataclass
class RangePartitionType(PartitionType):
    stream_id: str = ""
    # ordered (condition, label) pairs
    ranges: List[Tuple[Expression, str]] = field(default_factory=list)


@dataclass
class Partition:
    partition_types: List[PartitionType] = field(default_factory=list)
    queries: List[Query] = field(default_factory=list)
    annotations: List[Annotation] = field(default_factory=list)


@dataclass
class OnDemandQuery:
    """Pull query against a table / window / aggregation
    (reference: query/OnDemandQueryRuntime.java, SiddhiCompiler.parseOnDemandQuery).
    """

    # FIND | INSERT | DELETE | UPDATE | UPDATE_OR_INSERT
    type: str = "find"
    input_store: Optional[str] = None
    input_alias: Optional[str] = None
    on_condition: Optional[Expression] = None
    within: Optional[Tuple[Expression, Optional[Expression]]] = None
    per: Optional[Expression] = None
    selector: Selector = field(default_factory=Selector)
    output_stream: Optional[OutputStream] = None
