"""Fluent builder API for constructing apps programmatically.

Mirrors the reference's L0 fluent surface (SURVEY.md §1:
``SiddhiApp.siddhiApp(...)``, ``StreamDefinition.id(...).attribute(...)``,
``Query.query().from_(...).select(...).insertInto(...)``,
``Expression.value/variable/compare`` — SiddhiApp.java:1-375,
query/api/expression/Expression.java) so apps can be built without
SiddhiQL strings::

    from siddhi_tpu_torch.query_api import builder as b

    app = (b.siddhi_app("demo")
           .define_stream(b.stream("S").attribute("sym", AttrType.STRING)
                                        .attribute("v", AttrType.LONG))
           .add_query(b.query("q1")
                      .from_stream("S", where=b.compare(b.var("v"), ">", b.value(10)))
                      .select(("sym", b.var("sym")), ("v", b.var("v")))
                      .insert_into("Out")))

The produced objects are the ordinary query-api dataclasses; pass the
app to ``SiddhiManager.create_siddhi_app_runtime``.  A copy of the JAX
package's ``query_api/builder.py`` over the port's query API.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

from siddhi_tpu_torch.query_api.annotation import Annotation
from siddhi_tpu_torch.query_api.app import SiddhiApp
from siddhi_tpu_torch.query_api.attribute import Attribute, AttrType
from siddhi_tpu_torch.query_api.definition import StreamDefinition, TableDefinition
from siddhi_tpu_torch.query_api.execution import (
    Filter,
    InsertIntoStream,
    OutputAttribute,
    Query,
    Selector,
    SingleInputStream,
    WindowHandler,
)
from siddhi_tpu_torch.query_api.expression import (
    AndOp,
    ArithmeticOp,
    CompareOp,
    Constant,
    Expression,
    FunctionCall,
    NotOp,
    OrOp,
    Variable,
)

_PY_TYPES = {
    bool: AttrType.BOOL,
    int: AttrType.LONG,
    float: AttrType.DOUBLE,
    str: AttrType.STRING,
}


# -- expressions (reference: Expression.value/variable/compare/and/or/not) ---


def value(v) -> Constant:
    t = _PY_TYPES.get(type(v), AttrType.OBJECT)
    return Constant(v, t)


def var(attribute: str, of: Optional[str] = None) -> Variable:
    return Variable(attribute=attribute, stream_id=of)


def compare(left: Expression, op: str, right: Expression) -> CompareOp:
    return CompareOp(op, left, right)


def and_(left: Expression, right: Expression) -> AndOp:
    return AndOp(left, right)


def or_(left: Expression, right: Expression) -> OrOp:
    return OrOp(left, right)


def not_(e: Expression) -> NotOp:
    return NotOp(e)


def function(name: str, *args: Expression, namespace: Optional[str] = None) -> FunctionCall:
    return FunctionCall(namespace, name, tuple(args))


def add(left: Expression, right: Expression) -> ArithmeticOp:
    return ArithmeticOp("+", left, right)


def subtract(left: Expression, right: Expression) -> ArithmeticOp:
    return ArithmeticOp("-", left, right)


def multiply(left: Expression, right: Expression) -> ArithmeticOp:
    return ArithmeticOp("*", left, right)


def divide(left: Expression, right: Expression) -> ArithmeticOp:
    return ArithmeticOp("/", left, right)


# -- definitions -------------------------------------------------------------


class _DefinitionBuilder:
    _cls = StreamDefinition

    def __init__(self, id: str):
        self._d = self._cls(id)

    def attribute(self, name: str, type: AttrType):
        self._d.attributes.append(Attribute(name, type))
        return self

    def annotation(self, ann: Annotation):
        self._d.annotations.append(ann)
        return self

    def build(self):
        return self._d


class stream(_DefinitionBuilder):
    """``StreamDefinition.id(x).attribute(...)`` analog."""

    _cls = StreamDefinition


class table(_DefinitionBuilder):
    """``TableDefinition.id(x).attribute(...)`` analog."""

    _cls = TableDefinition


# -- queries -----------------------------------------------------------------


class query:
    """``Query.query().from(...).select(...).insertInto(...)`` analog."""

    def __init__(self, name: Optional[str] = None):
        self._q = Query()
        if name:
            self._q.annotations.append(Annotation("info", [("name", name)]))

    def from_stream(self, stream_id: str, where: Optional[Expression] = None,
                    window: Optional[Tuple[str, Sequence[Expression]]] = None,
                    alias: Optional[str] = None) -> "query":
        handlers = []
        if where is not None:
            handlers.append(Filter(where))
        if window is not None:
            w_name, w_args = window
            handlers.append(WindowHandler(None, w_name, tuple(w_args)))
        self._q.input_stream = SingleInputStream(
            stream_id, handlers=handlers, alias=alias)
        return self

    def select(self, *items: Union[str, Tuple[str, Expression]]) -> "query":
        sel = []
        for item in items:
            if isinstance(item, str):
                sel.append(OutputAttribute(Variable(attribute=item)))
            else:
                name, expr = item
                sel.append(OutputAttribute(expr, rename=name))
        self._q.selector.selection = sel
        return self

    def group_by(self, *attrs: str) -> "query":
        self._q.selector.group_by = [Variable(attribute=a) for a in attrs]
        return self

    def having(self, condition: Expression) -> "query":
        self._q.selector.having = condition
        return self

    def insert_into(self, target: str, event_type: str = "current") -> "query":
        self._q.output_stream = InsertIntoStream(target, event_type)
        return self

    # Java-style aliases
    insertInto = insert_into
    groupBy = group_by

    def build(self) -> Query:
        return self._q


# -- app ---------------------------------------------------------------------


class siddhi_app:
    """``SiddhiApp.siddhiApp(name)`` analog."""

    def __init__(self, name: Optional[str] = None):
        self._app = SiddhiApp()
        if name:
            self._app.annotations.append(Annotation("app:name", [(None, name)]))

    def define_stream(self, d: Union[stream, StreamDefinition]) -> "siddhi_app":
        self._app.define_stream(d.build() if isinstance(d, stream) else d)
        return self

    def define_table(self, d: Union[table, TableDefinition]) -> "siddhi_app":
        self._app.define_table(d.build() if isinstance(d, table) else d)
        return self

    def add_query(self, q: Union[query, Query]) -> "siddhi_app":
        self._app.add_query(q.build() if isinstance(q, query) else q)
        return self

    # Java-style aliases
    defineStream = define_stream
    defineTable = define_table
    addQuery = add_query

    def build(self) -> SiddhiApp:
        return self._app
