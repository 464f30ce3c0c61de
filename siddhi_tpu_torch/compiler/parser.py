"""Recursive-descent SiddhiQL parser: tokens -> query_api AST.

Covers the reference grammar's rule set (SiddhiQL.g4): definitions
(stream/table/window/trigger/function/aggregation), annotations, queries
(standard/join/pattern/sequence inputs), selection/group-by/having/
order-by/limit/offset, output rate limiting, query outputs (insert/
delete/update/update-or-insert/return), partitions, and on-demand (store)
queries.  Expression precedence mirrors the ANTLR alternative order:
NOT > */% > +- > relational > equality > IN > AND > OR.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from siddhi_tpu_torch.compiler import tokenizer as T
from siddhi_tpu_torch.compiler.tokenizer import Token, tokenize
from siddhi_tpu_torch.query_api import (
    Annotation,
    Attribute,
    AttrType,
    SiddhiApp,
    # expressions
    Expression,
    Constant,
    TimeConstant,
    Variable,
    FunctionCall,
    ArithmeticOp,
    CompareOp,
    AndOp,
    OrOp,
    NotOp,
    InOp,
    IsNull,
    # definitions
    StreamDefinition,
    TableDefinition,
    WindowDefinition,
    TriggerDefinition,
    FunctionDefinition,
    AggregationDefinition,
    # execution
    Query,
    Selector,
    OutputAttribute,
    OrderByAttribute,
    SingleInputStream,
    JoinInputStream,
    StateInputStream,
    Filter,
    StreamFunction,
    WindowHandler,
    StreamStateElement,
    AbsentStreamStateElement,
    CountStateElement,
    LogicalStateElement,
    NextStateElement,
    EveryStateElement,
    InsertIntoStream,
    ReturnStream,
    DeleteStream,
    UpdateStream,
    UpdateOrInsertStream,
    SetAttribute,
    EventOutputRate,
    TimeOutputRate,
    SnapshotOutputRate,
    Partition,
    ValuePartitionType,
    RangePartitionType,
    OnDemandQuery,
)

ATTR_TYPES = {
    "string": AttrType.STRING,
    "int": AttrType.INT,
    "long": AttrType.LONG,
    "float": AttrType.FLOAT,
    "double": AttrType.DOUBLE,
    "bool": AttrType.BOOL,
    "object": AttrType.OBJECT,
}


class SiddhiParserError(Exception):
    def __init__(self, msg: str, tok: Optional[Token] = None):
        if tok is not None:
            msg = f"{msg} (at line {tok.line}:{tok.col}, near {tok.text!r})"
        super().__init__(msg)


# Keywords that may double as identifiers (grammar rule `name : id|keyword`).
# Structural keywords that would make parsing ambiguous are excluded.
SAFE_NAME_KWS = (
    T.KEYWORDS | set(T.TIME_UNITS)
) - {
    "select", "insert", "delete", "update", "return", "from", "define",
    "partition", "begin", "end", "join", "on", "within", "per", "output",
    "group", "having", "order", "limit", "offset", "not", "and", "or", "in",
    "is", "as", "for", "every", "unidirectional", "aggregate", "set", "into",
}


class Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.pos = 0

    # -- token helpers ------------------------------------------------------

    def peek(self, off: int = 0) -> Token:
        i = min(self.pos + off, len(self.toks) - 1)
        return self.toks[i]

    def at(self, kind: str, text: Optional[str] = None, off: int = 0) -> bool:
        t = self.peek(off)
        return t.kind == kind and (text is None or t.text == text)

    def at_kw(self, *words: str, off: int = 0) -> bool:
        t = self.peek(off)
        return t.kind == T.KW and t.text in words

    def at_sym(self, *syms: str, off: int = 0) -> bool:
        t = self.peek(off)
        return t.kind == T.SYM and t.text in syms

    def next(self) -> Token:
        t = self.toks[self.pos]
        if t.kind != T.EOF:
            self.pos += 1
        return t

    def accept_kw(self, *words: str) -> Optional[Token]:
        if self.at_kw(*words):
            return self.next()
        return None

    def accept_sym(self, *syms: str) -> Optional[Token]:
        if self.at_sym(*syms):
            return self.next()
        return None

    def expect_kw(self, word: str) -> Token:
        if not self.at_kw(word):
            raise SiddhiParserError(f"expected '{word}'", self.peek())
        return self.next()

    def expect_sym(self, sym: str) -> Token:
        if not self.at_sym(sym):
            raise SiddhiParserError(f"expected '{sym}'", self.peek())
        return self.next()

    def expect_name(self, allow_keywords: bool = False) -> str:
        t = self.peek()
        if t.kind == T.ID:
            return self.next().text
        if t.kind == T.KW and (allow_keywords or t.text in SAFE_NAME_KWS):
            return str(self.next().value)  # original-case text
        raise SiddhiParserError("expected identifier", t)

    # -- entry points -------------------------------------------------------

    def parse_app(self) -> SiddhiApp:
        app = SiddhiApp()
        # leading @app:... annotations (plain @annotations belong to the next
        # definition/query and are handled inside those parsers)
        while self.at_sym("@") and self.at_kw("app", off=1) and self.at_sym(":", off=2):
            app.annotations.append(self.parse_app_annotation())
        while not self.at(T.EOF):
            if self.accept_sym(";"):
                continue
            if self.at_sym("@") and self.at_kw("app", off=1) and self.at_sym(":", off=2):
                app.annotations.append(self.parse_app_annotation())
                continue
            annotations = self.parse_annotations()
            if self.at_kw("define"):
                self.parse_definition(app, annotations)
            elif self.at_kw("partition"):
                app.add_partition(self.parse_partition(annotations))
            elif self.at_kw("from"):
                app.add_query(self.parse_query(annotations))
            else:
                raise SiddhiParserError(
                    "expected 'define', 'from', 'partition' or annotation", self.peek()
                )
        if not any(
            (
                app.stream_definitions, app.table_definitions, app.window_definitions,
                app.trigger_definitions, app.function_definitions,
                app.aggregation_definitions, app.execution_elements,
            )
        ):
            raise SiddhiParserError("empty siddhi app: no definitions found")
        return app

    # -- annotations --------------------------------------------------------

    def parse_app_annotation(self) -> Annotation:
        self.expect_sym("@")
        self.expect_kw("app")
        self.expect_sym(":")
        name = self.expect_name(allow_keywords=True)
        ann = Annotation(name="app:" + name)
        if self.accept_sym("("):
            self._parse_annotation_body(ann)
        return ann

    def parse_annotations(self) -> List[Annotation]:
        anns = []
        while self.at_sym("@") and not (self.at_kw("app", off=1) and self.at_sym(":", off=2)):
            anns.append(self.parse_annotation())
        return anns

    def parse_annotation(self) -> Annotation:
        self.expect_sym("@")
        name = self.expect_name(allow_keywords=True)
        ann = Annotation(name=name)
        if self.accept_sym("("):
            self._parse_annotation_body(ann)
        return ann

    def _parse_annotation_body(self, ann: Annotation):
        if self.accept_sym(")"):
            return
        while True:
            if self.at_sym("@"):
                ann.annotations.append(self.parse_annotation())
            else:
                key, value = self._parse_annotation_element()
                ann.elements.append((key, value))
            if self.accept_sym(","):
                continue
            self.expect_sym(")")
            return

    def _parse_annotation_element(self) -> Tuple[Optional[str], str]:
        # (property_name '=')? property_value ; property_name may be dotted
        # (`buffer.size`), dashed, or colon-separated; value is a string
        # literal (we also leniently accept bare numbers/ids/bools).
        start = self.pos
        if self.at(T.ID) or self.at(T.KW):
            key = self.expect_name(allow_keywords=True)
            while self.at_sym(".", "-", ":") and (self.at(T.ID, off=1) or self.at(T.KW, off=1)):
                sep = self.next().text
                key += sep + self.expect_name(allow_keywords=True)
            if self.accept_sym("="):
                return key, self._parse_annotation_value()
            # not a key=value pair; rewind and treat as bare value
            self.pos = start
        return None, self._parse_annotation_value()

    def _parse_annotation_value(self) -> str:
        t = self.peek()
        if t.kind == T.STRING:
            return str(self.next().value)
        if t.kind in (T.INT, T.LONG, T.FLOAT, T.DOUBLE):
            return self.next().text
        if t.kind in (T.ID, T.KW):
            return self.expect_name(allow_keywords=True)
        raise SiddhiParserError("expected annotation value", t)

    # -- definitions --------------------------------------------------------

    def parse_definition(self, app: SiddhiApp, annotations: List[Annotation]):
        self.expect_kw("define")
        if self.accept_kw("stream"):
            app.define_stream(self._finish_stream_def(StreamDefinition, annotations))
        elif self.accept_kw("table"):
            app.define_table(self._finish_stream_def(TableDefinition, annotations))
        elif self.accept_kw("window"):
            app.define_window(self._parse_window_def(annotations))
        elif self.accept_kw("trigger"):
            app.define_trigger(self._parse_trigger_def(annotations))
        elif self.accept_kw("function"):
            app.define_function(self._parse_function_def(annotations))
        elif self.accept_kw("aggregation"):
            app.define_aggregation(self._parse_aggregation_def(annotations))
        else:
            raise SiddhiParserError("unknown definition kind", self.peek())

    def _parse_source_name(self) -> Tuple[str, bool, bool]:
        inner = fault = False
        if self.accept_sym("#"):
            inner = True
        elif self.accept_sym("!"):
            fault = True
        return self.expect_name(), inner, fault

    def _parse_attr_list(self) -> List[Attribute]:
        self.expect_sym("(")
        attrs = []
        while True:
            name = self.expect_name()
            t = self.peek()
            if t.kind != T.KW or t.text not in ATTR_TYPES:
                raise SiddhiParserError("expected attribute type", t)
            self.next()
            attrs.append(Attribute(name, ATTR_TYPES[t.text]))
            if self.accept_sym(","):
                continue
            self.expect_sym(")")
            return attrs

    def _finish_stream_def(self, cls, annotations):
        name = self.expect_name()
        return cls(id=name, attributes=self._parse_attr_list(), annotations=annotations)

    def _parse_window_def(self, annotations) -> WindowDefinition:
        name = self.expect_name()
        attrs = self._parse_attr_list()
        fn = self._parse_function_operation()
        # reference default: ALL events (WindowDefinition.java:40) so
        # queries reading the window see expiries and can retract
        out_type = "all"
        if self.accept_kw("output"):
            out_type = self._parse_output_event_type()
        return WindowDefinition(
            id=name,
            attributes=attrs,
            annotations=annotations,
            window_function=fn,
            output_event_type=out_type,
        )

    def _parse_output_event_type(self) -> str:
        if self.accept_kw("all"):
            self.expect_kw("events")
            return "all"
        if self.accept_kw("expired"):
            self.expect_kw("events")
            return "expired"
        self.accept_kw("current")
        self.expect_kw("events")
        return "current"

    def _parse_trigger_def(self, annotations) -> TriggerDefinition:
        name = self.expect_name()
        self.expect_kw("at")
        if self.accept_kw("every"):
            ms = self._parse_time_value()
            return TriggerDefinition(id=name, annotations=annotations, at_every_ms=ms)
        t = self.peek()
        if t.kind != T.STRING:
            raise SiddhiParserError("expected time value or string after 'at'", t)
        self.next()
        val = str(t.value)
        if val.lower() == "start":
            return TriggerDefinition(id=name, annotations=annotations, at_start=True)
        return TriggerDefinition(id=name, annotations=annotations, at_cron=val)

    def _parse_function_def(self, annotations) -> FunctionDefinition:
        name = self.expect_name()
        self.expect_sym("[")
        lang = self.expect_name(allow_keywords=True)
        self.expect_sym("]")
        self.expect_kw("return")
        t = self.peek()
        if t.kind != T.KW or t.text not in ATTR_TYPES:
            raise SiddhiParserError("expected return type", t)
        self.next()
        rt = ATTR_TYPES[t.text]
        body_tok = self.peek()
        if body_tok.kind != T.SCRIPT:
            raise SiddhiParserError("expected '{ script }' function body", body_tok)
        self.next()
        return FunctionDefinition(
            id=name, annotations=annotations, language=lang, return_type=rt, body=str(body_tok.value)
        )

    DURATIONS = ["sec", "min", "hour", "day", "week", "month", "year"]
    _DUR_CANON = {
        "sec": "seconds", "second": "seconds", "seconds": "seconds",
        "min": "minutes", "minute": "minutes", "minutes": "minutes",
        "hour": "hours", "hours": "hours",
        "day": "days", "days": "days",
        "week": "weeks", "weeks": "weeks",
        "month": "months", "months": "months",
        "year": "years", "years": "years",
    }
    _DUR_ORDER = ["seconds", "minutes", "hours", "days", "weeks", "months", "years"]

    def _parse_duration_name(self) -> str:
        t = self.peek()
        if t.kind == T.KW and t.text in self._DUR_CANON:
            self.next()
            return self._DUR_CANON[t.text]
        raise SiddhiParserError("expected aggregation duration (sec..year)", t)

    def _parse_aggregation_def(self, annotations) -> AggregationDefinition:
        name = self.expect_name()
        self.expect_kw("from")
        stream = self._parse_standard_stream()
        selector = self._parse_query_section(require_select=True)
        self.expect_kw("aggregate")
        aggregate_by = None
        if self.accept_kw("by"):
            var = self._parse_attribute_reference()
            aggregate_by = var.attribute
        self.expect_kw("every")
        first = self._parse_duration_name()
        durations = [first]
        if self.accept_sym("..."):
            last = self._parse_duration_name()
            i0, i1 = self._DUR_ORDER.index(first), self._DUR_ORDER.index(last)
            if i1 < i0:
                raise SiddhiParserError(f"invalid duration range {first}...{last}")
            durations = self._DUR_ORDER[i0 : i1 + 1]
        else:
            while self.accept_sym(","):
                durations.append(self._parse_duration_name())
        return AggregationDefinition(
            id=name,
            annotations=annotations,
            input_stream=stream,
            selector=selector,
            aggregate_by=aggregate_by,
            durations=durations,
        )

    # -- partition ----------------------------------------------------------

    def parse_partition(self, annotations) -> Partition:
        self.expect_kw("partition")
        self.expect_kw("with")
        self.expect_sym("(")
        ptypes = []
        while True:
            ptypes.append(self._parse_partition_with_stream())
            if self.accept_sym(","):
                continue
            self.expect_sym(")")
            break
        self.expect_kw("begin")
        queries = []
        while True:
            if self.accept_sym(";"):
                continue
            if self.accept_kw("end"):
                break
            anns = self.parse_annotations()
            queries.append(self.parse_query(anns))
        return Partition(partition_types=ptypes, queries=queries, annotations=annotations)

    def _parse_partition_with_stream(self):
        # `expr of Stream` (value) or `expr as 'label' or ... of Stream` (range)
        expr = self.parse_expression()
        if self.at_kw("as"):
            ranges = []
            self.expect_kw("as")
            label = self._expect_string()
            ranges.append((expr, label))
            while self.accept_kw("or"):
                cond = self.parse_expression()
                self.expect_kw("as")
                ranges.append((cond, self._expect_string()))
            self.expect_kw("of")
            stream = self.expect_name()
            return RangePartitionType(stream_id=stream, ranges=ranges)
        self.expect_kw("of")
        stream = self.expect_name()
        return ValuePartitionType(stream_id=stream, expression=expr)

    def _expect_string(self) -> str:
        t = self.peek()
        if t.kind != T.STRING:
            raise SiddhiParserError("expected string literal", t)
        self.next()
        return str(t.value)

    # -- query --------------------------------------------------------------

    def parse_query(self, annotations) -> Query:
        self.expect_kw("from")
        input_stream = self._parse_query_input()
        selector = self._parse_query_section(require_select=False)
        output_rate = self._parse_output_rate()
        output_stream = self._parse_query_output()
        return Query(
            input_stream=input_stream,
            selector=selector,
            output_stream=output_stream,
            output_rate=output_rate,
            annotations=annotations,
        )

    # ---- input classification --------------------------------------------

    _QUERY_BOUNDARY = {"select", "insert", "delete", "update", "return", "output", "group", "having", "order", "limit", "offset"}

    def _classify_input(self) -> str:
        """Look ahead from current position to classify the from-clause:
        'pattern' | 'sequence' | 'join' | 'standard'."""
        depth = 0
        i = self.pos
        toks = self.toks
        has_arrow = has_comma = has_join = has_logical = False
        has_every = has_not = has_binding = has_collect = False
        while i < len(toks):
            t = toks[i]
            if t.kind == T.SYM and t.text in "([":
                depth += 1
            elif t.kind == T.SYM and t.text in ")]":
                depth -= 1
                if depth < 0:
                    break
            elif depth > 0:
                # markers that cannot occur inside expression parentheses
                # still classify a parenthesized whole pattern, e.g.
                # `from (every e1=A -> e2=B) within 1 sec` (reference
                # WithinPatternTestCase.testQuery2's shape)
                if t.kind == T.SYM and t.text == "->":
                    has_arrow = True
                elif t.kind == T.SYM and t.text == "=":
                    has_binding = True
                elif t.kind == T.KW and t.text == "every":
                    has_every = True
            elif depth == 0:
                if t.kind == T.SYM and t.text == "->":
                    has_arrow = True
                elif t.kind == T.SYM and t.text == ",":
                    has_comma = True
                elif t.kind == T.SYM and t.text == "=":
                    # event-ref binding `e1=Stream` ('==' lexes as one token)
                    has_binding = True
                elif t.kind == T.SYM and t.text == "<":
                    # count collection `<n>`, `<n:m>`, `<n:>`, `<:m>` — only
                    # INT/':' tokens up to a closing '>' (distinguishes from a
                    # comparison like `on A.x < 5` in a join on-condition)
                    k = i + 1
                    inner_ok = False
                    while k < len(toks) and k <= i + 4:
                        tk = toks[k]
                        if tk.kind == T.SYM and tk.text == ">":
                            has_collect = has_collect or inner_ok
                            break
                        if tk.kind == T.INT or (tk.kind == T.SYM and tk.text == ":"):
                            inner_ok = True
                            k += 1
                            continue
                        break
                elif t.kind == T.SYM and t.text == ";":
                    break
                elif t.kind == T.KW:
                    prev = toks[i - 1] if i > 0 else None
                    if prev is not None and prev.kind == T.SYM and prev.text in "#!.:@":
                        pass  # name position (`#Inner`, `.length`, `@info`)
                    elif t.text in ("join", "inner", "outer", "left", "right", "full", "unidirectional"):
                        has_join = True
                    elif t.text in ("and", "or"):
                        has_logical = True
                    elif t.text == "every":
                        has_every = True
                    elif t.text == "not":
                        has_not = True
                    elif t.text in self._QUERY_BOUNDARY:
                        break
            i += 1
        # Markers that can only occur in pattern/sequence inputs take priority;
        # 'not'/'and'/'or' also occur inside a join's on-condition, so a join
        # keyword wins over those.
        if has_arrow or has_every or has_binding or has_collect:
            return "sequence" if (has_comma and not has_arrow) else "pattern"
        if has_join:
            return "join"
        if has_not or has_logical:
            return "pattern"
        if has_comma:
            return "sequence"
        return "standard"

    def _parse_query_input(self):
        kind = self._classify_input()
        if kind == "standard":
            return self._parse_standard_stream()
        if kind == "join":
            return self._parse_join_stream()
        if kind == "pattern":
            return self._parse_pattern_stream()
        return self._parse_sequence_stream()

    # ---- standard & join streams ------------------------------------------

    def _parse_stream_handlers(self) -> List:
        """filters `[expr]`, stream functions `#ns:fn(..)`, window `#window.fn(..)`."""
        handlers = []
        while True:
            if self.at_sym("["):
                self.next()
                expr = self.parse_expression()
                self.expect_sym("]")
                handlers.append(Filter(expr))
                continue
            if self.at_sym("#"):
                if self.at_kw("window", off=1) and self.at_sym(".", off=2):
                    self.next()  # '#'
                    self.next()  # 'window'
                    self.next()  # '.'
                    fn = self._parse_function_operation()
                    handlers.append(WindowHandler(fn.namespace, fn.name, fn.args))
                    continue
                # '#ns:fn(...)' or '#fn(...)'
                if self.at(T.ID, off=1) or self.at(T.KW, off=1):
                    self.next()  # '#'
                    fn = self._parse_function_operation()
                    handlers.append(StreamFunction(fn.namespace, fn.name, fn.args))
                    continue
            break
        return handlers

    def _parse_standard_stream(self) -> SingleInputStream:
        name, inner, fault = self._parse_source_name()
        handlers = self._parse_stream_handlers()
        return SingleInputStream(stream_id=name, is_inner=inner, is_fault=fault, handlers=handlers)

    def _parse_join_source(self) -> SingleInputStream:
        s = self._parse_standard_stream()
        if self.accept_kw("as"):
            s.alias = self.expect_name()
        return s

    def _parse_join_stream(self) -> JoinInputStream:
        left = self._parse_join_source()
        trigger = None
        if self.accept_kw("unidirectional"):
            trigger = "left"
        join_type = self._parse_join_kind()
        right = self._parse_join_source()
        if trigger is None and self.accept_kw("unidirectional"):
            trigger = "right"
        on_cond = None
        if self.accept_kw("on"):
            on_cond = self.parse_expression()
        within = per = None
        if self.accept_kw("within"):
            within = self.parse_expression()
            if self.accept_sym(","):
                # within start, end — keep as tuple via per slot below
                end = self.parse_expression()
                within = (within, end)
        if self.accept_kw("per"):
            per = self.parse_expression()
        return JoinInputStream(
            left=left, join_type=join_type, right=right, on_condition=on_cond,
            trigger=trigger, within=within, per=per,
        )

    def _parse_join_kind(self) -> str:
        if self.accept_kw("left"):
            self.expect_kw("outer")
            self.expect_kw("join")
            return JoinInputStream.LEFT_OUTER
        if self.accept_kw("right"):
            self.expect_kw("outer")
            self.expect_kw("join")
            return JoinInputStream.RIGHT_OUTER
        if self.accept_kw("full"):
            self.expect_kw("outer")
            self.expect_kw("join")
            return JoinInputStream.FULL_OUTER
        if self.accept_kw("outer"):
            self.expect_kw("join")
            return JoinInputStream.FULL_OUTER
        if self.accept_kw("inner"):
            self.expect_kw("join")
            return JoinInputStream.INNER_JOIN
        self.expect_kw("join")
        return JoinInputStream.JOIN

    # ---- patterns & sequences ---------------------------------------------

    def _parse_pattern_stream(self) -> StateInputStream:
        state = self._parse_pattern_chain()
        within = None
        if self.accept_kw("within"):
            within = self._parse_time_value()
        return StateInputStream(type=StateInputStream.PATTERN, state=state, within_ms=within)

    def _parse_pattern_chain(self):
        """Chain of pattern elements separated by '->'."""
        elem = self._parse_pattern_chain_element()
        while self.accept_sym("->"):
            nxt = self._parse_pattern_chain_element()
            elem = NextStateElement(element=elem, next=nxt)
        return elem

    def _parse_pattern_chain_element(self):
        if self.accept_kw("every"):
            if self.accept_sym("("):
                inner = self._parse_pattern_chain()
                self.expect_sym(")")
                return EveryStateElement(element=inner)
            return EveryStateElement(element=self._parse_pattern_source())
        if self.at_sym("("):
            self.next()
            inner = self._parse_pattern_chain()
            self.expect_sym(")")
            return inner
        return self._parse_pattern_source()

    def _parse_pattern_source(self):
        """logical / collection / absent / standard stateful source."""
        first = self._parse_stateful_source_atom()
        if self.at_kw("and", "or"):
            op = self.next().text
            second = self._parse_stateful_source_atom()
            return LogicalStateElement(element1=first, operator=op, element2=second)
        return first

    def _parse_stateful_source_atom(self):
        if self.accept_kw("not"):
            stream = self._parse_basic_source()
            wait = None
            if self.accept_kw("for"):
                wait = self._parse_time_value()
            return AbsentStreamStateElement(stream=stream, waiting_time_ms=wait)
        sse = self._parse_standard_stateful_source()
        # pattern count collection <min:max>
        if self.at_sym("<"):
            save = self.pos
            self.next()
            ok, mn, mx = self._try_parse_collect()
            if ok:
                return CountStateElement(stream_state=sse, min_count=mn, max_count=mx)
            self.pos = save
        return sse

    def _try_parse_collect(self):
        ANY = CountStateElement.ANY
        mn = mx = None
        if self.at(T.INT):
            mn = int(self.next().value)
            if self.accept_sym(":"):
                if self.at(T.INT):
                    mx = int(self.next().value)
                else:
                    mx = ANY
            else:
                mx = mn
        elif self.at_sym(":"):
            self.next()
            if not self.at(T.INT):
                return False, 0, 0
            mn = 0
            mx = int(self.next().value)
        else:
            return False, 0, 0
        if not self.at_sym(">"):
            return False, 0, 0
        self.next()
        return True, mn, mx

    def _parse_standard_stateful_source(self) -> StreamStateElement:
        event_ref = None
        if (self.at(T.ID) and self.at_sym("=", off=1)) and not self.at_sym("==", off=1):
            event_ref = self.next().text
            self.next()  # '='
        stream = self._parse_basic_source()
        return StreamStateElement(stream=stream, event_ref=event_ref)

    def _parse_basic_source(self) -> SingleInputStream:
        name, inner, fault = self._parse_source_name()
        handlers = []
        while True:
            if self.at_sym("["):
                self.next()
                expr = self.parse_expression()
                self.expect_sym("]")
                handlers.append(Filter(expr))
                continue
            if self.at_sym("#") and (self.at(T.ID, off=1) or self.at(T.KW, off=1)) and not (
                self.at_kw("window", off=1) and self.at_sym(".", off=2)
            ):
                self.next()
                fn = self._parse_function_operation()
                handlers.append(StreamFunction(fn.namespace, fn.name, fn.args))
                continue
            break
        return SingleInputStream(stream_id=name, is_inner=inner, is_fault=fault, handlers=handlers)

    def _parse_sequence_stream(self) -> StateInputStream:
        every_first = bool(self.accept_kw("every"))
        first = self._parse_sequence_source()
        if every_first:
            first = EveryStateElement(element=first)
        elems = [first]
        while self.accept_sym(","):
            elems.append(self._parse_sequence_source())
        # right-nested Next chain; associativity does not matter for lowering
        state = elems[-1]
        for e in reversed(elems[:-1]):
            state = NextStateElement(element=e, next=state)
        within = None
        if self.accept_kw("within"):
            within = self._parse_time_value()
        return StateInputStream(type=StateInputStream.SEQUENCE, state=state, within_ms=within)

    def _parse_sequence_source(self):
        if self.at_sym("("):
            self.next()
            inner = self._parse_sequence_chain_parenthesized()
            self.expect_sym(")")
            return inner
        first = self._parse_sequence_atom()
        if self.at_kw("and", "or"):
            op = self.next().text
            second = self._parse_sequence_atom()
            return LogicalStateElement(element1=first, operator=op, element2=second)
        return first

    def _parse_sequence_chain_parenthesized(self):
        elems = [self._parse_sequence_source()]
        while self.accept_sym(","):
            elems.append(self._parse_sequence_source())
        state = elems[-1]
        for e in reversed(elems[:-1]):
            state = NextStateElement(element=e, next=state)
        return state

    def _parse_sequence_atom(self):
        if self.accept_kw("not"):
            stream = self._parse_basic_source()
            wait = None
            if self.accept_kw("for"):
                wait = self._parse_time_value()
            return AbsentStreamStateElement(stream=stream, waiting_time_ms=wait)
        sse = self._parse_standard_stateful_source()
        ANY = CountStateElement.ANY
        if self.at_sym("*"):
            self.next()
            return CountStateElement(stream_state=sse, min_count=0, max_count=ANY)
        if self.at_sym("+"):
            self.next()
            return CountStateElement(stream_state=sse, min_count=1, max_count=ANY)
        if self.at_sym("?"):
            self.next()
            return CountStateElement(stream_state=sse, min_count=0, max_count=1)
        if self.at_sym("<"):
            save = self.pos
            self.next()
            ok, mn, mx = self._try_parse_collect()
            if ok:
                return CountStateElement(stream_state=sse, min_count=mn, max_count=mx)
            self.pos = save
        return sse

    # ---- selection section -------------------------------------------------

    def _parse_query_section(self, require_select: bool) -> Selector:
        sel = Selector()
        if self.accept_kw("select"):
            if self.accept_sym("*"):
                sel.selection = None
            else:
                items = [self._parse_output_attribute()]
                while self.accept_sym(","):
                    items.append(self._parse_output_attribute())
                sel.selection = items
        elif require_select:
            raise SiddhiParserError("expected 'select'", self.peek())
        else:
            # no select clause == select *
            sel.selection = None
        if self.accept_kw("group"):
            self.expect_kw("by")
            sel.group_by = [self._parse_attribute_reference()]
            while self.accept_sym(","):
                sel.group_by.append(self._parse_attribute_reference())
        if self.accept_kw("having"):
            sel.having = self.parse_expression()
        if self.accept_kw("order"):
            self.expect_kw("by")
            sel.order_by = [self._parse_order_by_ref()]
            while self.accept_sym(","):
                sel.order_by.append(self._parse_order_by_ref())
        if self.accept_kw("limit"):
            sel.limit = self.parse_expression()
        if self.accept_kw("offset"):
            sel.offset = self.parse_expression()
        return sel

    def _parse_order_by_ref(self) -> OrderByAttribute:
        var = self._parse_attribute_reference()
        asc = True
        if self.accept_kw("desc"):
            asc = False
        elif self.accept_kw("asc"):
            asc = True
        return OrderByAttribute(variable=var, ascending=asc)

    def _parse_output_attribute(self) -> OutputAttribute:
        expr = self.parse_expression()
        rename = None
        if self.accept_kw("as"):
            rename = self.expect_name()
        return OutputAttribute(expression=expr, rename=rename)

    # ---- output rate -------------------------------------------------------

    def _parse_output_rate(self):
        if not self.at_kw("output"):
            return None
        # distinguish `output every ...` / `output snapshot every` / `output
        # first every` from query outputs — 'output' only begins a rate here.
        self.next()
        if self.accept_kw("snapshot"):
            self.expect_kw("every")
            return SnapshotOutputRate(value_ms=self._parse_time_value())
        rtype = "all"
        if self.accept_kw("all"):
            rtype = "all"
        elif self.accept_kw("first"):
            rtype = "first"
        elif self.accept_kw("last"):
            rtype = "last"
        self.expect_kw("every")
        if self.at(T.INT) and self.at_kw("events", off=1):
            n = int(self.next().value)
            self.next()
            return EventOutputRate(events=n, type=rtype)
        return TimeOutputRate(value_ms=self._parse_time_value(), type=rtype)

    # ---- query output ------------------------------------------------------

    def _parse_query_output(self):
        if self.accept_kw("insert"):
            event_type = "current"
            if self.at_kw("all", "expired", "current"):
                event_type = self._parse_output_event_type()
            self.expect_kw("into")
            name, inner, fault = self._parse_source_name()
            return InsertIntoStream(target=name, event_type=event_type, is_inner=inner, is_fault=fault)
        if self.accept_kw("delete"):
            name, _, _ = self._parse_source_name()
            event_type = "current"
            if self.accept_kw("for"):
                event_type = self._parse_output_event_type()
            on = None
            if self.accept_kw("on"):
                on = self.parse_expression()
            return DeleteStream(target=name, event_type=event_type, on_condition=on)
        if self.accept_kw("update"):
            if self.accept_kw("or"):
                self.expect_kw("insert")
                self.expect_kw("into")
                name, _, _ = self._parse_source_name()
                event_type = "current"
                if self.accept_kw("for"):
                    event_type = self._parse_output_event_type()
                set_clause = self._parse_set_clause()
                self.expect_kw("on")
                on = self.parse_expression()
                return UpdateOrInsertStream(
                    target=name, event_type=event_type, set_clause=set_clause, on_condition=on
                )
            name, _, _ = self._parse_source_name()
            event_type = "current"
            if self.accept_kw("for"):
                event_type = self._parse_output_event_type()
            set_clause = self._parse_set_clause()
            self.expect_kw("on")
            on = self.parse_expression()
            return UpdateStream(target=name, event_type=event_type, set_clause=set_clause, on_condition=on)
        if self.accept_kw("return"):
            event_type = "current"
            if self.at_kw("all", "expired", "current"):
                event_type = self._parse_output_event_type()
            return ReturnStream(event_type=event_type)
        raise SiddhiParserError(
            "expected 'insert'/'delete'/'update'/'return' query output", self.peek()
        )

    def _parse_set_clause(self):
        if not self.accept_kw("set"):
            return None
        items = []
        while True:
            var = self._parse_attribute_reference()
            self.expect_sym("=")
            expr = self.parse_expression()
            items.append(SetAttribute(variable=var, expression=expr))
            if self.accept_sym(","):
                continue
            return items

    # -- on-demand (store) queries ------------------------------------------

    def parse_on_demand_query(self) -> OnDemandQuery:
        if self.at_kw("from"):
            self.next()
            store = self.expect_name()
            alias = None
            if self.accept_kw("as"):
                alias = self.expect_name()
            on = None
            if self.accept_kw("on"):
                on = self.parse_expression()
            within = per = None
            if self.accept_kw("within"):
                start = self.parse_expression()
                end = None
                if self.accept_sym(","):
                    end = self.parse_expression()
                within = (start, end)
            if self.accept_kw("per"):
                per = self.parse_expression()
            selector = self._parse_query_section(require_select=False)
            out = None
            qtype = "find"
            if self.at_kw("delete"):
                out = self._parse_query_output()
                qtype = "delete"
            elif self.at_kw("update"):
                out = self._parse_query_output()
                qtype = "update_or_insert" if isinstance(out, UpdateOrInsertStream) else "update"
            return OnDemandQuery(
                type=qtype, input_store=store, input_alias=alias, on_condition=on,
                within=within, per=per, selector=selector, output_stream=out,
            )
        # `select ... insert into T` / `select ... update ...` forms
        selector = self._parse_query_section(require_select=True)
        out = self._parse_query_output()
        if isinstance(out, InsertIntoStream):
            qtype = "insert"
        elif isinstance(out, DeleteStream):
            qtype = "delete"
        elif isinstance(out, UpdateOrInsertStream):
            qtype = "update_or_insert"
        else:
            qtype = "update"
        return OnDemandQuery(type=qtype, selector=selector, output_stream=out)

    # -- expressions ---------------------------------------------------------

    def parse_expression(self) -> Expression:
        return self._parse_or()

    def _parse_or(self) -> Expression:
        left = self._parse_and()
        while self.at_kw("or"):
            self.next()
            left = OrOp(left, self._parse_and())
        return left

    def _parse_and(self) -> Expression:
        left = self._parse_in()
        while self.at_kw("and"):
            self.next()
            left = AndOp(left, self._parse_in())
        return left

    def _parse_in(self) -> Expression:
        left = self._parse_equality()
        while self.at_kw("in"):
            self.next()
            left = InOp(left, self.expect_name())
        return left

    def _parse_equality(self) -> Expression:
        left = self._parse_relational()
        while self.at_sym("==", "!="):
            op = self.next().text
            left = CompareOp(op, left, self._parse_relational())
        return left

    def _parse_relational(self) -> Expression:
        left = self._parse_additive()
        while self.at_sym("<", "<=", ">", ">="):
            op = self.next().text
            left = CompareOp(op, left, self._parse_additive())
        return left

    def _parse_additive(self) -> Expression:
        left = self._parse_multiplicative()
        while self.at_sym("+", "-"):
            op = self.next().text
            left = ArithmeticOp(op, left, self._parse_multiplicative())
        return left

    def _parse_multiplicative(self) -> Expression:
        left = self._parse_unary()
        while self.at_sym("*", "/", "%"):
            op = self.next().text
            left = ArithmeticOp(op, left, self._parse_unary())
        return left

    def _parse_unary(self) -> Expression:
        if self.at_kw("not"):
            self.next()
            return NotOp(self._parse_unary())
        if self.at_sym("-", "+"):
            sign = self.next().text
            expr = self._parse_unary()
            if sign == "-":
                if isinstance(expr, Constant) and expr.type.is_numeric:
                    return Constant(-expr.value, expr.type)
                return ArithmeticOp("-", Constant(0, AttrType.INT), expr)
            return expr
        return self._parse_postfix()

    def _parse_postfix(self) -> Expression:
        expr = self._parse_primary()
        # null check: `<primary> is null`
        if self.at_kw("is") and self.at_kw("null", off=1):
            self.next()
            self.next()
            return IsNull(expr)
        return expr

    def _parse_primary(self) -> Expression:
        t = self.peek()
        if self.at_sym("("):
            self.next()
            expr = self.parse_expression()
            self.expect_sym(")")
            return expr
        # literals
        if t.kind == T.STRING:
            self.next()
            return Constant(str(t.value), AttrType.STRING)
        if t.kind in (T.INT, T.LONG, T.FLOAT, T.DOUBLE):
            return self._parse_numeric_or_time()
        if t.kind == T.KW:
            if t.text == "true":
                self.next()
                return Constant(True, AttrType.BOOL)
            if t.text == "false":
                self.next()
                return Constant(False, AttrType.BOOL)
            if t.text == "null":
                self.next()
                return Constant(None, AttrType.OBJECT)
        # attribute reference or function call (possibly '#'/'!' prefixed)
        if self.at_sym("#", "!") or t.kind == T.ID or t.kind == T.KW:
            return self._parse_ref_or_call()
        raise SiddhiParserError("expected expression", t)

    def _parse_numeric_or_time(self) -> Expression:
        t = self.peek()
        # time constant: INT followed by a time unit keyword
        if t.kind == T.INT and self.peek(1).kind == T.KW and self.peek(1).text in T.TIME_UNITS:
            return TimeConstant(self._parse_time_value())
        self.next()
        if t.kind == T.INT:
            v = int(t.value)
            # un-suffixed literals beyond int32 widen to LONG (Java would
            # reject them outright; widening keeps 64-bit ids writable
            # without the 'L' suffix)
            if -(2**31) <= v < 2**31:
                return Constant(v, AttrType.INT)
            return Constant(v, AttrType.LONG)
        if t.kind == T.LONG:
            return Constant(int(t.value), AttrType.LONG)
        if t.kind == T.FLOAT:
            return Constant(float(t.value), AttrType.FLOAT)
        return Constant(float(t.value), AttrType.DOUBLE)

    def _parse_time_value(self) -> int:
        """`1 hour 30 min` -> milliseconds."""
        total = 0
        matched = False
        while self.at(T.INT) and self.peek(1).kind == T.KW and self.peek(1).text in T.TIME_UNITS:
            n = int(self.next().value)
            unit = self.next().text
            total += n * T.TIME_UNITS[unit]
            matched = True
        if not matched:
            raise SiddhiParserError("expected time value", self.peek())
        return total

    def _parse_function_operation(self) -> FunctionCall:
        ns = None
        name = self.expect_name(allow_keywords=True)
        if self.accept_sym(":"):
            ns = name
            name = self.expect_name(allow_keywords=True)
        self.expect_sym("(")
        args: List[Expression] = []
        star = False
        if self.accept_sym(")"):
            return FunctionCall(namespace=ns, name=name, args=tuple(args))
        if self.at_sym("*") and self.at_sym(")", off=1):
            self.next()
            star = True
        else:
            args.append(self.parse_expression())
            while self.accept_sym(","):
                args.append(self.parse_expression())
        self.expect_sym(")")
        return FunctionCall(namespace=ns, name=name, args=tuple(args), star=star)

    def _parse_ref_or_call(self) -> Expression:
        inner = fault = False
        if self.accept_sym("#"):
            inner = True
        elif self.accept_sym("!"):
            fault = True
        t = self.peek()
        if t.kind not in (T.ID, T.KW):
            raise SiddhiParserError("expected identifier", t)
        # function call? name '(' or ns ':' name '('
        if not inner and not fault:
            if self.at_sym("(", off=1):
                return self._parse_function_operation()
            if self.at_sym(":", off=1) and (self.at(T.ID, off=2) or self.at(T.KW, off=2)) and self.at_sym("(", off=3):
                return self._parse_function_operation()
        return self._parse_attribute_reference(inner=inner, fault=fault)

    def _parse_attribute_reference(self, inner: bool = False, fault: bool = False) -> Variable:
        """`attr` | `Stream.attr` | `e[1].attr` | `e[last].attr` |
        `e[last-1].attr` | `#inner.attr` | `name1#name2.attr`."""
        if not inner and not fault:
            if self.accept_sym("#"):
                inner = True
            elif self.accept_sym("!"):
                fault = True
        name1 = self.expect_name(allow_keywords=False)
        idx: Optional[int] = None
        fn_id: Optional[str] = None
        if self.at_sym("["):
            idx = self._parse_attribute_index()
        if self.accept_sym("#"):
            fn_id = self.expect_name()
            if self.at_sym("["):
                self._parse_attribute_index()  # second index (rare) — ignored
        if self.accept_sym("."):
            attr = self.expect_name()
            return Variable(
                attribute=attr, stream_id=name1, stream_index=idx,
                is_inner=inner, is_fault=fault, function_id=fn_id,
            )
        if idx is not None or fn_id is not None:
            # `e1[1] is null` — a stream-slot null check, not an attribute ref
            # (reference grammar null_check over stream_reference)
            if self.at_kw("is") and self.at_kw("null", off=1):
                from siddhi_tpu_torch.query_api import IsNullStream

                self.next()
                self.next()
                return IsNullStream(
                    stream_id=name1, stream_index=idx, is_inner=inner, is_fault=fault
                )
            raise SiddhiParserError("expected '.attribute' after indexed reference", self.peek())
        return Variable(attribute=name1, is_inner=inner, is_fault=fault)

    def _parse_attribute_index(self) -> int:
        self.expect_sym("[")
        if self.accept_kw("last"):
            k = 0
            if self.accept_sym("-"):
                t = self.peek()
                if t.kind != T.INT:
                    raise SiddhiParserError("expected integer after 'last -'", t)
                self.next()
                k = int(t.value)
            self.expect_sym("]")
            return -(k + 1)  # last == -1, last-1 == -2
        t = self.peek()
        if t.kind != T.INT:
            raise SiddhiParserError("expected index", t)
        self.next()
        self.expect_sym("]")
        return int(t.value)


def parse_time_string(s: str) -> int:
    """Annotation time value ('10 sec', '1 hour 30 min') -> milliseconds.
    The whole string must be consumed — partial matches ('1.5 min') are
    errors, not silent misparses."""
    import re

    from siddhi_tpu_torch.compiler.tokenizer import TIME_UNITS

    pattern = re.compile(r"\s*(\d+)\s*([a-zA-Z]+)")
    total = 0
    pos = 0
    matched = False
    while m := pattern.match(s, pos):
        ms = TIME_UNITS.get(m.group(2).lower())
        if ms is None:
            raise SiddhiParserError(f"unknown time unit '{m.group(2)}' in '{s}'")
        total += int(m.group(1)) * ms
        pos = m.end()
        matched = True
    if not matched or s[pos:].strip():
        raise SiddhiParserError(f"expected a time value, got '{s}'")
    return total
