"""SiddhiCompiler: public compile entry points.

Mirrors ``io.siddhi.query.compiler.SiddhiCompiler`` (SiddhiCompiler.java:63
``parse``, :193 ``parseOnDemandQuery``, :233 ``updateVariables``).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

from siddhi_tpu_torch.compiler.parser import Parser, SiddhiParserError
from siddhi_tpu_torch.compiler.tokenizer import TokenizeError, tokenize
from siddhi_tpu_torch.query_api import (
    OnDemandQuery,
    Query,
    SiddhiApp,
    StreamDefinition,
    TableDefinition,
    AggregationDefinition,
    Partition,
)

_VAR_PATTERN = re.compile(r"\$\{(\w+)\}")


def _tokenize(src: str):
    """Tokenize, normalizing lexer failures to SiddhiParserError so every
    compile entry point has one error contract."""
    try:
        return tokenize(src)
    except TokenizeError as e:
        raise SiddhiParserError(str(e)) from e


class SiddhiCompiler:
    @staticmethod
    def update_variables(app_str: str, env: Optional[Dict[str, str]] = None) -> str:
        """Substitute ``${var}`` with environment/system values pre-parse
        (reference: SiddhiCompiler.updateVariables:233)."""

        def repl(m: re.Match) -> str:
            name = m.group(1)
            if env and name in env:
                return env[name]
            if name in os.environ:
                return os.environ[name]
            raise SiddhiParserError(f"no system or environment variable found for '${{{name}}}'")

        return _VAR_PATTERN.sub(repl, app_str)

    @staticmethod
    def parse(app_str: str) -> SiddhiApp:
        return Parser(_tokenize(app_str)).parse_app()

    @staticmethod
    def parse_query(query_str: str) -> Query:
        p = Parser(_tokenize(query_str))
        anns = p.parse_annotations()
        return p.parse_query(anns)

    @staticmethod
    def parse_stream_definition(s: str) -> StreamDefinition:
        app = SiddhiCompiler.parse(s)
        return next(iter(app.stream_definitions.values()))

    @staticmethod
    def parse_table_definition(s: str) -> TableDefinition:
        app = SiddhiCompiler.parse(s)
        return next(iter(app.table_definitions.values()))

    @staticmethod
    def parse_partition(s: str) -> Partition:
        p = Parser(_tokenize(s))
        anns = p.parse_annotations()
        return p.parse_partition(anns)

    @staticmethod
    def parse_aggregation_definition(s: str) -> AggregationDefinition:
        app = SiddhiCompiler.parse(s)
        return next(iter(app.aggregation_definitions.values()))

    @staticmethod
    def parse_on_demand_query(s: str) -> OnDemandQuery:
        p = Parser(_tokenize(s))
        return p.parse_on_demand_query()

    # alias matching the deprecated reference API name
    parse_store_query = parse_on_demand_query
