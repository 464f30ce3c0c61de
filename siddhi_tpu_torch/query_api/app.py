"""SiddhiApp: top-level container of definitions + execution elements.

Mirrors ``io.siddhi.query.api.SiddhiApp`` (SiddhiApp.java:1-375) including
the duplicate-definition checks, but as a plain dataclass the planner
consumes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Union

from siddhi_tpu_torch.query_api.annotation import Annotation
from siddhi_tpu_torch.query_api.definition import (
    AggregationDefinition,
    FunctionDefinition,
    StreamDefinition,
    TableDefinition,
    TriggerDefinition,
    WindowDefinition,
)
from siddhi_tpu_torch.query_api.execution import Partition, Query


from siddhi_tpu_torch.core.exceptions import SiddhiAppValidationError


class DuplicateDefinitionError(SiddhiAppValidationError):
    """reference: DuplicateDefinitionException extends
    SiddhiAppValidationException (extends SiddhiAppCreationException) —
    so callers catching creation errors see duplicates too."""


@dataclass
class SiddhiApp:
    annotations: List[Annotation] = field(default_factory=list)
    stream_definitions: Dict[str, StreamDefinition] = field(default_factory=dict)
    table_definitions: Dict[str, TableDefinition] = field(default_factory=dict)
    window_definitions: Dict[str, WindowDefinition] = field(default_factory=dict)
    trigger_definitions: Dict[str, TriggerDefinition] = field(default_factory=dict)
    function_definitions: Dict[str, FunctionDefinition] = field(default_factory=dict)
    aggregation_definitions: Dict[str, AggregationDefinition] = field(default_factory=dict)
    execution_elements: List[Union[Query, Partition]] = field(default_factory=list)

    def _check_unique(self, id: str):
        for group in (
            self.stream_definitions,
            self.table_definitions,
            self.window_definitions,
            self.trigger_definitions,
            self.aggregation_definitions,
        ):
            if id in group:
                raise DuplicateDefinitionError(f"'{id}' is already defined")

    def define_stream(self, d: StreamDefinition) -> "SiddhiApp":
        # Re-defining an identical stream is legal in the reference; schema
        # mismatch is an error.
        if d.id in self.stream_definitions:
            old = self.stream_definitions[d.id]
            if old.attributes != d.attributes:
                raise DuplicateDefinitionError(
                    f"stream '{d.id}' re-defined with a different schema"
                )
            return self
        self._check_unique(d.id)
        self.stream_definitions[d.id] = d
        return self

    def define_table(self, d: TableDefinition) -> "SiddhiApp":
        self._check_unique(d.id)
        self.table_definitions[d.id] = d
        return self

    def define_window(self, d: WindowDefinition) -> "SiddhiApp":
        self._check_unique(d.id)
        self.window_definitions[d.id] = d
        return self

    def define_trigger(self, d: TriggerDefinition) -> "SiddhiApp":
        self._check_unique(d.id)
        self.trigger_definitions[d.id] = d
        # a trigger implicitly defines a stream of the same name carrying
        # `triggered_time long` (reference SiddhiApp.defineTrigger behavior)
        self.stream_definitions[d.id] = StreamDefinition(
            id=d.id, attributes=list(d.attributes), annotations=list(d.annotations)
        )
        return self

    def define_function(self, d: FunctionDefinition) -> "SiddhiApp":
        if d.id in self.function_definitions:
            raise DuplicateDefinitionError(f"function '{d.id}' is already defined")
        self.function_definitions[d.id] = d
        return self

    def define_aggregation(self, d: AggregationDefinition) -> "SiddhiApp":
        self._check_unique(d.id)
        self.aggregation_definitions[d.id] = d
        return self

    def add_query(self, q: Query) -> "SiddhiApp":
        self.execution_elements.append(q)
        return self

    def add_partition(self, p: Partition) -> "SiddhiApp":
        self.execution_elements.append(p)
        return self

    @property
    def queries(self) -> List[Query]:
        return [e for e in self.execution_elements if isinstance(e, Query)]
