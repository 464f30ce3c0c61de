"""Definitions: stream / table / window / trigger / function / aggregation.

Mirrors ``io.siddhi.query.api.definition.*`` (SURVEY.md §1 L0).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from siddhi_tpu_torch.query_api.annotation import Annotation
from siddhi_tpu_torch.query_api.attribute import Attribute, AttrType
from siddhi_tpu_torch.query_api.expression import Expression, FunctionCall


@dataclass
class AbstractDefinition:
    id: str
    attributes: List[Attribute] = field(default_factory=list)
    annotations: List[Annotation] = field(default_factory=list)

    @property
    def attribute_names(self) -> List[str]:
        return [a.name for a in self.attributes]

    def attribute_type(self, name: str) -> AttrType:
        for a in self.attributes:
            if a.name == name:
                return a.type
        raise KeyError(f"attribute '{name}' not in definition '{self.id}'")

    def attribute_position(self, name: str) -> int:
        for i, a in enumerate(self.attributes):
            if a.name == name:
                return i
        raise KeyError(f"attribute '{name}' not in definition '{self.id}'")


@dataclass
class StreamDefinition(AbstractDefinition):
    pass


@dataclass
class TableDefinition(AbstractDefinition):
    pass


@dataclass
class WindowDefinition(AbstractDefinition):
    """``define window W (a int) length(5) output all events``."""

    window_function: Optional[FunctionCall] = None
    # reference default: ALL events (WindowDefinition.java:40)
    output_event_type: str = "all"  # current | expired | all


@dataclass
class TriggerDefinition(AbstractDefinition):
    """``define trigger T at every 5 sec | 'cron-expr' | 'start'``.

    Trigger streams carry one attribute: triggered_time (long).
    """

    at_every_ms: Optional[int] = None
    at_cron: Optional[str] = None
    at_start: bool = False

    def __post_init__(self):
        if not self.attributes:
            self.attributes = [Attribute("triggered_time", AttrType.LONG)]


@dataclass
class FunctionDefinition(AbstractDefinition):
    """``define function f[lang] return type { body }`` (script UDF)."""

    language: str = "python"
    return_type: AttrType = AttrType.OBJECT
    body: str = ""


@dataclass
class AggregationDefinition(AbstractDefinition):
    """``define aggregation A from S select ... group by ... aggregate by ts
    every sec ... year`` (reference: aggregation/AggregationRuntime.java:81).

    ``durations`` is an ordered list of duration names among
    seconds/minutes/hours/days/weeks/months/years.
    """

    input_stream: object = None  # SingleInputStream
    selector: object = None  # Selector
    aggregate_by: Optional[str] = None  # attribute name (timestamp source)
    durations: List[str] = field(default_factory=list)
