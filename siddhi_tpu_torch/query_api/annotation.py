"""Annotations: ``@name(key='value', ...)`` attached to definitions/queries.

Mirrors ``io.siddhi.query.api.annotation.Annotation``.  Elements with no
key (positional values) are stored under ascending integer-string keys in
``elements`` order, matching the reference behavior of `@store('a','b')`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class Annotation:
    name: str
    # ordered (key-or-None, value) pairs
    elements: List[Tuple[Optional[str], str]] = field(default_factory=list)
    annotations: List["Annotation"] = field(default_factory=list)

    def element(self, key: Optional[str] = None, default: Optional[str] = None) -> Optional[str]:
        """Value for `key`; with key=None, the first keyless element."""
        for k, v in self.elements:
            if k is None and key is None:
                return v
            if k is not None and key is not None and k.lower() == key.lower():
                return v
        return default

    def values(self) -> List[str]:
        return [v for _, v in self.elements]

    def nested(self, name: str) -> Optional["Annotation"]:
        for a in self.annotations:
            if a.name.lower() == name.lower():
                return a
        return None


def find_annotation(annotations: List[Annotation], name: str) -> Optional[Annotation]:
    for a in annotations:
        if a.name.lower() == name.lower():
            return a
    return None
