"""Attribute types for stream/table schemas.

Mirrors the reference type system
(``io.siddhi.query.api.definition.Attribute.Type``): STRING, INT, LONG,
FLOAT, DOUBLE, BOOL, OBJECT.  On the device, numeric types map to dtypes
(int32/int64/float32/float64) while STRING/OBJECT stay host-side (string
keys are interned to int64 ids when used for partitioning/group-by).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class AttrType(enum.Enum):
    STRING = "string"
    INT = "int"
    LONG = "long"
    FLOAT = "float"
    DOUBLE = "double"
    BOOL = "bool"
    OBJECT = "object"

    @property
    def is_numeric(self) -> bool:
        return self in (AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE)

    @property
    def np_dtype(self):
        return _NP_DTYPES[self]


_NP_DTYPES = {
    AttrType.STRING: np.dtype(object),
    AttrType.INT: np.dtype(np.int32),
    AttrType.LONG: np.dtype(np.int64),
    AttrType.FLOAT: np.dtype(np.float32),
    AttrType.DOUBLE: np.dtype(np.float64),
    AttrType.BOOL: np.dtype(np.bool_),
    AttrType.OBJECT: np.dtype(object),
}

# Numeric promotion lattice used by arithmetic type inference, mirroring the
# per-type executor selection of the reference ExpressionParser
# (reference: util/parser/ExpressionParser.java:207).
_PROMOTION_ORDER = [AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE]


def promote(a: AttrType, b: AttrType) -> AttrType:
    """Binary arithmetic result type (int < long < float < double)."""
    if not (a.is_numeric and b.is_numeric):
        raise TypeError(f"cannot promote non-numeric types {a} and {b}")
    return _PROMOTION_ORDER[max(_PROMOTION_ORDER.index(a), _PROMOTION_ORDER.index(b))]


@dataclass(frozen=True)
class Attribute:
    name: str
    type: AttrType

    def __repr__(self) -> str:
        return f"{self.name} {self.type.value}"
