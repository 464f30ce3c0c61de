"""Plan-time extension parameter validation.

Port of the JAX package's ``extension/validator.py``, a re-design of
the reference's annotation-driven validator
(util/extension/validator/InputParameterValidator.java, driven by the
``@Parameter`` / ``@ParameterOverload`` metadata in siddhi-annotations):
extension classes declare ``PARAMETERS`` (name -> allowed types) and
``OVERLOADS`` (accepted signatures, optionally ending with the
repetitive marker ``"..."``), and the planner validates compiled
argument types against them *before* instantiation, so a bad call fails
app creation with a typed error instead of a runtime shape/type error.

Classes without an ``OVERLOADS`` declaration are accepted unchecked
(the reference behaves the same for extensions without
``parameterOverloads``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

from siddhi_tpu_torch.core.exceptions import SiddhiAppValidationError
from siddhi_tpu_torch.query_api.attribute import AttrType

#: Repetitive-parameter marker: an overload ending with REPEAT accepts
#: zero or more further arguments matching the parameter named just
#: before it (reference: SiddhiConstants.REPETITIVE_PARAMETER_NOTATION).
REPEAT = "..."


@dataclass(frozen=True)
class Param:
    """One declared parameter (the ``@Parameter`` analog).  An empty
    ``types`` tuple accepts any type."""

    name: str
    types: Tuple[AttrType, ...] = ()


def _accepts(param: Param, t: AttrType) -> bool:
    return not param.types or t in param.types or t is AttrType.OBJECT


def _signature(overload: Sequence[str], params: Dict[str, Param]) -> str:
    parts = []
    for name in overload:
        if name == REPEAT:
            parts.append(REPEAT)
            continue
        p = params.get(name)
        ts = "|".join(t.value for t in p.types) if p and p.types else "any"
        parts.append(f"{name} <{ts}>")
    return "(" + ", ".join(parts) + ")"


def validate_extension_args(cls, name: str, arg_types: Sequence[AttrType],
                            where: str = "") -> None:
    """Check compiled argument types against ``cls.OVERLOADS``.

    Raises SiddhiAppValidationError when overloads are declared and no
    signature matches; silently accepts undeclared extensions."""
    # own-class declaration only — like Java's getAnnotation(), a subclass
    # does not inherit the base extension's signature (it may legitimately
    # accept different arguments)
    overloads = (cls.__dict__.get("OVERLOADS") if isinstance(cls, type)
                 else getattr(cls, "OVERLOADS", None))
    if overloads is None:
        return
    declared = getattr(cls, "PARAMETERS", ())
    params = {p.name: p for p in declared}

    def matches(overload: Sequence[str]) -> bool:
        names = list(overload)
        repeat = bool(names) and names[-1] == REPEAT
        if repeat:
            names = names[:-1]
            if len(arg_types) < len(names):
                return False
        elif len(arg_types) != len(names):
            return False
        for i, pname in enumerate(names):
            p = params.get(pname, Param(pname))
            if not _accepts(p, arg_types[i]):
                return False
        if repeat and names:
            tail_param = params.get(names[-1], Param(names[-1]))
            for t in arg_types[len(names):]:
                if not _accepts(tail_param, t):
                    return False
        return True

    for overload in overloads:
        if matches(overload):
            return
    got = "(" + ", ".join(t.value for t in arg_types) + ")"
    expected = " or ".join(_signature(o, params) for o in overloads) or "()"
    raise SiddhiAppValidationError(
        f"{where or name}: arguments {got} match no declared signature "
        f"of '{name}'; expected {expected}"
    )
