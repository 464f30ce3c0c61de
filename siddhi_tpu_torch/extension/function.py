"""Custom scalar functions and script UDFs.

Port of the JAX package's ``extension/function.py``: a custom function
is a class with ``execute(*values)`` called per row (vectorized by the
wrapper), or a plain callable; a script engine is an extension of kind
``'script'`` keyed by language that compiles a ``define function
f[lang] return type { body }`` body into such a callable.  Both run on
the host, on numpy columns; a device filter that calls one is refused
(``planner/expr.py``) and its query falls back to the host.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.extension.registry import extension
from siddhi_tpu_torch.planner.expr import CompiledExpression
from siddhi_tpu_torch.planner.host_expr import _to_type
from siddhi_tpu_torch.query_api import AttrType


class FunctionExecutor:
    """Custom scalar function SPI (reference: FunctionExecutor.java).

    Subclass, set ``return_type``, implement ``execute(*values)`` (one
    row's argument values -> one value).  Register with
    ``SiddhiManager.set_extension('ns:name', cls, kind='function')``.
    """

    return_type: AttrType = AttrType.OBJECT

    def init(self, arg_types: List[AttrType]):
        pass

    def execute(self, *values):
        raise NotImplementedError


def make_scalar_function_builder(scalar: Callable,
                                 return_type: Optional[AttrType]):
    """Wrap a per-row callable into a host expression-compiler function
    builder: the argument arrays are broadcast and the callable applied
    row by row through a numpy ufunc; the object result is cast to
    ``return_type``."""

    def builder(args: List[CompiledExpression]) -> CompiledExpression:
        nin = len(args)
        ufunc = np.frompyfunc(scalar, nin, 1) if nin else None

        def fn(env):
            if nin == 0:
                return scalar()
            vals = [np.atleast_1d(np.asarray(a.fn(env))) for a in args]
            vals = np.broadcast_arrays(*vals)
            out = ufunc(*vals)
            if return_type is not None and return_type != AttrType.OBJECT:
                return _to_type(out, return_type)
            return out

        return CompiledExpression(fn, return_type or AttrType.OBJECT)

    return builder


def builder_for_extension(factory) -> Callable:
    """A ``kind='function'`` extension may be a FunctionExecutor
    subclass (instantiated per call site, ``init`` given the argument
    types), an instance, or a plain callable."""
    if isinstance(factory, type) and issubclass(factory, FunctionExecutor):
        def builder(args: List[CompiledExpression]) -> CompiledExpression:
            inst = factory()
            inst.init([a.type for a in args])
            return make_scalar_function_builder(
                inst.execute, inst.return_type)(args)

        return builder
    if isinstance(factory, FunctionExecutor):
        def builder(args: List[CompiledExpression]) -> CompiledExpression:
            factory.init([a.type for a in args])
            return make_scalar_function_builder(
                factory.execute, factory.return_type)(args)

        return builder
    if callable(factory):
        return make_scalar_function_builder(factory, None)
    raise SiddhiAppCreationError(
        f"function extension {factory!r} is neither FunctionExecutor nor "
        "callable")


class ScriptEngine:
    """Script-language SPI (extension kind 'script', name = language)."""

    def compile(self, name: str, body: str, return_type: AttrType
                ) -> Callable:
        raise NotImplementedError


@extension("script", "python")
class PythonScript(ScriptEngine):
    """``define function f[python] return type { body }``.

    The body sees the argument values as ``data`` (a list).  A body that
    is a single expression is evaluated; otherwise it is executed and
    must assign ``result``.
    """

    def compile(self, name: str, body: str, return_type: AttrType
                ) -> Callable:
        src = body.strip()
        try:
            code = compile(src, f"<function {name}>", "eval")
            mode = "eval"
        except SyntaxError:
            try:
                code = compile(src, f"<function {name}>", "exec")
                mode = "exec"
            except SyntaxError as e:
                raise SiddhiAppCreationError(
                    f"function '{name}[python]': body does not compile: {e}"
                ) from e

        def scalar(*values):
            g = {"data": list(values)}
            if mode == "eval":
                return eval(code, g)  # noqa: S307 — user-defined script UDF
            exec(code, g)  # noqa: S102
            if "result" not in g:
                raise SiddhiAppCreationError(
                    f"function '{name}[python]': multi-statement body must "
                    "set 'result'")
            return g["result"]

        return scalar


@extension("script", "javascript")
@extension("script", "js")
class JavaScriptScript(ScriptEngine):
    """No JavaScript engine ships with the port, as with the reference:
    planning a ``[javascript]`` function fails unless the user registers
    an engine of their own under kind='script'."""

    def compile(self, name: str, body: str, return_type: AttrType
                ) -> Callable:
        raise SiddhiAppCreationError(
            f"function '{name}[javascript]': no JavaScript engine available; "
            "register one with set_extension('javascript', Engine, "
            "kind='script') or use [python]"
        )


def build_functions(extensions, function_definitions):
    """Name -> host function builder: the registry's ``function``
    extensions, then the app's ``define function`` scripts through its
    ``script`` engines (the reference's ``AppPlanner._build_functions``)."""
    fns = {}
    for full_name, factory in extensions.items("function"):
        fns[full_name] = builder_for_extension(factory)
    for fd in function_definitions.values():
        engine_factory = extensions.lookup("script", fd.language.lower())
        if engine_factory is None:
            raise SiddhiAppCreationError(
                f"function '{fd.id}': unknown script language "
                f"'{fd.language}'")
        scalar = engine_factory().compile(fd.id, fd.body, fd.return_type)
        fns[fd.id] = make_scalar_function_builder(scalar, fd.return_type)
    return fns
