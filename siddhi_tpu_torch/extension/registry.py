"""Extension registry: ``namespace:name`` -> factory, per extension kind.

Port of the JAX package's ``extension/registry.py`` for the built-in
extensions the host query runtime runs: the windows of
``ops/windows.py`` and the stream functions of
``ops/stream_functions.py`` register themselves with the ``@extension``
decorator when those modules are imported, and ``default_registry()``
hands each app its own copy.  User extensions (``setExtension``) and
``define function`` stay refused (``ROADMAP.md`` §1 item 10), so the
port keeps only the two kinds its built-ins use.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, Optional

KINDS = ("window", "stream_function")


class ExtensionRegistry:
    def __init__(self):
        self._kinds: Dict[str, Dict[str, Callable]] = defaultdict(dict)

    @staticmethod
    def full_name(namespace: Optional[str], name: str) -> str:
        return f"{namespace}:{name}" if namespace else name

    def register(self, kind: str, name: str, factory: Callable,
                 namespace: Optional[str] = None):
        if kind not in KINDS:
            raise ValueError(f"unknown extension kind {kind!r}")
        self._kinds[kind][self.full_name(namespace, name)] = factory

    def lookup(self, kind: str, name: str,
               namespace: Optional[str] = None) -> Optional[Callable]:
        return self._kinds[kind].get(self.full_name(namespace, name))

    def names(self, kind: str):
        return sorted(self._kinds[kind])

    def copy(self) -> "ExtensionRegistry":
        r = ExtensionRegistry()
        for kind, entries in self._kinds.items():
            r._kinds[kind] = dict(entries)
        return r


# the built-ins, registered by their modules at import time
_DEFAULT = ExtensionRegistry()


def extension(kind: str, name: str, namespace: Optional[str] = None):
    """Class decorator registering a built-in extension in the default
    registry (the reference's ``@Extension`` annotation)."""

    def wrap(cls):
        _DEFAULT.register(kind, name, cls, namespace)
        return cls

    return wrap


def default_registry() -> ExtensionRegistry:
    """A copy of the registry holding every built-in extension."""
    # imported for their registration side effects
    import siddhi_tpu_torch.ops.stream_functions  # noqa: F401
    import siddhi_tpu_torch.ops.windows  # noqa: F401

    return _DEFAULT.copy()
