"""Extension lookup: the windows, stream functions, functions,
aggregators and script engines a query names (``#window.length(5)``,
``#pol2Cart(theta, rho)``, ``custom:f(v)``, ``define function
f[python]``), built in or set on the manager, and the check of their
argument types."""

from siddhi_tpu_torch.extension.registry import (
    ExtensionRegistry,
    default_registry,
    extension,
)

__all__ = ["ExtensionRegistry", "default_registry", "extension"]
