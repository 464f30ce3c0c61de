"""Built-in extension lookup: the windows and stream functions a query
names (``#window.length(5)``, ``#pol2Cart(theta, rho)``) and the check
of their argument types."""

from siddhi_tpu_torch.extension.registry import (
    ExtensionRegistry,
    default_registry,
    extension,
)

__all__ = ["ExtensionRegistry", "default_registry", "extension"]
