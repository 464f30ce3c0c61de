"""``SiddhiManager``: the port's entry point for Siddhi apps.

Port of the JAX package's ``core/manager.py`` for this slice: it parses
an app and builds its ``SiddhiAppRuntime`` on one device, ``cuda``
unless the caller passes ``device="cpu"`` (without a card, the default
raises rather than run on the CPU).
"""

from __future__ import annotations

from typing import Dict, Union

from siddhi_tpu_torch.compiler import SiddhiCompiler
from siddhi_tpu_torch.core.app_runtime import SiddhiAppRuntime
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.ops.dense_nfa import resolve_device
from siddhi_tpu_torch.query_api import SiddhiApp


class SiddhiManager:
    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.runtimes: Dict[str, SiddhiAppRuntime] = {}

    def create_siddhi_app_runtime(self, app: Union[str, SiddhiApp]
                                  ) -> SiddhiAppRuntime:
        if isinstance(app, str):
            app = SiddhiCompiler.parse(SiddhiCompiler.update_variables(app))
        rt = SiddhiAppRuntime(app, self.device)
        self.runtimes[rt.name] = rt
        return rt

    def set_persistence_store(self, store):
        raise SiddhiAppCreationError(
            "persistence stores — a later slice of the port; snapshot and "
            "restore a pattern runtime directly")

    def shutdown(self):
        for rt in self.runtimes.values():
            rt.shutdown()
        self.runtimes.clear()
