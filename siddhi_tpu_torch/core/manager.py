"""``SiddhiManager``: the port's entry point for Siddhi apps.

Port of the JAX package's ``core/manager.py``: it holds the per-manager
context (``SiddhiContext``: extensions, attributes, config, data
sources), parses an app and builds its ``SiddhiAppRuntime`` on one
device, ``cuda`` unless the caller passes ``device="cpu"`` (without a
card, the default raises rather than run on the CPU), and tracks the
runtimes it registered.  The config manager's refs and readers and the
record-table handler manager are read by the store planner of the app
runtime (``@store`` tables), the source and sink handler managers by its
transport planner (``@source``/``@sink``).  The multiplex registry
(``@app:multiplex``: the shared engines every app of the manager seats
its queries in) lives on the context, so a group outlives a crashed
app.  The persistence store (``set_persistence_store``) and the
apps' input journals (``@app:faults(journal=)``, keyed by app name, so a
runtime built after a crash replays its predecessor's input) live on
the context; ``persist()`` and ``restore_last_state()`` run over every
registered runtime.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Union

from siddhi_tpu_torch.compiler import SiddhiCompiler
from siddhi_tpu_torch.core.app_runtime import SiddhiAppRuntime
from siddhi_tpu_torch.ops.dense_nfa import resolve_device
from siddhi_tpu_torch.query_api import SiddhiApp
from siddhi_tpu_torch.util.config import ConfigManager, InMemoryConfigManager


class SiddhiContext:
    """Per-manager shared state: the extension registry each app plans
    against a copy of, attributes, the config manager, named data
    sources, the handler managers, the persistence store, the input
    journals and the multiplex registry (reference: ``core/context.py``
    ``SiddhiContext``)."""

    def __init__(self):
        from siddhi_tpu_torch.extension.registry import default_registry

        self.extensions = default_registry()
        self.attributes: Dict[str, object] = {}
        self.config_manager: ConfigManager = InMemoryConfigManager()
        self.data_sources: Dict[str, object] = {}
        self.source_handler_manager = None
        self.sink_handler_manager = None
        self.record_table_handler_manager = None
        self.persistence_store = None
        # crash-recovery journals keyed by app name: on the MANAGER
        # context so a journal outlives a crashed runtime, and a fresh
        # runtime of the same app replays it (util/faults.py)
        self.input_journals: Dict[str, object] = {}
        # @app:multiplex: fingerprint -> shared engine groups, across
        # apps (multiplex/registry.py; created on first use)
        self.multiplex_registry = None


class SiddhiManager:
    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.siddhi_context = SiddhiContext()
        self.runtimes: Dict[str, SiddhiAppRuntime] = {}

    def create_siddhi_app_runtime(self, app: Union[str, SiddhiApp],
                                  register: bool = True) -> SiddhiAppRuntime:
        app_string = app if isinstance(app, str) else ""
        if isinstance(app, str):
            app = SiddhiCompiler.parse(SiddhiCompiler.update_variables(app))
        rt = SiddhiAppRuntime(app, self.device, self.siddhi_context)
        # a live re-plan parses the app text afresh
        rt._app_string = app_string
        if register:
            self.runtimes[rt.name] = rt
            rt._manager = self
        return rt

    def validate_siddhi_app(self, app: Union[str, SiddhiApp]):
        """Plan the app end to end, then discard it: raises
        ``SiddhiAppCreationError``/``SiddhiParserError`` on any problem
        (reference: SiddhiManager.validateSiddhiApp).  Unregistered, so
        validating 'X' leaves a running 'X' alone."""
        self.create_siddhi_app_runtime(app, register=False).shutdown()

    def create_sandbox_siddhi_app_runtime(self, app: Union[str, SiddhiApp]
                                          ) -> SiddhiAppRuntime:
        """A runtime with external transports stripped: every
        non-inMemory ``@source``/``@sink`` and every ``@store`` is removed
        so the app runs in-process (reference:
        SiddhiManager.createSandboxSiddhiAppRuntime)."""
        if isinstance(app, str):
            app = SiddhiCompiler.parse(SiddhiCompiler.update_variables(app))
        else:
            app = copy.deepcopy(app)  # never strip the caller's object

        def keep(ann) -> bool:
            if ann.name.lower() not in ("source", "sink"):
                return True
            return (ann.element("type") or "").lower() == "inmemory"

        for sd in app.stream_definitions.values():
            sd.annotations[:] = [a for a in sd.annotations if keep(a)]
        for td in app.table_definitions.values():
            td.annotations[:] = [a for a in td.annotations
                                 if a.name.lower() != "store"]
        return self.create_siddhi_app_runtime(app)

    def get_attributes(self) -> Dict[str, object]:
        return self.siddhi_context.attributes

    def set_attribute(self, key: str, value):
        """Shared objects visible to extensions (reference:
        SiddhiManager.setAttribute)."""
        self.siddhi_context.attributes[key] = value

    def get_siddhi_app_runtime(self, name: str
                               ) -> Optional[SiddhiAppRuntime]:
        return self.runtimes.get(name)

    def get_siddhi_app_runtimes(self) -> Dict[str, SiddhiAppRuntime]:
        return dict(self.runtimes)

    def set_extension(self, name: str, factory, kind: str = "function"):
        """Register a user extension under 'ns:name' or 'name' for the
        apps created after (reference: SiddhiManager.setExtension)."""
        ns, _, nm = name.rpartition(":")
        self.siddhi_context.extensions.register(kind, nm, factory,
                                                ns or None)

    def remove_extension(self, name: str, kind: str = "function"):
        ns, _, nm = name.rpartition(":")
        self.siddhi_context.extensions.unregister(kind, nm, ns or None)

    def set_config_manager(self, config_manager: ConfigManager):
        """Deployment config of extensions and refs (reference:
        SiddhiManager.setConfigManager)."""
        self.siddhi_context.config_manager = config_manager

    def set_data_source(self, name: str, data_source):
        """Named shared data sources of store extensions (reference:
        SiddhiManager.setDataSource)."""
        self.siddhi_context.data_sources[name] = data_source

    def set_source_handler_manager(self, m):
        self.siddhi_context.source_handler_manager = m

    def set_sink_handler_manager(self, m):
        self.siddhi_context.sink_handler_manager = m

    def set_record_table_handler_manager(self, m):
        self.siddhi_context.record_table_handler_manager = m

    def set_persistence_store(self, store):
        """The store every app of this manager persists to (reference:
        SiddhiManager.setPersistenceStore)."""
        self.siddhi_context.persistence_store = store

    def persist(self):
        """Persist every registered app (reference:
        SiddhiManager.persist)."""
        for rt in list(self.runtimes.values()):
            rt.persist()

    def restore_last_state(self):
        """Restore every registered app to its newest saved revision
        (reference: SiddhiManager.restoreLastState)."""
        for rt in list(self.runtimes.values()):
            rt.restore_last_revision()

    def health(self) -> Dict[str, dict]:
        """Overload-protection health of every registered app
        (``SiddhiAppRuntime.health``)."""
        return {name: rt.health() for name, rt in list(self.runtimes.items())}

    def shutdown(self):
        for rt in list(self.runtimes.values()):
            rt.shutdown()
        self.runtimes.clear()

    # Java-style aliases
    createSiddhiAppRuntime = create_siddhi_app_runtime
    validateSiddhiApp = validate_siddhi_app
    createSandboxSiddhiAppRuntime = create_sandbox_siddhi_app_runtime
    setConfigManager = set_config_manager
    setDataSource = set_data_source
    setSourceHandlerManager = set_source_handler_manager
    setSinkHandlerManager = set_sink_handler_manager
    setRecordTableHandlerManager = set_record_table_handler_manager
    setPersistenceStore = set_persistence_store
    restoreLastState = restore_last_state
