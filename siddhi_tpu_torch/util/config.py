"""Config plane: extension system parameters and transport/store refs.

Port of the JAX package's ``util/config.py`` for its in-memory manager
(the reference's ``ConfigManager`` SPI and ``InMemoryConfigManager``):
a ``ConfigReader`` feeds an extension its deployment-level defaults, and
``refs`` let ``@source(ref='x')``/``@sink(ref='x')``/``@store(ref='x')``
take connection settings from config.  The YAML-backed manager is not
ported.
"""

from __future__ import annotations

from typing import Dict, Optional


class ConfigReader:
    """Per-extension key/value reader (reference: ConfigReader.java)."""

    def __init__(self, configs: Optional[Dict[str, str]] = None):
        self._configs = dict(configs or {})

    def read_config(self, key: str, default: Optional[str] = None
                    ) -> Optional[str]:
        return self._configs.get(key, default)

    def get_all_configs(self) -> Dict[str, str]:
        return dict(self._configs)

    # Java-style aliases
    readConfig = read_config
    getAllConfigs = get_all_configs


class ConfigManager:
    """SPI (reference: ConfigManager.java:26)."""

    def generate_config_reader(self, namespace: str, name: str
                               ) -> ConfigReader:
        raise NotImplementedError

    def extract_system_configs(self, name: str) -> Dict[str, str]:
        """Configs of a ``ref='name'`` reference (with its 'type')."""
        raise NotImplementedError

    def extract_property(self, name: str) -> Optional[str]:
        raise NotImplementedError

    # Java-style aliases
    def generateConfigReader(self, namespace, name):
        return self.generate_config_reader(namespace, name)

    def extractSystemConfigs(self, name):
        return self.extract_system_configs(name)

    def extractProperty(self, name):
        return self.extract_property(name)


class InMemoryConfigManager(ConfigManager):
    """Dict-backed manager (reference: InMemoryConfigManager.java).

    ``configs`` keys are '<namespace>.<name>.<key>' (extension configs)
    or plain property names; ``system_configs`` maps ref-name ->
    {'type': ..., **properties}.
    """

    def __init__(self, configs: Optional[Dict[str, str]] = None,
                 system_configs: Optional[Dict[str, Dict[str, str]]] = None):
        self._configs = dict(configs or {})
        self._system = {k: dict(v)
                        for k, v in (system_configs or {}).items()}

    def generate_config_reader(self, namespace: str, name: str
                               ) -> ConfigReader:
        prefix = f"{namespace}.{name}."
        return ConfigReader({
            k[len(prefix):]: v for k, v in self._configs.items()
            if k.startswith(prefix)
        })

    def extract_system_configs(self, name: str) -> Dict[str, str]:
        return dict(self._system.get(name, {}))

    def extract_property(self, name: str) -> Optional[str]:
        return self._configs.get(name)

