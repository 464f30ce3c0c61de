"""Config plane: extension system parameters and transport/store refs.

Port of the JAX package's ``util/config.py`` (the reference's
``ConfigManager`` SPI, ``InMemoryConfigManager`` and
``YAMLConfigManager``, which reads its document with ``pyyaml`` when
one is built): a ``ConfigReader`` feeds an extension its
deployment-level defaults, and ``refs`` let
``@source(ref='x')``/``@sink(ref='x')``/``@store(ref='x')`` take
connection settings from config.
"""

from __future__ import annotations

from typing import Dict, Optional

from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError


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


class YAMLConfigManager(ConfigManager):
    """YAML-backed manager (reference: YAMLConfigManager.java).  Accepts
    the reference's document shape::

        properties:
          some.property: value
        extensions:
          - extension:
              namespace: source
              name: http
              properties:
                default.port: '8280'
        refs:
          - ref:
              name: store1
              type: memory
              properties:
                topic: t1
    """

    def __init__(self, yaml_content: Optional[str] = None,
                 file_path: Optional[str] = None):
        try:
            import yaml
        except ImportError as e:
            raise SiddhiAppCreationError("pyyaml is required for YAMLConfigManager") from e
        if file_path is not None:
            with open(file_path) as f:
                yaml_content = f.read()
        try:
            root = yaml.safe_load(yaml_content or "") or {}
        except yaml.YAMLError as e:
            raise SiddhiAppCreationError(f"unable to parse YAML config: {e}") from e
        self._properties: Dict[str, str] = {
            str(k): str(v) for k, v in (root.get("properties") or {}).items()
        }
        self._extensions: Dict[tuple, Dict[str, str]] = {}
        for item in root.get("extensions") or []:
            ext = (item or {}).get("extension") or {}
            key = (str(ext.get("namespace", "")), str(ext.get("name", "")))
            self._extensions[key] = {
                str(k): str(v) for k, v in (ext.get("properties") or {}).items()
            }
        self._refs: Dict[str, Dict[str, str]] = {}
        for item in root.get("refs") or []:
            ref = (item or {}).get("ref") or {}
            nm = str(ref.get("name", ""))
            configs = {"type": str(ref.get("type", ""))}
            configs.update(
                {str(k): str(v) for k, v in (ref.get("properties") or {}).items()}
            )
            self._refs[nm] = configs

    def generate_config_reader(self, namespace: str, name: str) -> ConfigReader:
        return ConfigReader(self._extensions.get((namespace, name), {}))

    def extract_system_configs(self, name: str) -> Dict[str, str]:
        return dict(self._refs.get(name, {}))

    def extract_property(self, name: str) -> Optional[str]:
        return self._properties.get(name)
