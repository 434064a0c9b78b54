"""Hierarchical config: YAML plus dotted ``key.sub=value`` overrides.

Counterpart of ``diffdope_tpu/config.py``: an attribute-accessible nested
dict (``cfg.camera.fx``, ``**cfg.camera``), loaded from YAML, with
hydra-like override strings.  ``yaml`` is imported only where a file or an
override string is parsed or the config is written out
(:meth:`ConfigNode.yaml`), so a config built from a dict needs no PyYAML.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Iterable, Mapping, Optional, Sequence, Union


def default_config_path() -> Path:
    """The repo's default config, ``configs/diffdope.yaml``."""
    return Path(__file__).resolve().parent.parent / "configs" / "diffdope.yaml"


class ConfigNode(dict):
    """A dict with attribute access, recursive wrapping and deep merge."""

    def __init__(self, data: Optional[Mapping[str, Any]] = None):
        super().__init__()
        for k, v in (data or {}).items():
            self[k] = v

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, ConfigNode):
            return value
        if isinstance(value, Mapping):
            return ConfigNode(value)
        if isinstance(value, (list, tuple)):
            return [ConfigNode._wrap(v) for v in value]
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, self._wrap(value))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def merge(self, other: Mapping[str, Any]) -> "ConfigNode":
        """Recursively merge ``other`` into self (other wins)."""
        for k, v in other.items():
            if k in self and isinstance(self[k], ConfigNode) and isinstance(v, Mapping):
                self[k].merge(v)
            else:
                self[k] = v
        return self

    def set_dotted(self, dotted_key: str, value: Any) -> None:
        """Set an ``a.b.c`` key, creating the intermediate nodes."""
        parts = dotted_key.split(".")
        node: ConfigNode = self
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], ConfigNode):
                node[p] = ConfigNode()
            node = node[p]
        node[parts[-1]] = value

    def get_dotted(self, dotted_key: str, default: Any = None) -> Any:
        node: Any = self
        for p in dotted_key.split("."):
            if not isinstance(node, dict) or p not in node:
                return default
            node = node[p]
        return node

    def to_dict(self) -> dict:
        """Plain dicts all the way down, lists of nodes included."""
        out: dict = {}
        for k, v in self.items():
            if isinstance(v, ConfigNode):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, ConfigNode) else x for x in v]
            else:
                out[k] = v
        return out

    def copy(self) -> "ConfigNode":  # type: ignore[override]
        """A deep copy, itself a ConfigNode (not ``dict.copy``'s shallow
        dict)."""
        return ConfigNode(copy.deepcopy(self.to_dict()))

    def yaml(self) -> str:
        """The config as YAML text, in key order."""
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def load_config(
    path: Optional[Union[str, Path]] = None,
    overrides: Optional[Iterable[str]] = None,
) -> ConfigNode:
    """Load a YAML config (default ``configs/diffdope.yaml``) and apply
    ``dotted.key=value`` override strings, each value parsed as YAML."""
    import yaml

    with open(path or default_config_path(), "r") as f:
        cfg = ConfigNode(yaml.safe_load(f) or {})
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"Override {ov!r} is not of the form key=value")
        key, _, raw = ov.partition("=")
        try:
            value = yaml.safe_load(raw.strip())
        except yaml.YAMLError:
            value = raw.strip()
        cfg.set_dotted(key.strip(), value)
    return cfg


def cli_overrides(argv: Sequence[str]) -> list:
    """The hydra-style overrides of an argv list (all args with '=')."""
    return [a for a in argv if "=" in a and not a.startswith("-")]
