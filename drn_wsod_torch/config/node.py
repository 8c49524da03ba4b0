"""A minimal, self-contained yacs-style config node (the port's own copy of
``drn_wsod_tpu/config/node.py``).

Mirrors the behaviour the reference relies on (reference:
detectron2/config/config.py:11-108): attribute access, freezing, YAML
round-trip, ``_BASE_`` file inheritance and dotted-key override lists — without
depending on yacs.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List

import yaml

_BASE_KEY = "_BASE_"


class CfgNode(dict):
    """Dict with attribute access, freeze support and YAML/_BASE_ merging."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for k, v in init_dict.items():
            if isinstance(v, dict):
                v = CfgNode(v)
            dict.__setitem__(self, k, v)

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"CfgNode has no attribute '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"CfgNode is frozen; cannot set '{name}'")
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            value = CfgNode(value)
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"CfgNode is frozen; cannot set '{name}'")
        dict.__setitem__(self, name, value)

    # -- freezing -----------------------------------------------------------
    def freeze(self) -> "CfgNode":
        object.__setattr__(self, CfgNode.IMMUTABLE, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo) -> "CfgNode":
        out = CfgNode()
        memo[id(self)] = out
        for k, v in self.items():
            dict.__setitem__(out, k, copy.deepcopy(v, memo))
        return out

    def __reduce__(self):
        return (CfgNode, (self.to_dict(),))

    # -- merging ------------------------------------------------------------
    def merge_from_other(self, other: "CfgNode", allow_new: bool = False) -> None:
        for k, v in other.items():
            if isinstance(v, CfgNode) and k in self and isinstance(self[k], CfgNode):
                self[k].merge_from_other(v, allow_new=allow_new)
            else:
                if k not in self and not allow_new:
                    raise KeyError(f"Non-existent config key: {k}")
                if isinstance(v, str):
                    # yacs semantics: python-literal strings in YAML (e.g.
                    # "('voc_2007_train',)") decode to their value
                    v = _decode_value(v)
                if k in self and self[k] is not None and v is not None:
                    v = _coerce(v, self[k], k)
                dict.__setitem__(self, k, v)

    def merge_from_file(self, filename: str, allow_new: bool = False) -> None:
        loaded = _load_yaml_with_base(filename)
        # Reference-era configs carry a ``VERSION:`` key driving yacs config
        # migration (reference detectron2/config/compat.py:1-229; latest
        # version = 2). VERSION: 2 configs use current key names and merge
        # as-is; anything older would need the migration machinery this
        # framework deliberately does not have — reject it loudly instead of
        # silently misreading legacy keys.
        cur = self.get("VERSION", 2)
        if "VERSION" in loaded and loaded["VERSION"] != cur:
            raise KeyError(
                f"{filename} sets 'VERSION: {loaded['VERSION']}' but this "
                f"framework only understands version-{cur} configs — the "
                "detectron2 config-version migration system (compat.py) "
                "does not exist in drn_wsod_torch. Upgrade the config to "
                "current key names (reference tools: detectron2 "
                "config/compat.py upgrade_config) and set VERSION: 2.")
        self.merge_from_other(loaded, allow_new=allow_new)

    def merge_from_list(self, opts: List[Any]) -> None:
        assert len(opts) % 2 == 0, f"Override list must be pairs, got {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            if isinstance(value, str):
                value = _decode_value(value)
            if node[leaf] is not None and value is not None:
                value = _coerce(value, node[leaf], key)
            dict.__setitem__(node, leaf, value)

    # -- io -----------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (v.to_dict() if isinstance(v, CfgNode) else v) for k, v in self.items()
        }

    def dump(self) -> str:
        return yaml.safe_dump(_yaml_safe(self.to_dict()), sort_keys=True)

    def get_by_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for p in dotted.split("."):
            if not isinstance(node, dict) or p not in node:
                return default
            node = node[p]
        return node


def _yaml_safe(obj):
    if isinstance(obj, dict):
        return {k: _yaml_safe(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return [_yaml_safe(v) for v in obj]
    if isinstance(obj, list):
        return [_yaml_safe(v) for v in obj]
    return obj


def _decode_value(value: str) -> Any:
    import ast

    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        pass
    try:
        return yaml.safe_load(value)
    except yaml.YAMLError:
        return value


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Cast `value` towards the type of the existing entry (yacs semantics)."""
    if isinstance(old, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(old, list) and isinstance(value, tuple):
        return list(value)
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if type(value) is type(old) or old is None or value is None:
        return value
    if isinstance(old, bool) != isinstance(value, bool):
        raise ValueError(
            f"Type mismatch for key {key}: {type(old).__name__} vs {type(value).__name__}"
        )
    return value


def _load_yaml_with_base(filename: str) -> CfgNode:
    with open(filename, "r") as f:
        raw = yaml.safe_load(f) or {}
    if _BASE_KEY in raw:
        base_path = raw.pop(_BASE_KEY)
        if not os.path.isabs(base_path):
            base_path = os.path.join(os.path.dirname(filename), base_path)
        base = _load_yaml_with_base(base_path)
        child = CfgNode(raw)
        base.merge_from_other(child, allow_new=True)
        return base
    return CfgNode(raw)
