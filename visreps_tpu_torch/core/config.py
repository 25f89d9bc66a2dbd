"""Config system: JSON configs + dotlist overrides + nested-config promotion.

Copy of ``visreps_tpu/core/config.py`` (same semantics, so both packages
read the same ``configs/`` files):

  * two-pass override application — once BEFORE nested-config
    promotion (so ``mode`` / ``load_model_from`` overrides pick the
    promoted block) and once AFTER (overrides win);
  * eval promotes ``checkpoint`` | ``torchvision`` and deletes the
    other block; ``eval`` + ``torchvision`` drops ``cfg_id``.

Override values are parsed as JSON literals when possible, else strings.
"""
from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any, Iterable


class Config(dict):
    """Attribute-access dict with recursive wrapping."""

    def __init__(self, data: dict | None = None, **kwargs):
        super().__init__()
        merged = dict(data or {})
        merged.update(kwargs)
        for k, v in merged.items():
            self[k] = v

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, dict):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return [Config._wrap(v) for v in value]
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, Config._wrap(value))

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def to_dict(self) -> dict:
        def unwrap(v):
            if isinstance(v, Config):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))

    def merge(self, other: dict) -> "Config":
        """Deep-merge ``other`` into a copy of self (other wins)."""
        out = self.copy()
        _deep_update(out, other)
        return out


def _deep_update(base: Config, other: dict) -> None:
    for k, v in other.items():
        if isinstance(v, dict) and isinstance(base.get(k), Config):
            _deep_update(base[k], v)
        else:
            base[k] = v


def _parse_value(raw: str) -> Any:
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, ValueError):
        pass
    # Bracketed lists with unquoted elements: region=[V1,V2]
    s = raw.strip()
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        if not inner:
            return []
        return [_parse_value(el.strip()) for el in inner.split(",")]
    return raw


def from_dotlist(overrides: Iterable[str]) -> dict:
    """Parse ``k.x=v`` strings into a nested dict (values JSON-parsed)."""
    out: dict = {}
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"Override must be 'key=value', got: {item!r}")
        key, raw = item.split("=", 1)
        node = out
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(raw.strip())
    return out


def merge_nested_config(cfg: Config, source_key: str) -> None:
    """Promote a nested config block to the root and delete it."""
    if source_key not in cfg:
        return
    source = cfg[source_key].to_dict() if isinstance(cfg[source_key], Config) else dict(cfg[source_key])
    _deep_update(cfg, source)
    del cfg[source_key]


def load_config(config_path: str | Path, overrides: list[str] | None = None) -> Config:
    """Load a JSON config and apply CLI dotlist overrides."""
    config_path = Path(config_path)
    if not config_path.exists():
        raise FileNotFoundError(f"Config file not found: {config_path}")
    with open(config_path) as f:
        cfg = Config(json.load(f))

    override_dict = from_dotlist(overrides) if overrides else {}
    if override_dict:
        _deep_update(cfg, override_dict)

    source_key = cfg.get("load_model_from") if cfg.get("mode") == "eval" else cfg.get("model_class")
    if source_key:
        other_key = {
            "eval": {"torchvision": "checkpoint", "checkpoint": "torchvision"},
            "train": {"custom_model": "standard_model", "standard_model": "custom_model"},
        }[cfg["mode"]].get(source_key)
        if other_key and other_key in cfg:
            del cfg[other_key]
        merge_nested_config(cfg, source_key)

    if override_dict:
        _deep_update(cfg, override_dict)

    if cfg.get("mode") == "eval" and cfg.get("load_model_from") == "torchvision":
        cfg.pop("cfg_id", None)

    return cfg


def get_seed_letter(seed: int) -> str:
    """Seed (1-9) → letter (a-i)."""
    if not isinstance(seed, int) or seed < 1 or seed > 9:
        raise ValueError(f"Seed must be an integer between 1-9, got {seed}")
    return chr(ord("a") + seed - 1)
