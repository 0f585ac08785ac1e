"""Experiment configuration with the JAX package's YAML overlay semantics
(port of `ideal_gan_tpu/utils/config.py`): every run writes its settings as
YAML; downstream tools load the training run's settings, overlay their own
flags and backfill missing keys with defaults. PyYAML is imported by
`save` and `load` only."""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Mapping


class Config(dict):
    """dict with attribute access and a YAML round trip."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def save(self, path: str | Path) -> None:
        import yaml
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(dict(self), f, sort_keys=False)

    @classmethod
    def load(cls, path: str | Path) -> "Config":
        import yaml
        with open(path) as f:
            return cls(yaml.safe_load(f) or {})

    def overlay(self, other: Mapping[str, Any]) -> "Config":
        """A new Config in which `other`'s entries win."""
        out = Config(self)
        out.update(other)
        return out

    def backfill(self, defaults: Mapping[str, Any]) -> "Config":
        """A new Config in which `defaults` fill only the missing keys."""
        out = Config(defaults)
        out.update(self)
        return out


def parse_flags(defaults: Mapping[str, Any], argv=None) -> Config:
    """A Config from defaults and command-line flags: every default becomes
    a typed --flag; bools accept true/false/yes/no/1/0; dict, list and
    tuple flags accept JSON (a tuple default comes back a list)."""
    parser = argparse.ArgumentParser()
    for key, val in defaults.items():
        if isinstance(val, bool):
            parser.add_argument(f"--{key}", type=_parse_bool, default=val)
        elif isinstance(val, (dict, list, tuple)):
            parser.add_argument(f"--{key}", type=json.loads,
                                default=json.dumps(list(val) if
                                                   isinstance(val, tuple)
                                                   else val))
        elif val is None:
            parser.add_argument(f"--{key}", type=str, default=None)
        else:
            parser.add_argument(f"--{key}", type=type(val), default=val)
    cfg = Config(vars(parser.parse_args(argv)))
    for key, val in cfg.items():
        if isinstance(val, str) and isinstance(defaults.get(key),
                                               (dict, list, tuple)):
            cfg[key] = json.loads(val)
    return cfg


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"boolean expected, got {v!r}")
