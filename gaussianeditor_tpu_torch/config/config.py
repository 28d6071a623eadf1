"""Config system: YAML, dataclass validation, dotlist overrides and
step-interpolated scalars.

Counterpart of `gaussianeditor_tpu/config/config.py` (`C`,
`merge_dotlist`, `parse_structured`, `load_config`), copied: it holds no
array code. PyYAML is imported only by the two functions that parse
YAML, so that the rest of the port (and `C`) runs where PyYAML is not
installed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Union


def C(value: Any, step: Union[int, float],
      interpolation: str = "linear") -> float:
    """Step-interpolated scalar.

    value: a number -> constant; or [start_step, v0, v1, end_step] ->
    linear interpolation of v0 -> v1 over [start_step, end_step]
    (clamped); or [v0, v1, end_step] -> start_step 0.
    """
    if isinstance(value, (int, float)):
        return float(value)
    value = list(value)
    if len(value) == 3:
        value = [0] + value
    assert len(value) == 4, f"cannot interpolate schedule {value}"
    start_step, v0, v1, end_step = value
    if end_step <= start_step:
        return float(v1)
    t = (step - start_step) / (end_step - start_step)
    t = min(max(t, 0.0), 1.0)
    if interpolation == "linear":
        return float(v0 + (v1 - v0) * t)
    raise ValueError(f"unknown interpolation {interpolation}")


def merge_dotlist(cfg: Dict[str, Any],
                  dotlist: Sequence[str]) -> Dict[str, Any]:
    """Apply `a.b.c=value` overrides (YAML-parsed values) in place."""
    import yaml

    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"override '{item}' is not key=value")
        key, val = item.split("=", 1)
        parsed = yaml.safe_load(val)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"cannot override through non-dict at {p}")
        node[parts[-1]] = parsed
    return cfg


def parse_structured(cls, data: Optional[Dict[str, Any]]):
    """Recursively instantiate dataclass `cls` from a dict, erroring on
    unknown keys."""
    data = dict(data or {})
    if not dataclasses.is_dataclass(cls):
        return data
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(
            f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for name, value in data.items():
        resolved = _resolve_type(fields[name].type, cls)
        if dataclasses.is_dataclass(resolved) and isinstance(value, dict):
            kwargs[name] = parse_structured(resolved, value)
        else:
            kwargs[name] = value
    return cls(**kwargs)


def _resolve_type(tp, owner):
    if isinstance(tp, str):
        import sys
        mod = sys.modules.get(owner.__module__)
        return getattr(mod, tp, None) or tp
    return tp


def load_config(path: str, cli_overrides: Sequence[str] = (), cls=None):
    """YAML, then the dotlist overrides, then (if `cls` is given) the
    dataclass validation."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    raw = merge_dotlist(raw, cli_overrides)
    if cls is not None:
        return parse_structured(cls, raw)
    return raw
