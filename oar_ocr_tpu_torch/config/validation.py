"""Declarative config validation.

TPU-native replacement for the reference's ``#[derive(ConfigValidator)]``
proc-macro (oar-ocr-derive/src/lib.rs:124, attrs :12-44 — range/min/max/
optional_range/path). Python needs no codegen: configs are dataclasses and
declare constraints via ``RULES``, a mapping from field name to a
:class:`Rule`; ``validate_config`` applies them and raises ``ConfigError``.

The port's copy of ``oar_ocr_tpu/config/validation.py`` (:1-79), line for line;
only this paragraph is new. ``tests/test_torch_host_copies.py``
holds it to the original.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence

from ..errors import ConfigError


@dataclass(frozen=True)
class Rule:
    """One field constraint (mirrors the derive attributes)."""

    min: Optional[float] = None
    max: Optional[float] = None
    path_exists: bool = False
    choices: Optional[Sequence[Any]] = None
    optional: bool = True  # None values skip validation (optional_range)


def validate_config(cfg: Any, rules: Mapping[str, Rule] | None = None) -> None:
    """Validate a dataclass config against its ``RULES``.

    Raises :class:`ConfigError` on the first violation. A config class may
    also define ``validate_extra(self)`` for cross-field checks.
    """

    rules = rules if rules is not None else getattr(type(cfg), "RULES", {})
    for name, rule in rules.items():
        if not hasattr(cfg, name):
            raise ConfigError("unknown field in RULES", field=name, config=type(cfg).__name__)
        value = getattr(cfg, name)
        if value is None:
            if rule.optional:
                continue
            raise ConfigError("field must not be None", field=name, config=type(cfg).__name__)
        if rule.min is not None and value < rule.min:
            raise ConfigError(
                "value below minimum", field=name, value=value, min=rule.min,
                config=type(cfg).__name__)
        if rule.max is not None and value > rule.max:
            raise ConfigError(
                "value above maximum", field=name, value=value, max=rule.max,
                config=type(cfg).__name__)
        if rule.choices is not None and value not in rule.choices:
            raise ConfigError(
                "value not in allowed choices", field=name, value=value,
                choices=list(rule.choices), config=type(cfg).__name__)
        if rule.path_exists and not os.path.exists(str(value)):
            raise ConfigError("path does not exist", field=name, path=str(value))
    extra = getattr(cfg, "validate_extra", None)
    if callable(extra):
        extra()


def merged(base: Any, override: Any) -> Any:
    """Merge two dataclass configs: non-None fields of ``override`` win.

    Mirrors ModelInferenceConfig::merge (core/config/builder.rs:13-128).
    """

    if override is None:
        return base
    updates = {
        f.name: getattr(override, f.name)
        for f in dataclasses.fields(override)
        if getattr(override, f.name) is not None
    }
    return dataclasses.replace(base, **updates)
