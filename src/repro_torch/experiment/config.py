"""Declarative config base (DESIGN.md §14), after OLMo-core's ``Config``
/ praxis ``base_model`` idiom: every experiment knob is a field on a
small frozen-at-validation dataclass, serialization is total and stable,
and a wrong key or value fails loudly with the dotted path that caused
it instead of being silently absorbed.

The base class supplies, for any ``@dataclass`` subclass:

* ``to_dict`` / ``from_dict`` — declaration-order dicts; tuples render
  as JSON lists and hydrate back to tuples; nested ``Config`` fields
  hydrate recursively; unknown keys raise ``ConfigurationError`` naming
  the offending dotted path and the valid keys.
* ``to_json`` / ``from_json`` / ``save`` / ``load`` — the JSON faces of
  the same contract (round-trip stable byte-for-byte).
* ``content_digest`` — sha256 over the canonical (sorted-key, compact)
  JSON of ``to_dict()``; the provenance stamp every results artifact
  carries, so a result file names exactly the resolved config that
  produced it regardless of whether it came from ``--config`` or legacy
  flags.
* ``merged`` — overlay a partial dict (e.g. a ``--config`` file) onto a
  base config, re-running validation; ``with_value`` — replace one
  dotted-path field (the CLI-override primitive).

Validation: subclasses override ``validate`` and raise
``ConfigurationError`` with the *local* field path; nested hydration /
``merged`` / ``with_value`` prefix the enclosing path, so the user
always sees e.g. ``policy.reclaim: ...`` no matter how deep the field
sits.  ``__post_init__`` coerces list->tuple and int->float by
annotation and then validates, so directly constructed configs obey the
same contract as hydrated ones.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import typing
from typing import Any, Dict, List, Type, TypeVar, Union

C = TypeVar("C", bound="Config")


class ConfigurationError(ValueError):
    """A config field is missing, unknown, ill-typed, or invalid.

    ``path`` is the dotted field path (``"policy.reclaim"``); the
    message is rendered as ``"<path>: <problem>"``."""

    def __init__(self, message: str, path: str = ""):
        self.bare_message = message
        self.path = path
        super().__init__(f"{path}: {message}" if path else message)

    def at(self, prefix: str) -> "ConfigurationError":
        """The same error, re-anchored under ``prefix`` (used by nested
        hydration so the full dotted path survives re-raising)."""
        sub = f"{prefix}.{self.path}" if self.path else prefix
        return ConfigurationError(self.bare_message, sub)


def _type_hints(cls: type) -> Dict[str, Any]:
    # cached per class: get_type_hints resolves the postponed
    # annotations (from __future__ import annotations) once
    hints = getattr(cls, "_config_hints", None)
    if hints is None or hints[0] is not cls:
        hints = (cls, typing.get_type_hints(cls))
        cls._config_hints = hints
    return hints[1]


def _coerce(value: Any, ann: Any, path: str) -> Any:
    """Coerce ``value`` to annotation ``ann`` (the closed field-type set
    configs use: scalars, Optional[scalar], Tuple[scalar, ...], nested
    Config) or raise ConfigurationError at ``path``."""
    origin = typing.get_origin(ann)
    if origin is Union:                       # Optional[T]
        args = [a for a in typing.get_args(ann) if a is not type(None)]
        if value is None:
            return None
        return _coerce(value, args[0], path)
    if origin is tuple:
        if not isinstance(value, (list, tuple)):
            raise ConfigurationError(
                f"expected a list, got {value!r}", path)
        elem = typing.get_args(ann)[0]
        return tuple(_coerce(v, elem, f"{path}[{i}]")
                     for i, v in enumerate(value))
    if isinstance(ann, type) and issubclass(ann, Config):
        if isinstance(value, ann):
            return value
        if isinstance(value, dict):
            return ann.from_dict(value, _path=path)
        raise ConfigurationError(
            f"expected a {ann.__name__} mapping, got {value!r}", path)
    if ann is bool:
        if not isinstance(value, bool):
            raise ConfigurationError(
                f"expected a bool, got {value!r}", path)
        return value
    if ann is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ConfigurationError(
                f"expected an int, got {value!r}", path)
        return value
    if ann is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ConfigurationError(
                f"expected a number, got {value!r}", path)
        return float(value)
    if ann is str:
        if not isinstance(value, str):
            raise ConfigurationError(
                f"expected a string, got {value!r}", path)
        return value
    raise ConfigurationError(
        f"unsupported config field type {ann!r}", path)


@dataclasses.dataclass
class Config:
    """Base for all experiment configs; subclasses are ``@dataclass``es
    whose fields use the closed type set documented in ``_coerce``."""

    def __post_init__(self):
        hints = _type_hints(type(self))
        for f in dataclasses.fields(self):
            object.__setattr__(self, f.name, _coerce(
                getattr(self, f.name), hints[f.name], f.name))
        self.validate()

    def validate(self) -> None:
        """Override: raise ConfigurationError with the *local* field
        path; enclosing configs prefix their own."""

    # ---- serialization --------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """Declaration-order dict; nested configs and tuples collapse to
        plain dicts and lists (JSON-total by construction)."""
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Config):
                v = v.to_dict()
            elif isinstance(v, tuple):
                v = list(v)
            out[f.name] = v
        return out

    @classmethod
    def from_dict(cls: Type[C], data: Dict[str, Any],
                  _path: str = "") -> C:
        """Hydrate, rejecting unknown keys and re-anchoring any nested
        validation error under ``_path``."""
        if not isinstance(data, dict):
            raise ConfigurationError(
                f"expected a mapping, got {data!r}", _path)
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - fields)
        if unknown:
            raise ConfigurationError(
                f"unknown key(s) {unknown}; valid keys: {sorted(fields)}",
                _path or cls.__name__)
        try:
            return cls(**data)
        except ConfigurationError as e:
            raise (e.at(_path) if _path else e) from None

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1) + "\n"

    @classmethod
    def from_json(cls: Type[C], text: str) -> C:
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls: Type[C], path: str) -> C:
        with open(path) as f:
            return cls.from_json(f.read())

    # ---- provenance -----------------------------------------------------
    def content_digest(self) -> str:
        """sha256 hex digest of the canonical JSON rendering — the
        provenance stamp in BENCH_*.json / results/vgang headers.  Two
        runs resolve to the same digest iff every field (after defaults,
        file overlay, and CLI overrides) is equal."""
        canon = json.dumps(self.to_dict(), sort_keys=True,
                           separators=(",", ":"))
        return hashlib.sha256(canon.encode()).hexdigest()

    # ---- overlay / override ---------------------------------------------
    def merged(self: C, overrides: Dict[str, Any], _path: str = "") -> C:
        """A copy with ``overrides`` (a possibly-partial nested dict,
        e.g. a parsed ``--config`` file) overlaid; unknown keys rejected
        and validation re-run at every level."""
        if not isinstance(overrides, dict):
            raise ConfigurationError(
                f"expected a mapping, got {overrides!r}", _path)
        fields = {f.name for f in dataclasses.fields(self)}
        unknown = sorted(set(overrides) - fields)
        if unknown:
            raise ConfigurationError(
                f"unknown key(s) {unknown}; valid keys: {sorted(fields)}",
                _path or type(self).__name__)
        kwargs: Dict[str, Any] = {}
        for k, v in overrides.items():
            sub = f"{_path}.{k}" if _path else k
            cur = getattr(self, k)
            if isinstance(cur, Config) and isinstance(v, dict):
                kwargs[k] = cur.merged(v, _path=sub)
            else:
                kwargs[k] = v
        try:
            return dataclasses.replace(self, **kwargs)
        except ConfigurationError as e:
            raise (e.at(_path) if _path else e) from None

    def with_value(self: C, path: str, value: Any) -> C:
        """A copy with the dotted-path field replaced (the CLI-override
        primitive); validation re-runs on every enclosing config."""
        head, _, rest = path.partition(".")
        if head not in {f.name for f in dataclasses.fields(self)}:
            raise ConfigurationError(f"unknown field {head!r}", path)
        if rest:
            child = getattr(self, head)
            if not isinstance(child, Config):
                raise ConfigurationError(
                    f"{head!r} is not a nested config", path)
            try:
                new_child = child.with_value(rest, value)
            except ConfigurationError as e:
                raise e.at(head) from None
            return dataclasses.replace(self, **{head: new_child})
        return dataclasses.replace(self, **{head: value})

    def value_at(self, path: str) -> Any:
        """Read the field at a dotted path (CLI help defaults)."""
        obj: Any = self
        for part in path.split("."):
            obj = getattr(obj, part)
        return obj

    @classmethod
    def annotation_at(cls, path: str) -> Any:
        """Resolved type annotation of the field at a dotted path."""
        node: type = cls
        parts = path.split(".")
        for i, part in enumerate(parts):
            hints = _type_hints(node)
            if part not in hints:
                raise ConfigurationError(f"unknown field {part!r}", path)
            ann = hints[part]
            if i + 1 < len(parts):
                if not (isinstance(ann, type) and issubclass(ann, Config)):
                    raise ConfigurationError(
                        f"{part!r} is not a nested config", path)
                node = ann
        return ann
