"""CLI derivation for experiment surfaces (DESIGN.md §14.2).

Every surface declares *which* ``ExperimentConfig`` fields it exposes
(a list of dotted paths plus legacy-spelling aliases) and this module
derives the argparse flags from the field annotations — tuple fields
parse comma lists, bools become store-true flags, Optional scalars
parse their inner type.  Resolution order (later wins):

    surface base config  <  --config FILE (partial overlay)  <
    explicitly-passed flags

Flags not passed on the command line never touch the config (an UNSET
sentinel distinguishes "absent" from "passed the default value"), so a
``--config`` file's values survive unless explicitly overridden — and a
legacy invocation with no ``--config`` resolves to exactly the surface
base config plus its flags, making the two spellings digest-identical
when they describe the same run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import typing
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from repro_torch.experiment.config import Config, ConfigurationError
from repro_torch.experiment.experiment import ExperimentConfig


class _Unset:
    def __repr__(self):
        return "<unset>"


UNSET = _Unset()


@dataclasses.dataclass(frozen=True)
class Flag:
    path: str                       # dotted config path
    option: str                     # e.g. "--sim-check"
    dest: str                       # argparse dest
    parse: Optional[Callable]       # None for store-true bools
    help: str = ""


def _tuple_parser(elem: type) -> Callable:
    def parse(text: str):
        if text == "":
            return ()
        return tuple(elem(part) for part in text.split(","))
    return parse


def _parser_for(ann: Any, path: str) -> Optional[Callable]:
    """Command-line string parser for an annotation; None = store-true
    bool."""
    origin = typing.get_origin(ann)
    if origin is Union:             # Optional[T]
        inner = [a for a in typing.get_args(ann) if a is not type(None)]
        return _parser_for(inner[0], path)
    if origin is tuple:
        return _tuple_parser(typing.get_args(ann)[0])
    if ann is bool:
        return None
    if ann in (int, float, str):
        return ann
    raise ConfigurationError(
        f"cannot derive a CLI flag for field type {ann!r}", path)


def derive_flags(config_cls: type, include: Sequence[str],
                 aliases: Optional[Dict[str, str]] = None,
                 helps: Optional[Dict[str, str]] = None) -> List[Flag]:
    """One Flag per dotted path in ``include``, named after the leaf
    field (``engine.sim_check`` -> ``--sim-check``) unless aliased
    (``taskset.n_per_point`` -> ``--n`` preserves the legacy CLI)."""
    aliases = aliases or {}
    helps = helps or {}
    flags: List[Flag] = []
    seen: Dict[str, str] = {}
    for path in include:
        ann = config_cls.annotation_at(path)
        option = aliases.get(
            path, "--" + path.split(".")[-1].replace("_", "-"))
        if option in seen:
            raise ConfigurationError(
                f"flag {option} for {path!r} collides with {seen[option]!r}"
                " — alias one of them", path)
        seen[option] = path
        flags.append(Flag(path=path, option=option,
                          dest="cfg_" + path.replace(".", "__"),
                          parse=_parser_for(ann, path),
                          help=helps.get(path, "")))
    return flags


def add_flags(parser: argparse.ArgumentParser, flags: Sequence[Flag],
              base: Config, config_flag: bool = True) -> None:
    """Register the derived flags (all defaulting to UNSET) plus the
    ``--config`` overlay flag; help strings show the surface defaults."""
    if config_flag:
        parser.add_argument(
            "--config", default=None, metavar="FILE",
            help="experiment config JSON (configs/experiments/); "
                 "explicitly-passed flags override its fields")
    for f in flags:
        default = base.value_at(f.path)
        helptext = f.help or f"{f.path}"
        if isinstance(default, tuple):
            shown = ",".join(str(v) for v in default)
        else:
            shown = default
        if f.parse is None:
            parser.add_argument(f.option, dest=f.dest, default=UNSET,
                                action="store_const", const=True,
                                help=f"{helptext} (default: {shown})")
        else:
            parser.add_argument(f.option, dest=f.dest, default=UNSET,
                                type=str, metavar=f.path.split(".")[-1]
                                .upper(),
                                help=f"{helptext} (default: {shown})")


def resolve_config(base: ExperimentConfig, args: argparse.Namespace,
                   flags: Sequence[Flag],
                   expected_kind: Optional[str] = None
                   ) -> ExperimentConfig:
    """base config <- --config file overlay <- explicit flags."""
    cfg = base
    config_path = getattr(args, "config", None)
    if config_path:
        with open(config_path) as fh:
            try:
                data = json.load(fh)
            except json.JSONDecodeError as e:
                raise ConfigurationError(
                    f"{config_path}: not valid JSON ({e})") from None
        cfg = cfg.merged(data)
    for f in flags:
        raw = getattr(args, f.dest)
        if raw is UNSET:
            continue
        value = raw if f.parse is None else f.parse(raw)
        cfg = cfg.with_value(f.path, value)
    if expected_kind is not None and cfg.kind != expected_kind:
        raise ConfigurationError(
            f"this surface runs kind={expected_kind!r} experiments, "
            f"got {cfg.kind!r}"
            + (f" (from {config_path})" if config_path else ""), "kind")
    return cfg


def cli_main(parser: argparse.ArgumentParser, flags: Sequence[Flag],
             base: ExperimentConfig, argv: Optional[Sequence[str]],
             expected_kind: str) -> ExperimentConfig:
    """Parse + resolve in one step, converting config errors into the
    parser's standard error exit (message on stderr, status 2)."""
    args = parser.parse_args(argv)
    try:
        return resolve_config(base, args, flags, expected_kind)
    except ConfigurationError as e:
        parser.error(str(e))
        raise AssertionError("unreachable")  # parser.error raises SystemExit
