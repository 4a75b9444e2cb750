"""The model family of a configuration: the one lookup through which the
benchmark reads a configuration's `model` group. The family is named by
the group's optional `"family"` key (absent: `dgcnn`) and is three
modules, found by that name:

    benchmark/reference/<family>.py   the plain reference: `Graphs`,
                                      `follow`, `evaluate`, `FAULTS`; and
                                      the weight layout `leaf_shapes`
    benchmark/work/<family>.py        the work count: `fold_epoch`
    benchmark/program/<family>.py     the program's side: `config_fields`,
                                      the published model in the program's
                                      Config names; `model`; `net` and
                                      `folds_net`, the program's nets
                                      built from the flat weights

A configuration whose family has no such module fails when it is loaded
(`inputs.load_config`), naming the module it looked for."""

from __future__ import annotations

import dataclasses
import importlib
import re
from types import ModuleType

DEFAULT = "dgcnn"
NAME = re.compile(r"^[a-z][a-z0-9_]{0,63}$")


@dataclasses.dataclass(frozen=True)
class Family:
    name: str
    reference: ModuleType
    work: ModuleType
    program: ModuleType


def of(cfg: dict) -> Family:
    """The family of configuration `cfg`; ValueError for a family without
    its modules, naming the module that is missing."""
    name = cfg["model"].get("family", DEFAULT)
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"model family {name!r} is not a module name")
    mods = []
    for kind in ("reference", "work", "program"):
        module = f"benchmark.{kind}.{name}"
        try:
            mods.append(importlib.import_module(module))
        except ModuleNotFoundError as e:
            if e.name != module:  # the module is there; something it imports is not
                raise
            raise ValueError(f"model family {name!r}: no module {module} "
                             f"(benchmark/{kind}/{name}.py)") from None
    return Family(name, *mods)
