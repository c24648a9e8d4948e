"""Find a cell's files by name: nothing here lists them.

``workloads/<cell>.json`` names the cell's configuration, its traffic (kind
and parameters), its chips, its ``why`` and the limits of its output check;
``configs/<config>.json`` holds a configuration as it is run;
``traffic/<kind>.py`` generates a traffic kind; ``metrics/<metric>.py`` is
one per-layer metric's reader.  A file added under one of these directories
is found without an edit elsewhere.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Any, Dict, List

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _json(kind: str, name: str) -> Dict[str, Any]:
    path = os.path.join(BENCH, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def workload(name: str) -> Dict[str, Any]:
    return _json("workloads", name)


def config(name: str) -> Dict[str, Any]:
    return _json("configs", name)


def _module(path: str) -> ModuleType:
    name = "benchmark._found." + os.path.relpath(path, BENCH)[:-3].replace("/", ".")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def traffic(kind: str) -> ModuleType:
    path = os.path.join(BENCH, "traffic", f"{kind}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no traffic kind named {kind!r} ({path})")
    return _module(path)


def names(kind: str) -> List[str]:
    ext = ".py" if kind == "metrics" else ".json"
    return sorted(os.path.basename(p)[:-len(ext)]
                  for p in glob.glob(os.path.join(BENCH, kind, f"*{ext}")))


def metrics() -> Dict[str, ModuleType]:
    """Every per-layer metric's module, by metric name."""
    return {n: _module(os.path.join(BENCH, "metrics", f"{n}.py")) for n in names("metrics")}
