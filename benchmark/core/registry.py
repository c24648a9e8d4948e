"""Find a cell's files by name: nothing here lists them.

``workloads/<cell>.json`` names the cell's configuration, its traffic (kind
and parameters), its chips, its ``why`` and the limits of its output check;
``configs/<config>.json`` holds a configuration as it is run;
``traffic/<kind>.py`` generates a traffic kind; ``metrics/<metric>.py`` is
one per-layer metric's reader; ``families/<family>.py`` is a model family,
which a configuration names under ``"family"``.  A file added under one of
these directories is found without an edit elsewhere.

A model family gives the shared code (``core/``, ``reference/beam.py``,
``calibrate.py``) everything that depends on the model:

- ``leaves(model)``: the weights' table (``core.weights.Leaf``: name and
  shape in the program's layout, scale key, int8 axis); ``head_blocks(model)``:
  the head's ``(D, V)`` blocks, for the head's roofline;
- the program adapter, the only code besides ``core/program.py`` that
  imports the program (inside functions): ``make_config(model, section,
  **extra)``, ``make_decoder(params, lexicon, config, precision, device)``,
  ``make_trainer(config, params, device)``, ``flat_params(trainer)``,
  ``first_moments(trainer)`` (Adam's), ``serve_patch_points()`` and
  ``train_patch_points()`` (``(owner, attribute, layer label, shape of a
  call or None)`` each);
- the reference, plain PyTorch under ``reference/``: ``reference_lm(params,
  model)`` (an LM that ``reference/beam.py`` drives), ``control_lm(weights,
  model)`` (the serve control: the same one precision lower),
  ``reference_steps(init, model, train, ids, traffic, device, **variant)`` and
  ``train_controls()`` (the variants for ``calibrate.py``), both None for a
  family with no training cell;
- ``serve_ops(kanas, model, serve, by_reading, max_word_len)`` and
  ``train_ops(model, traffic, steps)``: useful operations by precision, for
  ``mfu.serve`` and ``mfu.train``.
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


def family(name: str) -> ModuleType:
    path = os.path.join(BENCH, "families", f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no model family named {name!r} ({path})")
    return _module(path)


def family_of(cfg: Dict[str, Any]) -> ModuleType:
    """The family a configuration names; there is no default."""
    if "family" not in cfg:
        path = os.path.join(BENCH, "configs", f"{cfg.get('name')}.json")
        raise ValueError(f"configuration {cfg.get('name')!r} names no model family: "
                       f"{path} has no \"family\" key")
    return family(cfg["family"])


def names(kind: str) -> List[str]:
    ext = ".json" if kind in ("workloads", "configs") else ".py"
    return sorted(os.path.basename(p)[:-len(ext)]
                  for p in glob.glob(os.path.join(BENCH, kind, f"*{ext}")))


def metrics() -> Dict[str, ModuleType]:
    """Every per-layer metric's module, by metric name."""
    return {n: _module(os.path.join(BENCH, "metrics", f"{n}.py")) for n in names("metrics")}
