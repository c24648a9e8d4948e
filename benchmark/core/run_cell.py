"""One cell's run, whatever its kind, and the result line it prints."""

from __future__ import annotations

import math
from typing import Any, Dict

from benchmark.core import registry, serve, train

RUNNERS = {"serve": serve.run, "train": train.run}


def run(cell: Dict[str, Any], cfg: Dict[str, Any], kind, seed: int, seconds: float,
        trace: bool, device, t_start: float, build_dir: str) -> Dict[str, Any]:
    family = registry.family_of(cfg)
    traffic = kind.build(cell["traffic"], cfg["model"], seed)
    return RUNNERS[kind.RUNNER](cell, cfg, family, traffic, seed, seconds, trace, device,
                                t_start, build_dir)


def correct(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def result_line(out: Dict[str, Any], trace: bool, metric_mods: Dict[str, Any], device,
                chips: int) -> Dict[str, Any]:
    import torch

    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": chips, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line: Dict[str, Any] = {"correct": correct(out["checks"]), "attempted": out["attempted"],
                            "failed": out["failed"]}
    if not trace:
        line["metrics"] = {k: {"value": v, "unit": u} for k, (v, u) in out["metrics"].items()}
        line["device"] = dev
    else:
        t = out["trace"]
        metrics = {}
        for name, mod in metric_mods.items():
            value = mod.read(t)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
        line["metrics"] = metrics
        line["device"] = {**dev, "busy_s": t.device.busy_s, "window_s": t.device.window_s}
        line["breakdown"] = {"device_ops": [[n, s] for n, s in t.device.device_ops],
                             "idle_gaps": [[n, s] for n, s in t.device.idle_by_host]}
    line["checks"] = out["checks"]
    return line
