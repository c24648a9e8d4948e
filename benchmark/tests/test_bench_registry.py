"""The benchmark finds its files by name, agrees with BENCHMARK.json, keeps
clear of JAX and the JAX package, and refuses to run without a card."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.core import registry
from benchmark.core.serve import latency_metric

BENCH = registry.BENCH
ROOT = registry.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# what a model family gives the shared code (core/registry.py)
FAMILY_NAMES = ("leaves", "head_blocks", "make_config", "make_decoder", "make_trainer",
                "flat_params", "first_moments", "serve_patch_points", "train_patch_points",
                "reference_lm", "control_lm", "reference_steps", "train_controls", "serve_ops",
                "train_ops")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def test_every_file_is_found_by_name():
    s = spec()
    assert sorted(w["name"] for w in s["workloads"]) == registry.names("workloads")
    assert sorted(c["name"] for c in s["configs"]) == registry.names("configs")
    assert sorted(m["name"] for m in s["per_layer"]) == sorted(registry.metrics())
    for w in s["workloads"]:
        cell = registry.workload(w["name"])
        assert (cell["config"], cell["traffic"]["name"], cell["chips"], cell["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert registry.traffic(cell["traffic"]["kind"]).RUNNER in ("serve", "train")
        assert set(cell["limits"]) and all(v >= 0 for v in cell["limits"].values())
        if cell["traffic"]["kind"] == "serve_stream":
            # the latency quantile the traffic names is the metric the cell reports
            lat = latency_metric(cell["traffic"]["latency_quantile"])
            assert w["name"] in {m["name"]: m for m in s["end_to_end"]}[lat]["workloads"]
    families = set()
    for c in s["configs"]:
        cfg = registry.config(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert (cfg["source"], cfg["reduced"]) == (c["source"], c["reduced"])
        assert registry.family_of(cfg).__file__ == os.path.join(BENCH, "families",
                                                                 f"{cfg['family']}.py")
        families.add(cfg["family"])
    # every family is some configuration's, and gives what the shared code calls
    assert sorted(families) == registry.names("families")
    for name in families:
        fam = registry.family(name)
        for attr in FAMILY_NAMES:
            assert hasattr(fam, attr), (name, attr)
    mods = registry.metrics()
    for m in s["per_layer"]:
        assert (mods[m["name"]].UNIT, mods[m["name"]].LAYER) == (m["unit"], m["layer"])


def test_benchmark_json_keeps_the_contract():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert s["paths"] == ["benchmark"] and s["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= s["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in s[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in s["workloads"]}
    for w in s["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        reported = [m for m in s["end_to_end"] if w["name"] in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
    for m in s["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(cells)
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(s).encode()) <= 64 * 1024


def test_a_new_workload_file_is_taken_up(tmp_path):
    """A cell added as one file, with no existing file edited, is found and
    runs (on the CPU, at a test's size)."""
    from benchmark.tests.conftest import run_tiny, tiny_cell

    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    cell = registry.workload("serve.jlm50k.synthetic.s2048")
    cell.update(name="serve.jlm50k.synthetic.s512", why="as the synthetic cell, 512 chunks")
    cell["traffic"].update(name="synthetic147.jobs4096.c512", chunk_size=512)
    (copy / "workloads" / f"{cell['name']}.json").write_text(json.dumps(cell))
    assert all(p.read_bytes() == b for p, b in before.items())
    found = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from benchmark.core import registry; print(registry.names('workloads'))", str(tmp_path)],
        capture_output=True, text=True, check=True).stdout
    assert "serve.jlm50k.synthetic.s512" in found
    import benchmark.core.registry as reg
    old = reg.BENCH
    try:
        reg.BENCH = str(copy)
        tiny, cfg, kind = tiny_cell("serve.jlm50k.synthetic.s512")
    finally:
        reg.BENCH = old
    assert tiny["traffic"]["kind"] == "serve_stream"
    out = run_tiny(tiny, cfg, kind)
    assert out["attempted"] > 0 and out["failed"] == 0


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        if os.path.sep + "tests" in dirpath or "__pycache__" in dirpath:
            continue
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "flax", "jlm_tpu"), (path, mod)


def test_only_the_program_adapter_imports_the_program():
    """The program adapter is ``core/program.py`` and each model family's
    file; nothing else imports the program, the reference least of all."""
    adapters = {os.path.join("core", "program.py")} | {
        os.path.join("families", f"{n}.py") for n in registry.names("families")}
    users = {os.path.relpath(p, BENCH) for p in _sources()
             if any(m.split(".")[0] == "jlm_tpu_torch" for m in _imports(p))}
    assert users <= adapters
    assert {os.path.join("core", "program.py"), os.path.join("families", "lstm.py")} <= users
    for path in _sources("reference"):
        assert all(m.split(".")[0] != "jlm_tpu_torch" for m in _imports(path))


def test_a_run_without_a_card_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    got = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "serve.jlm50k.synthetic.s2048", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert got.returncode != 0 and got.stdout.strip() == ""
    assert "no CUDA card" in got.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    got = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "serve.jlm50k.synthetic.s2048", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=600, env=env)
    assert got.returncode != 0 and got.stdout.strip() == ""
    assert "program under test is missing" in got.stderr


def test_a_process_that_loaded_jax_is_refused(monkeypatch):
    sys.path.insert(0, BENCH)
    try:
        import run
    finally:
        sys.path.remove(BENCH)
    monkeypatch.setitem(sys.modules, "jlm_tpu.config", object())
    assert run.barred_modules() == ["jlm_tpu"]
    monkeypatch.delitem(sys.modules, "jlm_tpu.config")
    monkeypatch.setitem(sys.modules, "jlm_tpu_torch_like", object())
    assert "jlm_tpu_torch_like" not in run.barred_modules()
