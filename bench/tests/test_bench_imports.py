"""What the benchmark imports, and the manifest's shape.

Nothing under ``bench/`` that runs on the card imports JAX or the JAX package
``repro``; names are compared by their whole top-level part, so
``repro_torch`` (the program under test) is not ``repro``.
"""

import ast
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import _paths  # noqa: F401
import pytest

from bench import harness

ROOT = _paths.ROOT
BENCH = ROOT / "bench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_neither_jax_nor_repro():
    for path in BENCH.rglob("*.py"):
        found = top_level_imports(path) & set(harness.FORBIDDEN)
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert top_level_imports(path) <= {"__future__", "copy", "dataclasses", "typing", "numpy", "torch"}, path


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", types.ModuleType("repro_torch_fake"))
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", types.ModuleType("jaxtyping_fake"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core.fake", types.ModuleType("repro.core.fake"))
    assert harness.forbidden_modules() == ["repro"]


SETUP_PATH = r"""
import sys, torch
sys.path[0:0] = [{root!r}, {src!r}]
from bench import harness, textgen, counts, devtrace, readers
from bench.reference import forest as ref
from bench.loops import scan, tail
import repro_torch
for name in {cells!r}:
    cell = harness.load_cell(name)
    ref.forest(ref.automaton(cell.config["pattern"]),
               textgen.texts(cell.config["text"], 300, 1, 1, purpose=1)[0], torch.device("cpu"))
    for m in cell.per_layer:
        harness.reader(m["name"])
assert "repro_torch" in sys.modules
print(harness.forbidden_modules())
"""


def test_set_up_path_loads_neither_jax_nor_repro():
    cells = [w["name"] for w in MANIFEST["workloads"]]
    code = SETUP_PATH.format(root=str(ROOT), src=str(ROOT / "src"), cells=cells)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_means_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "e125.scan", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LAYERS = {"facade", "services", "engine, host side", "reach", "join", "build&merge", "stream",
          "kernels", "device"}


def test_manifest_shape_and_files():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["bench"] and m["command"] == ["python3", "bench/run.py"]
    assert 1 <= m["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in m[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"] == []
        assert c["name"] in {w["config"] for w in m["workloads"]}
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (BENCH / "cells" / f"{w['name']}.json").exists()
        kind = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())["kind"]
        assert (BENCH / "loops" / f"{kind}.py").exists()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for x in m["end_to_end"]:
        assert UNIT.match(x["unit"]) and x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["layer"] in LAYERS and x["moves"] in e2e
        assert any((BENCH / "metrics" / f"{n}.py").exists() for n in (x["name"], x["name"].split(".")[0]))
        for w in x["workloads"]:
            assert w in e2e[x["moves"]].get("workloads", [w])
    for w in m["workloads"]:
        cell = harness.load_cell(w["name"])
        assert len(cell.e2e) >= 2 and cell.per_layer
