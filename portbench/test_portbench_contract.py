"""The benchmark's own files: what they import, and ``BENCHMARK.json`` with
every file it names."""

from __future__ import annotations

import ast
import importlib.util
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
NO_JAX = {"jax", "jaxlib", "flax", "repro"}
COMPARED = {"loss_gap", "grad_gap", "grad_gap_median", "grad_gap_kind", "update_gap",
            "decode_gap"}


def imported_tops(path: Path) -> set[str]:
    """The top-level names (before the first dot, whole) of every module the
    file imports, relative imports aside."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_imports_name_whole_top_level_modules(tmp_path):
    path = tmp_path / "imports.py"
    path.write_text("import repro_torch.models\nfrom repro.core import x\nimport jaxlib as j\n"
                    "from . import feed\nimportlib.import_module('jax.numpy')\n")
    assert imported_tops(path) == {"repro_torch", "repro", "jaxlib", "jax"}
    assert imported_tops(path) & NO_JAX == {"repro", "jaxlib", "jax"}  # repro_torch is whole


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_imports_jax_or_the_jax_package(path):
    found = imported_tops(path)
    assert not found & NO_JAX, f"{path} imports {found & NO_JAX}"
    if "reference" in path.relative_to(HERE).parts:
        assert "repro_torch" not in found, f"the reference {path} imports the port"


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell, run_seconds + 60 each, 180 s a
    # cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs_files():
    keys = {"name", "source", "file", "reduced", "why"}
    for c in BENCH["configs"]:
        assert set(c) == keys
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]
        assert not [k for k in c["reduced"] if k.endswith(("_dim", "_rank")) or "d_" in k]
        assert 1 <= len(c["why"]) <= 200
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_cells_and_their_files():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = json.loads((HERE / "cells" / f"{w['name']}.json").read_text())
        assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert cell["limits"] and set(cell["limits"]) <= COMPARED
    assert configs == {w["config"] for w in BENCH["workloads"]}


def test_metrics_and_their_readers():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and "\n" not in m["layer"]
        assert set(m.get("workloads", cells)) <= cells
        path = HERE / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("reader", path)
        reader = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(reader)
        assert callable(reader.read)
    for cell in cells:  # setup_s, another end-to-end metric and a per-layer one each
        reports = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [cell])]
        assert reports and len([m for m in BENCH["end_to_end"]
                                if cell in m.get("workloads", [cell])]) >= 2
