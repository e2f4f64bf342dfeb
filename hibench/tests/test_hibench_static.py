"""The benchmark's sources and its BENCHMARK.json entries, read as files:
no module imports JAX or the JAX package, the reference imports nothing of
the program, nothing reads ``benchmarks/``, and every cell, configuration,
mix and per-layer metric has its file, found by name."""
import ast
import json
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SOURCES = sorted(BENCH.rglob("*.py"))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, tops
    if path.name != "test_hibench_static.py":
        assert "benchmarks/" not in path.read_text()


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "contextlib", "dataclasses", "math",
                        "typing", "torch", "hibench"}, (path, tops)
        assert not any(n.startswith("hibench.") and
                       not n.startswith("hibench.reference")
                       for n in _imports(path)), path


def test_top_level_names_compared_whole():
    """``repro_torch`` is the port, not the JAX package ``repro``."""
    tops = {name.split(".")[0] for p in SOURCES for name in _imports(p)}
    assert "repro_torch" in tops and "repro" not in tops


def test_every_entry_has_its_file():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert bench["paths"] == ["hibench"]
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert set(c["reduced"]) <= set(cfg.get("published", {}))
    for w in bench["workloads"]:
        assert (BENCH / "cells" / f"{w['name']}.json").is_file()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
