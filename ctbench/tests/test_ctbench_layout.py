"""BENCHMARK.json against its contract's shape, every name resolving to a
file of its own, and the import rules of the benchmark's sources."""

import ast
import json
import re
from pathlib import Path

import pytest

from ctbench import run as R

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ctbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= 1 and all(w["chips"] in (1, 4)
                             for w in BENCH["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    bench, c, config, traffic, data = R.load_cell(cell)
    assert (ROOT / "ctbench" / "drivers" / f"{traffic['driver']}.py").is_file()
    for kind, key in (("tasks", "task"), ("counts", "family"),
                      ("reference", "family")):
        assert (ROOT / "ctbench" / kind / f"{config[key]}.py").is_file()
    assert data["limits"]
    e2e = R.cell_metrics(bench, cell, 0)
    layer = R.cell_metrics(bench, cell, 1)
    assert any(m["name"] == "setup_s" for m in e2e) and len(e2e) >= 2
    assert layer
    for m in e2e + layer:
        assert (ROOT / "ctbench" / "metrics" / f"{m['name']}.py").is_file()


def test_metrics_name_their_layer_and_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "\n" not in m["layer"]
        for c in m.get("workloads", []):
            assert c in cells
            assert c in e2e[m["moves"]].get("workloads", [c])


def test_every_file_under_paths_has_a_name_of_the_allowed_characters():
    for p in (ROOT / "ctbench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(p.relative_to(ROOT)))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_under_ctbench_and_no_program_under_reference():
    forbidden = set(R.FORBIDDEN)
    assert "cloud_transformers_tpu_torch" not in forbidden
    for path in (ROOT / "ctbench").rglob("*.py"):
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert not tops & forbidden, (path, tops & forbidden)
        if "reference" in path.parts:
            assert "cloud_transformers_tpu_torch" not in tops, path


def test_the_loaded_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "cloud_transformers_tpu_torch_x",
                        types.ModuleType("x"))
    assert "cloud_transformers_tpu" not in R.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jnp"))
    assert "jax" in R.loaded_forbidden()
