"""BENCHMARK.json and the files it names: every cell, configuration and
metric found by name; no module imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# the benchmark's sources: what git commits, not its ignored work folders
SOURCES = sorted(p for p in HERE.rglob("*.py")
                 if not {"scratch", ".cache"} & set(p.relative_to(HERE).parts))


def top_level_imports(source: str):
    """The top-level module names a source imports, whole."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path.read_text()) & {"jax", "jaxlib", "flax", "celo_bls_snark_tpu"}


@pytest.mark.parametrize("path", [p for p in SOURCES if p.parent.name == "reference"],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path.read_text()) & {"celo_bls_snark_tpu_torch", "torch",
                                                      "benchmark"}


def test_top_level_names_compared_whole():
    # the port's name begins with the JAX package's: only whole names match
    src = "import celo_bls_snark_tpu_torch.ops.bls\nfrom celo_bls_snark_tpu_torch import x\n"
    assert top_level_imports(src) == {"celo_bls_snark_tpu_torch"}
    assert "celo_bls_snark_tpu" not in top_level_imports(src)
    assert "jax" in top_level_imports("import jax.numpy as jnp\n")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    from benchmark import run

    _spec, entry, cell_file, config = run.cell_spec(cell)
    assert (HERE / "drivers" / f"{cell_file['driver']}.py").exists()
    assert NAME.match(cell) and NAME.match(entry["traffic"]) and NAME.match(entry["config"])
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    assert config["reduced"] == []


@pytest.mark.parametrize("section,folder", [("end_to_end", "e2e"), ("per_layer", "layers")])
def test_every_metric_has_its_reader(section, folder):
    for m in SPEC[section]:
        assert NAME.match(m["name"]), m["name"]
        mod = __import__("benchmark.run", fromlist=["load_module"]).load_module(folder, m["name"])
        assert callable(mod.read)


def test_spec_keys_and_bounds():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    names = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", names)) <= names
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    e2e = {m["name"]: set(m.get("workloads", names)) for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m["workloads"]) <= e2e[m["moves"]]
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]
    assert len(json.dumps(SPEC)) < 64 * 1024
