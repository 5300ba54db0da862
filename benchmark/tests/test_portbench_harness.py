"""The harness's rules: what may be imported where, how cells are found, the
shape of ``BENCHMARK.json``, and how a run ends without a card."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness.spec import Spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "zaru_tpu"}


def top_level_imports(path: Path) -> set[str]:
    """Top-level names of the modules a file imports (the part before the
    first dot, whole); relative imports stay inside the benchmark."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


def dotted_names(path: Path) -> set[str]:
    """Top-level names of the dotted module paths a JSON file names."""
    found = re.findall(r'"([A-Za-z_][\w]*(?:\.[A-Za-z_]\w*)+)"', path.read_text())
    return {name.split(".")[0] for name in found}


def test_top_level_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import zaru_tpu_torch.serve\nfrom zaru_tpu.onnx import x\nimport jax.numpy as jnp\n")
    names = top_level_imports(f)
    assert names == {"zaru_tpu_torch", "zaru_tpu", "jax"}
    assert names & FORBIDDEN == {"zaru_tpu", "jax"}


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.json")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_configuration_names_the_jax_package(path):
    assert not dotted_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"zaru_tpu_torch", "benchmark"})


def test_test_files_do_not_reuse_names_of_the_repo_tests():
    ours = {p.name for p in (BENCH / "tests").glob("test_*.py")}
    assert ours and not ours & {p.name for p in (ROOT / "tests").glob("*.py")}


def _throwaway(root: Path):
    """A copy of the benchmark with a new configuration, traffic mix,
    per-layer metric and cell, written as new files and new entries."""
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "face_v1.json").read_text())
    (root / "benchmark" / "configs" / "face_tiny.json").write_text(json.dumps(dict(cfg, name="face_tiny")))
    traffic = json.loads((BENCH / "traffic" / "serve_b1.json").read_text())
    (root / "benchmark" / "traffic" / "serve_b2.json").write_text(json.dumps(dict(traffic, streams=2)))
    (root / "benchmark" / "metrics" / "frames_seen.b2.py").write_text(
        "def read(run):\n    return float(run.window.frames)\n")
    data["configs"].append({"name": "face_tiny", "source": "https://example.org", "reduced": [], "why": "x",
                            "file": "benchmark/configs/face_tiny.json"})
    data["workloads"].append({"name": "face_tiny.serve_b2", "config": "face_tiny", "traffic": "serve_b2",
                              "chips": 1, "why": "x"})
    data["per_layer"].append({"name": "frames_seen.b2", "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "serve loop and ingest",
                              "moves": "frames_per_s", "workloads": ["face_tiny.serve_b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))


def test_new_files_are_found_by_name_with_no_edit(tmp_path):
    _throwaway(tmp_path)
    for path in BENCH.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert (tmp_path / path.relative_to(ROOT)).read_bytes() == path.read_bytes()
    spec = Spec(tmp_path, tmp_path / "benchmark")
    cell = spec.cell("face_tiny.serve_b2")
    assert cell.config["name"] == "face_tiny" and cell.traffic["streams"] == 2
    assert [m["name"] for m in cell.per_layer] == ["frames_seen.b2"]
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "frame_ms_p95", "setup_s"}

    class _Run:
        class window:
            frames = 12

    assert spec.reader("frames_seen.b2")(_Run) == 12.0
    assert spec.cell("face_v1.track_b512").per_layer == Spec().cell("face_v1.track_b512").per_layer


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(data) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert data["paths"] == ["benchmark"] and data["command"][1].startswith("benchmark/")
    assert 1 <= data["run_seconds"] <= 51
    # A full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60 s,
    # 2 x 90 s a cell to compile, 1200 s spare, within 43200 s.
    assert (2 + 14 * 24) * (data["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in data["configs"]}
    for c in data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/") and not c["reduced"]
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]
    cells = set()
    for w in data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in cells
        cells.add((w["config"], w["traffic"]))
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    names = {w["name"] for w in data["workloads"]}
    assert {c["config"] for c in data["workloads"]} == set(configs)
    e2e = {m["name"]: m for m in data["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in data["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in data["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= names and (BENCH / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for w in names:
        reported = [m for m in data["per_layer"] if w in m["workloads"]]
        assert reported, w


def _run(args, cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_run_without_a_card_exits_without_a_result():
    r = _run(["--workload", "face_v1.track_b512", "--seed", "5", "--seconds", "1", "--trace", "0"], ROOT)
    assert r.returncode == 2 and r.stdout.strip() == "" and "CUDA" in r.stderr


def test_run_without_the_program_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = _run(["--workload", "face_v1.track_b512", "--seed", "5", "--seconds", "1", "--trace", "0"], tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.chip
def test_a_cell_runs_correct_on_the_card(cuda):
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "face_v1.track_b512", "--seed",
                        "4294967311", "--seconds", "3", "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
