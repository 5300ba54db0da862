"""Finds a cell's pieces by the names in ``BENCHMARK.json``.

- a configuration: ``benchmark/configs/<config>.json``;
- a traffic mix: ``benchmark/traffic/<traffic>.json``;
- a per-layer metric: ``benchmark/metrics/<metric>.py``, a module with
  ``read(run) -> float | None``;
- the limits that decide ``correct``: ``benchmark/limits/<cell>.json``.

A new cell is an entry in ``BENCHMARK.json`` plus such files; nothing here
changes for it. ``root`` is the checkout's root (the directory that holds
``BENCHMARK.json`` and ``benchmark/``).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

__all__ = ["Cell", "Spec"]

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    limits: dict | None


class Spec:
    def __init__(self, root: str | Path | None = None, bench_dir: str | Path | None = None):
        self.bench_dir = Path(bench_dir) if bench_dir else BENCH_DIR
        self.root = Path(root) if root else self.bench_dir.parent
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def _file(self, kind: str, name: str, suffix: str) -> Path:
        path = self.bench_dir / kind / f"{name}{suffix}"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file {path.relative_to(self.root)}")
        return path

    def config(self, name: str) -> dict:
        return json.loads(self._file("configs", name, ".json").read_text())

    def traffic(self, name: str) -> dict:
        return json.loads(self._file("traffic", name, ".json").read_text())

    def limits(self, cell: str) -> dict | None:
        path = self.bench_dir / "limits" / f"{cell}.json"
        return json.loads(path.read_text()) if path.is_file() else None

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self._file("metrics", metric, ".py")
        spec = importlib.util.spec_from_file_location("benchmark_metric_" + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.data["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")

        def here(metric):
            return name in metric.get("workloads", [name])

        e2e = [m for m in self.data["end_to_end"] if here(m)]
        e2e_names = {m["name"] for m in e2e}
        per_layer = [
            m for m in self.data["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)
        ]
        return Cell(name, self.config(entry["config"]), self.traffic(entry["traffic"]), entry["chips"],
                    e2e, per_layer, self.limits(name))
