"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration (`configs/<file>` as the
manifest's `file` gives it), a traffic mix (`traffic/<traffic>.json`) and,
for the comparison that decides `correct`, its limits
(`limits/<cell>.json`). Each per-layer metric is read by
`metrics/<metric>.py`. Adding a cell, a mix or a metric adds files and
entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


def load_manifest(repo: Path = REPO) -> dict:
    with open(repo / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One `workloads` entry with its configuration, traffic, limits and
    metrics (`Cell.find` reads them from the files the manifest names)."""

    def __init__(self, name: str, entry: dict, config: dict, traffic: dict,
                 limits: dict, end_to_end: List[dict],
                 per_layer: List[dict]):
        self.name, self.entry = name, entry
        self.config, self.traffic, self.limits = config, traffic, limits
        self.chips = int(entry["chips"])
        self.end_to_end = [m for m in end_to_end
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in per_layer
                          if name in m.get("workloads", [name])]

    @classmethod
    def find(cls, manifest: dict, name: str, repo: Path = REPO) -> "Cell":
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        entry = cells[name]
        configs = {c["name"]: c for c in manifest["configs"]}
        return cls(name, entry,
                   read_json(repo / configs[entry["config"]]["file"]),
                   read_json(ROOT / "traffic" / f"{entry['traffic']}.json"),
                   read_json(ROOT / "limits" / f"{name}.json"),
                   manifest["end_to_end"], manifest["per_layer"])


def metric_reader(name: str):
    """The `read(run)` function of `metrics/<name>.py`."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read

