"""Finding the pieces of a cell by name: its entry in ``BENCHMARK.json``,
its configuration, traffic mix, correctness limits, entry driver and the
readers of its per-layer metrics.  Adding a configuration, a mix or a
metric adds files and entries; nothing here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names.
    ``package`` is the folder that holds ``configs/``, ``traffic/``,
    ``limits/`` and ``metrics/`` (``portbench/`` unless a test says
    otherwise)."""

    def __init__(self, name: str, bench: dict | None = None,
                 package: Path = PACKAGE):
        self.bench = bench if bench is not None \
            else load_json(ROOT / "BENCHMARK.json")
        self.package = package
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        config = [c for c in self.bench["configs"]
                  if c["name"] == self.workload["config"]][0]
        self.config = load_json(package / "configs"
                                / f"{config['name']}.json")
        self.traffic = load_json(package / "traffic"
                                 / f"{self.workload['traffic']}.json")
        limits = package / "limits" / f"{name}.json"
        self.limits = load_json(limits) if limits.exists() else {}

    def reports(self, metric: dict) -> bool:
        """Whether this cell reports ``metric`` (an end-to-end or per-layer
        entry): listed in its ``workloads``, or, without that key, wherever
        the end-to-end metric it moves is reported."""
        if "workloads" in metric:
            return self.name in metric["workloads"]
        moves = metric.get("moves")
        if moves is None:
            return True
        e2e = [m for m in self.bench["end_to_end"] if m["name"] == moves]
        return bool(e2e) and self.reports(e2e[0])

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"] if self.reports(m)]

    def per_layer(self) -> list:
        return [m for m in self.bench["per_layer"] if self.reports(m)]

    def driver(self):
        """The entry module that ``traffic['entry']`` names."""
        return importlib.import_module(
            f"portbench.entries.{self.traffic['entry']}")

    def reader(self, metric: str):
        """``read(run)`` of ``metrics/<metric>.py``."""
        path = self.package / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{metric.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
