"""Tiny cells on the CPU: the real ``BENCHMARK.json`` with fixture cells
added as entries, their files in a copy of the benchmark's folders
together with ``fixtures/``."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from portbench.core import bench
from portbench.core.registry import PACKAGE, ROOT, Cell

FIXTURES = Path(__file__).resolve().parent / "fixtures"
TINY = {  # fixture cell -> (config, traffic, the real cell it stands for)
    "gfe_tiny.score_tiny": ("gfe_tiny", "score_tiny", "gfe_mamba.score_b4"),
    "unet_tiny.seg_tiny": ("unet_tiny", "seg_tiny", "unet3d_seg.train_b1"),
    "gfe_tiny.stage2_tiny": ("gfe_tiny", "stage2_tiny",
                             "gfe_mamba.stage2_b2"),
    "gfe_tiny.stage1_tiny": ("gfe_tiny", "stage1_tiny",
                             "gfe_mamba.stage1_b1"),
}


def package(tmp: Path) -> Path:
    """The benchmark's folders with the fixtures' files added; a tiny
    cell takes the limits of the real cell it stands for (the Stage-2
    cell, not in the benchmark, has fixture limits of its own)."""
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(PACKAGE / sub, tmp / sub, dirs_exist_ok=True)
    for name, (_, _, real) in TINY.items():
        if (PACKAGE / "limits" / f"{real}.json").exists():
            shutil.copy(PACKAGE / "limits" / f"{real}.json",
                        tmp / "limits" / f"{name}.json")
    for sub in ("configs", "traffic", "metrics", "limits"):
        if (FIXTURES / sub).exists():
            shutil.copytree(FIXTURES / sub, tmp / sub, dirs_exist_ok=True)
    return tmp


def benchmark() -> dict:
    """``BENCHMARK.json`` with the tiny cells entered beside the real
    ones they stand for, and the fixture metric."""
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cfg in ("gfe_tiny", "unet_tiny"):
        b["configs"].append({"name": cfg, "source": "fixture",
                             "file": f"portbench/tests/fixtures/configs/"
                                     f"{cfg}.json",
                             "reduced": [], "why": "a CPU test"})
    real_cells = {w["name"] for w in b["workloads"]}
    for name, (cfg, traffic, real) in TINY.items():
        b["workloads"].append({"name": name, "config": cfg,
                               "traffic": traffic, "chips": 1,
                               "why": "a CPU test"})
        like = real if real in real_cells else "unet3d_seg.train_b1"
        for m in b["end_to_end"] + b["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    b["per_layer"].append({"name": "items.fixture", "unit": "items",
                           "better": "higher", "source": "program_counter",
                           "layer": "model step", "moves": "step_ms"})
    return b


def cell(tmp: Path, name: str) -> Cell:
    return Cell(name, bench=benchmark(), package=package(tmp))


def run(c: Cell, seed: int = 2 ** 31 + 11, seconds: float = 0.5,
        driver=None) -> dict:
    return bench.run_cell(c, seed, seconds, False, time.perf_counter(),
                          device="cpu", driver=driver)
