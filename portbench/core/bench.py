"""One run of one cell: set-up, the measured window, the traced reading,
the check against the reference, and the result line.

The window is a closed loop: the next request or step starts when the
previous one has handed its result to the host.  Its end-to-end metrics
come from the host's clock around each item; ``setup_s`` runs from the
process's start to the first timed item."""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd.profiler import record_function

from portbench.core.registry import Cell
from portbench.core.trace import Profiler, Ranges

FORBIDDEN = ("jax", "jaxlib", "flax", "gfe_mamba_tpu")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def p95(values) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


class Run:
    """What the per-layer readers read: the cell, its configuration and
    mix, the items completed in the traced window, the trace and the
    conv work the ranges counted."""

    def __init__(self, cell: Cell, driver, items: int, trace, ranges):
        self.cell, self.config, self.traffic = cell, cell.config, \
            cell.traffic
        self.driver, self.items, self.trace = driver, items, trace
        self.ranges = ranges

    @property
    def peak_flops(self) -> float:
        return float(self.config["peak_flops"])

    @property
    def peak_bytes_per_s(self) -> float:
        return float(self.config["peak_bytes_per_s"])


def e2e_metrics(cell: Cell, setup_s, window_s, times, batch) -> dict:
    """The cell's end-to-end metrics; ``<base>.<cells>`` (a metric split
    by cells whose spreads differ) is ``<base>``'s formula."""
    n = len(times)
    values = {
        "setup_s": setup_s,
        "volumes_per_s": batch * n / window_s,
        "request_p95_ms": p95(times) * 1e3,
        "step_ms": window_s / n * 1e3,
    }
    return {m["name"]: {"value": values[m["name"].split(".")[0]],
                        "unit": m["unit"]} for m in cell.end_to_end()}


def judge(cell: Cell, numbers: dict) -> tuple[bool, dict]:
    """The numbers the cell's limits name, each beside its limit: all
    must be there, finite and at or under their limits."""
    checks, ok = {}, bool(cell.limits)
    for name, limit in cell.limits.items():
        value = numbers.get(name, float("nan"))
        ok = ok and math.isfinite(value) and value <= limit
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", driver=None) -> dict:
    """Run ``cell`` and return the result line's object.  ``driver`` may
    replace the entry's driver object (tests)."""
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
        log(f"card: {power_limit()}")
    drv = driver or cell.driver().Driver(cell, seed, device)
    drv.setup()
    ranges = None
    if trace:
        ranges = Ranges()
        for layer, modules in drv.layers().items():
            for module in modules:
                ranges.around(module, layer)
        ranges.conv_modules(drv.model)
        drv.item(-1)                      # the hooks' own first call
        sync(device)
        prof = Profiler()
        prof.start()
        ranges.counting = True
    times, failed = [], 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    end = t0 + seconds
    window = record_function("pb.window") if trace else None
    if window:
        window.__enter__()
    while True:
        t = time.perf_counter()
        if trace:
            with record_function("pb.item"):
                failed += bool(drv.item(len(times)))
        else:
            failed += bool(drv.item(len(times)))
        t1 = time.perf_counter()
        times.append(t1 - t)
        if t1 >= end:
            break
    if window:
        window.__exit__(None, None, None)
    window_s = t1 - t0
    result = {"attempted": len(times), "failed": failed}
    device_info = {"platform": "gpu" if device == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name()
                   if device == "cuda" else "cpu", "count": 1,
                   "memory_peak_bytes": torch.cuda.max_memory_allocated()
                   if device == "cuda" else 0}
    med = statistics.median(times)
    qs = statistics.quantiles(times, n=4) if len(times) > 1 else [med] * 3
    log(f"window {window_s:.3f} s, {len(times)} items, median "
        f"{med * 1e3:.3f} ms, quartiles {qs[0] * 1e3:.3f} / "
        f"{qs[2] * 1e3:.3f} ms, setup {setup_s:.3f} s")
    for k, v in drv.counters().items():
        log(f"counter {k}: {v}")
    if trace:
        ranges.counting = False
        tr = prof.stop()
        ranges.remove()
        run = Run(cell, drv, len(times), tr, ranges)
        metrics = {}
        for m in cell.per_layer():
            value = cell.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
                log(f"{m['name']} = {value} {m['unit']} ({power_limit()})")
        result["metrics"] = metrics
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    else:
        result["metrics"] = e2e_metrics(cell, setup_s, window_s, times,
                                        drv.batch)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded after the window: {found}")
    result["device"] = device_info
    drv.release()
    numbers = drv.check()
    for name, value in numbers.items():
        if name not in cell.limits:
            log(f"reading {name} {value!r} (not compared)")
    ok, checks = judge(cell, numbers)
    result["correct"] = ok
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return result


def sync(device) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def main(argv, t_start: float) -> int:
    parser = argparse.ArgumentParser(prog="portbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = Cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start)
    order = ["correct", "attempted", "failed", "metrics", "device"]
    if "breakdown" in result:
        order.append("breakdown")
    order.append("checks")
    print(json.dumps({k: result[k] for k in order}), flush=True)
    return 0
