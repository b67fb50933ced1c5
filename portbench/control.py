"""Readings that the correctness limits are set from, many seeds in one
process (the benchmark's own runs never run this).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--precision fp8|tf32]

For each seed it sets the cell up as a run does, drives the entry for
``--seconds`` (a closed loop, as in the window) and prints one JSON line
with the numbers that decide ``correct``: the program's against the
reference, and with ``--precision`` also the control's, the reference
computed one precision below the configuration's in the program's place,
against the reference in float32.  A training cell's line also explains
its numbers (the losses side by side, the leaves of the widest gaps).
``--fault`` plants a fault in the program (:func:`plant`)."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PACKAGE = Path(__file__).resolve().parent
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(PACKAGE / ".cache" / sub)
sys.path.insert(0, str(PACKAGE.parent))

import torch  # noqa: E402

from portbench.core.registry import Cell  # noqa: E402


def plant(fault: str) -> None:
    """A fault planted in the program for this process: 'unchanged', every
    Adam step leaves the state as it was; 'half', the Stage-2 step sees
    the first half of its batch only (the mean over those rows)."""
    if fault == "unchanged":
        torch.optim.Adam.step = lambda self, *a, **k: None
    elif fault == "half":
        from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer
        step = ClassifyTrainer.train_step

        def half(self, mri, x_cat, x_num, labels):
            n = mri.shape[0] // 2
            return step(self, mri[:n], x_cat[:n], x_num[:n], labels[:n])
        ClassifyTrainer.train_step = half


def readings(cell, seed: int, seconds: float, precision, device) -> dict:
    drv = cell.driver().Driver(cell, seed, device)
    t0 = time.perf_counter()
    drv.setup()
    end, n = time.perf_counter() + seconds, 0
    while True:
        drv.item(n)
        n += 1
        if time.perf_counter() >= end:
            break
    drv.release()
    out = {"seed": seed, "items": n,
           "setup_s": round(time.perf_counter() - t0, 3),
           "program": drv.check()}
    if precision:
        out["control"] = drv.control(precision)
    if hasattr(drv, "explained"):
        out["explained"] = drv.explained
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--precision", choices=("fp8", "tf32"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", choices=("unchanged", "half"))
    args = p.parse_args(argv)
    if args.fault:
        plant(args.fault)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.seconds, args.precision,
                                  args.device)), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
