"""ADNI DICOM -> NIfTI conversion and renaming (counterpart of
``tools/dcm2nii.py``; reference GEF-Mamba_ADNI_Dataset/dcm2nii).

Walks an ADNI download tree (``<root>/<PTID>/<sequence>/<date>/
<I-image-id>/``) or, with ``--flat``, converts one series directory.
Each series goes through the ``dcm2niix`` binary when one is on
``PATH``, else through ``data/dicom.py``'s reader and ``data/nifti.py``'s
writer.  Outputs are named ``PTID-YYYY_MM_DD_hh_mm_ss.0-LABEL.nii.gz``,
the names ``data/datasets.py::parse_classify_filename`` reads.

    python -m gfe_mamba_torch.cli.dcm2nii <adni_root> <out_dir> --label 1
    python -m gfe_mamba_torch.cli.dcm2nii <series_dir> <out_dir> --flat \
        --name sub1
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from glob import glob
from os.path import join

from gfe_mamba_torch.data.dicom import read_dicom, stack_series
from gfe_mamba_torch.data.nifti import save_nifti


def _dcm2niix() -> str | None:
    return shutil.which("dcm2niix")


def _series_files(series_dir: str) -> list[str]:
    return sorted(glob(join(series_dir, "*.dcm"))
                  + glob(join(series_dir, "*.DCM"))
                  + [p for p in glob(join(series_dir, "*"))
                     if os.path.isfile(p)
                     and "." not in os.path.basename(p)])


def convert_series(series_dir: str, out_path: str) -> dict:
    """One DICOM series directory -> one .nii.gz; returns the series'
    metadata and the converter used."""
    files = _series_files(series_dir)
    if not files:
        raise ValueError(f"no DICOM files in {series_dir}")
    binary = _dcm2niix()
    if binary:
        out_dir = os.path.dirname(out_path) or "."
        base = os.path.basename(out_path).replace(".nii.gz", "")
        subprocess.run([binary, "-z", "y", "-b", "n", "-f", base, "-o",
                        out_dir, series_dir],
                       check=True, capture_output=True, timeout=600)
        first = read_dicom(files[0])
        return {"patient_id": first.patient_id,
                "study_date": first.study_date, "converter": "dcm2niix"}
    vol, meta = stack_series(files)
    save_nifti(out_path, vol, pixdim=meta["spacing"])
    meta["converter"] = "python"
    return meta


def _adni_walk(root: str):
    """``(ptid, date directory, series directory)`` for every
    ``<root>/<PTID>/<sequence>/<date>/<I-image-id>/`` below ``root``."""
    for dirpath, dirnames, _ in os.walk(root):
        for d in dirnames:
            if d.startswith("I") and d[1:].replace("-", "").isdigit():
                series = join(dirpath, d)
                parts = os.path.normpath(series).split(os.sep)
                if len(parts) >= 4:
                    yield parts[-4], parts[-2], series


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input", help="ADNI root (or one series dir w/ --flat)")
    ap.add_argument("out_dir")
    ap.add_argument("--label", type=int, default=1,
                    help="conversion label appended to filenames")
    ap.add_argument("--flat", action="store_true",
                    help="input is a single series directory")
    ap.add_argument("--name", default="subject",
                    help="PTID stem for --flat mode")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    if args.flat:
        out = join(args.out_dir, f"{args.name}-{args.label}.nii.gz")
        meta = convert_series(args.input, out)
        print(f"{args.input} -> {out} [{meta['converter']}]")
        return

    n_ok = n_fail = 0
    for ptid, date, series in _adni_walk(args.input):
        out = join(args.out_dir,
                   f"{ptid}-{date.replace('-', '_')}-{args.label}.nii.gz")
        if os.path.exists(out):
            continue
        try:
            meta = convert_series(series, out)
        except (ValueError, subprocess.SubprocessError, OSError) as exc:
            print(f"FAIL {series}: {exc}", file=sys.stderr)
            n_fail += 1
            continue
        n_ok += 1
        print(f"{series} -> {os.path.basename(out)} [{meta['converter']}]")
    print(f"done: {n_ok} converted, {n_fail} failed")


if __name__ == "__main__":
    main()
