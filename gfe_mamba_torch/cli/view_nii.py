"""Slice-sheet viewer for NIfTI volumes (counterpart of
``tools/view_nii.py``; reference utils/manual_read_nii.py): every depth
slice of a volume in one PNG grid.

    python -m gfe_mamba_torch.cli.view_nii <volume.nii.gz> [--out out.png]
        [--normalize]

``--normalize`` clips to the 1st-99th percentile and maps it to [-1, 1]
before the grid maps [-1, 1] to grey.  Numpy only: no device is used.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from gfe_mamba_torch.data.nifti import load_nifti
from gfe_mamba_torch.utils.experiment import save_volume_grid


def main(args) -> str:
    """Write the grid; returns its path."""
    vol, hdr = load_nifti(args.volume)
    if vol.ndim > 3:
        vol = vol[..., 0]
    print(f"{args.volume}: shape={vol.shape} pixdim={hdr.pixdim} "
          f"range=[{vol.min():.2f}, {vol.max():.2f}]")
    if args.normalize:
        lo, hi = np.percentile(vol, [1, 99])
        vol = np.clip((vol - lo) / max(hi - lo, 1e-9), 0, 1) * 2 - 1
    out = args.out or os.path.basename(args.volume).split(".")[0] + ".png"
    save_volume_grid(vol, out, normalize=True)
    print(f"wrote {out}")
    return out


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("volume")
    parser.add_argument("--out", default="")
    parser.add_argument("--normalize", action="store_true")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
