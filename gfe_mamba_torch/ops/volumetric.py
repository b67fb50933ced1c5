"""Volumetric preprocessing on the device (counterpart of
``gfe_mamba_tpu/ops/volumetric.py``; reference
dataloader/threed_loader.py:55-66, utils/data_normalization.py:20-48).

* ``adaptive_normal``: percentile windowing to [-1, 1];
* ``scale_intensity_range``: MONAI ScaleIntensityRanged;
* ``resize_volume``: ``jax.image.resize`` of the spatial dims (its
  separable kernels, antialiased when downsampling, through
  ``ops/conv3d.py``'s twin; not ``F.interpolate``, which does not
  antialias);
* ``foreground_bbox`` / ``crop_foreground``: MONAI CropForegroundd's box
  and crop (the crop's shape depends on the data, so it reads the box on
  the host);
* ``foreground_bbox_jax`` and ``crop_resize``: the box as device tensors
  and a crop + half-pixel linear resize that takes it without a host
  sync, so a data-dependent crop and resize stay on the card (the names
  are the JAX package's).

Every function takes tensors on any device (numpy arrays are moved to
the CPU); the spatial dims lead, with or without a trailing channel dim
(``resize_volume`` also takes a leading batch dim).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from gfe_mamba_torch.ops.conv3d import interpolate_to


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(x)


def adaptive_normal(img, min_p: float = 0.001,
                    max_p: float = 0.999) -> torch.Tensor:
    """Window [v(min_p), v(max_p)] of the non-negative voxels mapped
    affinely to [-1, 1] and clipped, v(p) the sorted non-negative values
    at index floor((n - 1) p + 0.5) computed in f32 (negatives go to +inf
    before one full sort, so its first n entries are the non-negative
    voxels in order).  With no non-negative voxel or a constant window
    the image passes through, clipped."""
    img = _tensor(img)
    flat = img.reshape(-1)
    keep = flat >= 0
    n = keep.sum()
    ordered = torch.sort(torch.where(keep, flat, torch.inf)).values

    def pick(p):
        idx = torch.floor((n - 1).to(torch.float32) * p + 0.5).long()
        return ordered[torch.clamp(idx, 0, n - 1)]

    lo, hi = pick(min_p), pick(max_p)
    mean, stddev = (hi + lo) / 2.0, (hi - lo) / 2.0
    ok = (n > 0) & (stddev > 0)
    out = torch.where(ok, (img - mean) / torch.where(stddev > 0, stddev,
                                                       1.0), img)
    return torch.clamp(out, -1.0, 1.0)


def scale_intensity_range(img, a_min: float, a_max: float, b_min: float,
                          b_max: float, clip: bool = True) -> torch.Tensor:
    """MONAI ScaleIntensityRanged: [a_min, a_max] -> [b_min, b_max]."""
    out = (_tensor(img) - a_min) / (a_max - a_min) * (b_max - b_min) + b_min
    return torch.clamp(out, b_min, b_max) if clip else out


def resize_volume(img, spatial_size: Sequence[int],
                  method: str = "linear") -> torch.Tensor:
    """The leading spatial dims of ``(X, Y, Z)``, ``(X, Y, Z, C)`` or
    ``(B, X, Y, Z, C)`` resized to ``spatial_size`` as
    ``jax.image.resize`` computes it ('nearest': the input sample
    floor((i + 0.5) in / out); the other methods its kernels, antialiased
    on downsampling)."""
    img = _tensor(img)
    spatial_size = tuple(spatial_size)
    k = len(spatial_size)
    if img.dim() not in (k, k + 1, k + 2):
        raise ValueError(f"cannot resize shape {tuple(img.shape)} to "
                         f"{spatial_size}")
    x = img
    if img.dim() == k:
        x = x[..., None]
    if img.dim() < k + 2:
        x = x[None]
    if method == "nearest":
        for axis, size in enumerate(spatial_size, start=1):
            n = x.shape[axis]
            if n != size:
                idx = torch.floor((torch.arange(size, dtype=torch.float32)
                                   + 0.5) * n / size).long()
                x = torch.index_select(x, axis, idx.to(x.device))
    else:
        x = interpolate_to(x, spatial_size, method)
    if img.dim() < k + 2:
        x = x[0]
    return x[..., 0] if img.dim() == k else x


def _box(mask: torch.Tensor):
    """Per spatial axis of ``mask`` (any trailing dims beyond the third
    reduced), the first index with a true voxel and one past the last,
    as device tensors; ``(0, n)`` on an axis of an empty mask."""
    spatial = min(mask.dim(), 3)
    if mask.dim() > spatial:
        mask = mask.reshape(*mask.shape[:spatial], -1).any(-1)
    starts, stops = [], []
    for axis in range(spatial):
        other = tuple(a for a in range(spatial) if a != axis)
        line = mask.any(dim=other) if other else mask
        n = line.shape[0]
        idx = torch.arange(n, device=mask.device)
        found = line.any()
        starts.append(torch.where(
            found, torch.where(line, idx, n).min(), 0))
        stops.append(torch.where(
            found, torch.where(line, idx, -1).max() + 1, n))
    return torch.stack(starts), torch.stack(stops)


def foreground_bbox_jax(label, threshold: float = 0.0):
    """The box of the voxels of ``label`` above ``threshold`` as device
    tensors ``(start, stop)`` (no host sync), for :func:`crop_resize`."""
    return _box(_tensor(label) > threshold)


def foreground_bbox(label, select_fn: Callable = lambda x: x > 0,
                    margin: int = 0):
    """MONAI CropForegroundd's box (``select_fn`` picks the foreground),
    widened by ``margin`` and kept inside the volume; the whole volume when
    nothing is selected.  ``(start, stop)`` int64 tensors on the label's
    device."""
    mask = select_fn(_tensor(label))
    start, stop = _box(mask)
    if margin:
        spatial = torch.tensor(mask.shape[:len(start)], device=stop.device)
        found = mask.any()
        start = torch.where(found, torch.clamp(start - margin, min=0), start)
        stop = torch.where(found, torch.minimum(stop + margin, spatial),
                           stop)
    return start, stop


def crop_foreground(img, label,
                    select_fn: Callable = lambda x: x > 0) -> torch.Tensor:
    """``img`` cropped to :func:`foreground_bbox` of ``label`` (the
    box's ends are read on the host: the crop's shape depends on them)."""
    start, stop = foreground_bbox(label, select_fn)
    return _tensor(img)[tuple(slice(a, b) for a, b in
                              zip(start.tolist(), stop.tolist()))]


def _linear_resample_axis(x: torch.Tensor, axis: int, out_size: int,
                          lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """One axis resampled linearly from the window [lo, hi) (0-dim int
    tensors) to ``out_size`` samples at half-pixel centres, each centre
    clamped into the window, in f32.  The scale is a true division by a
    tensor on x's device (CUDA divides by a host scalar through its
    reciprocal, which moves the centres by an ulp of their magnitude),
    filled there so that nothing is copied from the host."""
    lo_f, last = lo.to(torch.float32), (hi - 1).to(torch.float32)
    scale = (hi - lo).to(torch.float32) / torch.full(
        (), float(out_size), device=x.device)
    centers = (torch.arange(out_size, dtype=torch.float32, device=x.device)
               + 0.5) * scale - 0.5 + lo_f
    centers = torch.minimum(torch.maximum(centers, lo_f), last)
    i0 = torch.floor(centers).long()
    i1 = torch.minimum(i0 + 1, hi - 1)
    frac = (centers - i0.to(torch.float32)).reshape(
        [out_size if a == axis else 1 for a in range(x.dim())])
    return (torch.index_select(x, axis, i0) * (1.0 - frac)
            + torch.index_select(x, axis, i1) * frac)


def crop_resize(img, start, stop,
                spatial_size: Sequence[int]) -> torch.Tensor:
    """``img`` cropped to [start, stop) on its leading spatial dims and
    resized linearly to ``spatial_size`` (half-pixel centres clamped to
    the window: the crop then the resize, exactly) in one chain of
    gathers; ``start`` / ``stop`` may be device tensors, and are never
    read on the host."""
    img = _tensor(img)
    start = torch.as_tensor(start, device=img.device)
    stop = torch.as_tensor(stop, device=img.device)
    out = img
    for axis, size in enumerate(spatial_size):
        out = _linear_resample_axis(out, axis, size, start[axis],
                                    stop[axis])
    return out
