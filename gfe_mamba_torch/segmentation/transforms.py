"""Volumetric augmentation library (reference augment/transforms.py; the
port's own copy of ``gfe_mamba_tpu/segmentation/transforms.py``, numpy
and scipy only).

Host-side numpy augmentations matching the reference's config-driven
factory (transforms.py:692-726): RandomFlip, RandomRotate90,
RandomRotate, RandomContrast, ElasticDeformation, CropToFixed,
Standardize, PercentileNormalizer, Normalize, AdditiveGaussianNoise,
AdditivePoissonNoise, ToTensor(-> float32), and the label -> boundary
transform.  All randomized transforms draw from an explicit
``np.random.Generator`` so pipelines are reproducible.

Arrays are channels-last (X, Y, Z[, C]).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class Transform:
    def __call__(self, m: np.ndarray) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


class Compose(Transform):
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __call__(self, m):
        for t in self.transforms:
            m = t(m)
        return m


class RandomFlip(Transform):
    """Flip each spatial axis with p=0.5 (transforms.py RandomFlip)."""

    def __init__(self, rng: np.random.Generator, axis_prob: float = 0.5):
        self.rng = rng
        self.axis_prob = axis_prob

    def __call__(self, m):
        for axis in range(3):
            if self.rng.random() < self.axis_prob:
                m = np.flip(m, axis)
        return np.ascontiguousarray(m)


class RandomRotate90(Transform):
    """Rotate k*90 degrees in the XY plane (transforms.py RandomRotate90)."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng

    def __call__(self, m):
        k = int(self.rng.integers(0, 4))
        return np.ascontiguousarray(np.rot90(m, k, axes=(0, 1)))


class RandomRotate(Transform):
    """Free-angle rotation via scipy (transforms.py RandomRotate)."""

    def __init__(self, rng: np.random.Generator, angle_spectrum: int = 30,
                 axes=None, mode: str = "reflect", order: int = 0):
        self.rng = rng
        self.angle_spectrum = angle_spectrum
        self.axes = axes or [(1, 0), (2, 1), (2, 0)]
        self.mode = mode
        self.order = order

    def __call__(self, m):
        from scipy.ndimage import rotate
        axis = self.axes[self.rng.integers(len(self.axes))]
        angle = self.rng.integers(-self.angle_spectrum, self.angle_spectrum)
        return rotate(m, angle, axes=axis, reshape=False, order=self.order,
                      mode=self.mode, cval=-1)


class RandomContrast(Transform):
    """mean + alpha * (x - mean) (transforms.py RandomContrast)."""

    def __init__(self, rng: np.random.Generator, alpha=(0.5, 1.5),
                 mean: float = 0.0, execution_probability: float = 0.1):
        self.rng = rng
        self.alpha = alpha
        self.mean = mean
        self.p = execution_probability

    def __call__(self, m):
        if self.rng.random() < self.p:
            alpha = self.rng.uniform(self.alpha[0], self.alpha[1])
            m = self.mean + alpha * (m - self.mean)
            return np.clip(m, -1, 1)
        return m


class ElasticDeformation(Transform):
    """Smoothed random displacement field (transforms.py:138-190)."""

    def __init__(self, rng: np.random.Generator, spline_order: int = 3,
                 alpha: float = 2000, sigma: float = 50,
                 execution_probability: float = 0.1):
        self.rng = rng
        self.spline_order = spline_order
        self.alpha = alpha
        self.sigma = sigma
        self.p = execution_probability

    def __call__(self, m):
        if self.rng.random() >= self.p:
            return m
        from scipy.ndimage import gaussian_filter, map_coordinates
        spatial = m.shape[:3]
        offsets = [
            gaussian_filter(self.rng.standard_normal(spatial), self.sigma,
                            mode="reflect") * self.alpha
            for _ in range(3)
        ]
        grid = np.meshgrid(*[np.arange(s) for s in spatial], indexing="ij")
        coords = [g + o for g, o in zip(grid, offsets)]
        if m.ndim == 3:
            return map_coordinates(m, coords, order=self.spline_order,
                                   mode="reflect")
        chans = [map_coordinates(m[..., c], coords, order=self.spline_order,
                                 mode="reflect") for c in range(m.shape[-1])]
        return np.stack(chans, axis=-1)


class CropToFixed(Transform):
    """Random (or centered) crop to a fixed size with padding as needed
    (transforms.py CropToFixed)."""

    def __init__(self, rng: np.random.Generator, size, centered: bool = False):
        self.rng = rng
        self.size = tuple(size)
        self.centered = centered

    def __call__(self, m):
        starts, pads = [], []
        for dim, want in zip(m.shape[:3], self.size):
            if dim <= want:
                starts.append(0)
                total = want - dim
                pads.append((total // 2, total - total // 2))
            else:
                max_start = dim - want
                start = (max_start // 2 if self.centered
                         else int(self.rng.integers(0, max_start + 1)))
                starts.append(start)
                pads.append((0, 0))
        sl = tuple(slice(s, s + w) for s, w in zip(starts, self.size))
        out = m[sl]
        if any(p != (0, 0) for p in pads):
            if m.ndim == 4:
                pads = pads + [(0, 0)]
            out = np.pad(out, pads, mode="reflect")
        return out


class Standardize(Transform):
    """(x - mean) / std (transforms.py:495-...)."""

    def __init__(self, mean: float | None = None, std: float | None = None,
                 eps: float = 1e-10):
        self.mean = mean
        self.std = std
        self.eps = eps

    def __call__(self, m):
        mean = self.mean if self.mean is not None else m.mean()
        std = self.std if self.std is not None else m.std()
        return (m - mean) / np.clip(std, self.eps, None)


class PercentileNormalizer(Transform):
    """Window [pmin, pmax] percentiles to [0, 1] (transforms.py)."""

    def __init__(self, pmin: float = 1, pmax: float = 99.6,
                 channel_wise: bool = False, eps: float = 1e-10):
        self.pmin = pmin
        self.pmax = pmax
        self.eps = eps

    def __call__(self, m):
        lo = np.percentile(m, self.pmin)
        hi = np.percentile(m, self.pmax)
        return (m - lo) / np.clip(hi - lo, self.eps, None)


class Normalize(Transform):
    """min-max to [-1, 1] or [0, 1] (transforms.py Normalize)."""

    def __init__(self, min_value: float | None = None,
                 max_value: float | None = None, norm01: bool = False,
                 eps: float = 1e-10):
        self.min_value = min_value
        self.max_value = max_value
        self.norm01 = norm01
        self.eps = eps

    def __call__(self, m):
        lo = self.min_value if self.min_value is not None else m.min()
        hi = self.max_value if self.max_value is not None else m.max()
        scaled = (m - lo) / np.clip(hi - lo, self.eps, None)
        return scaled if self.norm01 else 2 * scaled - 1


class AdditiveGaussianNoise(Transform):
    def __init__(self, rng: np.random.Generator, scale=(0.0, 1.0),
                 execution_probability: float = 0.1):
        self.rng = rng
        self.scale = scale
        self.p = execution_probability

    def __call__(self, m):
        if self.rng.random() < self.p:
            std = self.rng.uniform(self.scale[0], self.scale[1])
            return m + self.rng.normal(0, std, m.shape).astype(m.dtype)
        return m


class AdditivePoissonNoise(Transform):
    def __init__(self, rng: np.random.Generator, lam=(0.0, 1.0),
                 execution_probability: float = 0.1):
        self.rng = rng
        self.lam = lam
        self.p = execution_probability

    def __call__(self, m):
        if self.rng.random() < self.p:
            lam = self.rng.uniform(self.lam[0], self.lam[1])
            return m + self.rng.poisson(lam, m.shape).astype(m.dtype)
        return m


class ToTensor(Transform):
    """float32 + ensure trailing channel dim (transforms.py ToTensor,
    adapted to channels-last)."""

    def __init__(self, expand_dims: bool = True, dtype=np.float32):
        self.expand_dims = expand_dims
        self.dtype = dtype

    def __call__(self, m):
        m = np.asarray(m, self.dtype)
        if self.expand_dims and m.ndim == 3:
            m = m[..., None]
        return m


class StandardLabelToBoundary(Transform):
    """Label map -> boundary mask via erosion difference
    (transforms.py:250+ family, simplified: 6-connectivity)."""

    def __init__(self, append_label: bool = False):
        self.append_label = append_label

    def __call__(self, m):
        from scipy.ndimage import binary_erosion
        lab = np.asarray(m)
        squeeze = lab.ndim == 4
        if squeeze:
            lab = lab[..., 0]
        boundary = np.zeros_like(lab, bool)
        for v in np.unique(lab):
            if v == 0:
                continue
            mask = lab == v
            boundary |= mask & ~binary_erosion(mask)
        out = boundary.astype(np.float32)
        if self.append_label:
            return np.stack([out, lab.astype(np.float32)], axis=-1)
        return out[..., None] if squeeze else out


def _recover_ignore_index(out, lab, ignore_index):
    if ignore_index is not None:
        out = np.where(lab == ignore_index, ignore_index, out)
    return out


class _AffinityBase(Transform):
    """Shared machinery for the label->affinity family
    (ref pytorch3dunet/augment/transforms.py:250-311).

    An affinity channel for (axis, offset) marks voxels where the label
    differs from the label ``offset`` voxels away along that axis,
    computed as |convolve(m, k)| > 0 with a length-(offset+1) kernel
    [+1, 0, ..., -1] oriented along the axis (scipy 'reflect' edges,
    exactly the reference's operator).  Output is channels-LAST
    (repo convention) vs the reference's channel-first stack.
    """

    # kernel-orientation permutations for the X / Y / Z axes
    # (ref transforms.py:251-255 AXES_TRANSPOSE)
    AXES = ((0, 1, 2), (0, 2, 1), (2, 0, 1))

    def __init__(self, ignore_index=None, append_label=False,
                 aggregate_affinities=False):
        self.ignore_index = ignore_index
        self.append_label = append_label
        self.aggregate_affinities = aggregate_affinities

    @staticmethod
    def _kernel(axis_perm, offset):
        k = np.zeros((1, 1, offset + 1), np.int32)
        k[0, 0, 0] = 1
        k[0, 0, offset] = -1
        return np.transpose(k, axis_perm)

    def _kernels(self):
        raise NotImplementedError

    def __call__(self, m):
        from scipy.ndimage import convolve
        lab = np.asarray(m)
        assert lab.ndim == 3, "affinity transforms take a 3D label map"
        chans = np.stack([(np.abs(convolve(lab, k)) > 0).astype(np.int64)
                          for k in self._kernels()])
        if self.aggregate_affinities:
            assert len(chans) % 3 == 0, \
                "aggregation needs one kernel per axis per offset"
            results = [
                _recover_ignore_index(
                    np.logical_or.reduce(chans[i:i + 3]).astype(np.int64),
                    lab, self.ignore_index)
                for i in range(0, len(chans), 3)]
        else:
            results = [_recover_ignore_index(c, lab, self.ignore_index)
                       for c in chans]
        if self.append_label:
            results.append(lab)
        return np.stack(results, axis=-1).astype(np.float32)


class LabelToAffinities(_AffinityBase):
    """Label map -> per-(offset, axis) affinity channels
    (ref transforms.py:401-437): for every xy_offset (paired with a
    z_offset, default the same) emit X, Y, Z channels in that order;
    ``aggregate_affinities`` ORs the three axes of each offset."""

    def __init__(self, offsets, ignore_index=None, append_label=False,
                 aggregate_affinities=False, z_offsets=None):
        super().__init__(ignore_index, append_label, aggregate_affinities)
        offsets = tuple(offsets)
        assert all(a > 0 for a in offsets), "offsets must be positive"
        assert len(set(offsets)) == len(offsets), "offsets must be unique"
        z_offsets = tuple(z_offsets) if z_offsets is not None else offsets
        assert len(z_offsets) == len(offsets)
        self.kernels = [
            self._kernel(axis, z_off if axis_ind == 2 else xy_off)
            for xy_off, z_off in zip(offsets, z_offsets)
            for axis_ind, axis in enumerate(self.AXES)]

    def _kernels(self):
        return self.kernels


class LabelToZAffinities(_AffinityBase):
    """Z-axis-only affinity channels (ref transforms.py:440-461)."""

    def __init__(self, offsets, ignore_index=None, append_label=False):
        super().__init__(ignore_index, append_label)
        offsets = tuple(offsets)
        assert all(a > 0 for a in offsets) and \
            len(set(offsets)) == len(offsets)
        self.kernels = [self._kernel(self.AXES[2], o) for o in offsets]

    def _kernels(self):
        return self.kernels


class RandomLabelToAffinities(_AffinityBase):
    """Single random-(axis, offset) affinity channel per call — a
    boundary-thickness denoising scheme (ref transforms.py:373-398);
    z offsets are scaled down by ``z_offset_scale`` for anisotropy."""

    def __init__(self, rng, max_offset: int = 10, ignore_index=None,
                 append_label=False, z_offset_scale: int = 2):
        super().__init__(ignore_index, append_label,
                         aggregate_affinities=False)
        self.rng = rng
        self.offsets = tuple(range(1, max_offset + 1))
        self.z_offset_scale = z_offset_scale

    def _kernels(self):
        offset = int(self.rng.choice(self.offsets))
        axis_ind = int(self.rng.integers(3))
        if axis_ind == 2:
            offset = max(1, offset // self.z_offset_scale)
        return [self._kernel(self.AXES[axis_ind], offset)]


class LabelToBoundaryAndAffinities(Transform):
    """Boundary channel(s) + affinity channels, concatenated — trains
    boundary prediction with affinities as an auxiliary target
    (ref transforms.py:463-480).  ``blur`` gaussian-blurs only the
    boundary channel, never the affinities."""

    def __init__(self, xy_offsets, z_offsets, append_label=False,
                 blur=False, sigma=1, ignore_index=None,
                 foreground=False):
        self.l2b = StandardLabelToBoundary(append_label=False)
        self.blur, self.sigma = blur, sigma
        self.foreground = foreground
        self.l2a = LabelToAffinities(
            offsets=xy_offsets, z_offsets=z_offsets,
            append_label=append_label, ignore_index=ignore_index)

    def __call__(self, m):
        lab = np.asarray(m)
        boundary = self.l2b(lab)
        if boundary.ndim == 3:
            boundary = boundary[..., None]
        if self.blur:
            from scipy.ndimage import gaussian_filter
            boundary = gaussian_filter(
                boundary.astype(np.float32), sigma=self.sigma)
        parts = []
        if self.foreground:
            parts.append((lab > 0).astype(np.float32)[..., None])
        parts.append(np.asarray(boundary, np.float32))
        parts.append(self.l2a(lab))
        return np.concatenate(parts, axis=-1)


_TRANSFORMS = {
    "RandomFlip": RandomFlip,
    "RandomRotate90": RandomRotate90,
    "RandomRotate": RandomRotate,
    "RandomContrast": RandomContrast,
    "ElasticDeformation": ElasticDeformation,
    "CropToFixed": CropToFixed,
    "Standardize": Standardize,
    "PercentileNormalizer": PercentileNormalizer,
    "Normalize": Normalize,
    "AdditiveGaussianNoise": AdditiveGaussianNoise,
    "AdditivePoissonNoise": AdditivePoissonNoise,
    "ToTensor": ToTensor,
    "StandardLabelToBoundary": StandardLabelToBoundary,
    "LabelToAffinities": LabelToAffinities,
    "LabelToZAffinities": LabelToZAffinities,
    "RandomLabelToAffinities": RandomLabelToAffinities,
    "LabelToBoundaryAndAffinities": LabelToBoundaryAndAffinities,
}
_NEEDS_RNG = {"RandomFlip", "RandomRotate90", "RandomRotate",
              "RandomContrast", "ElasticDeformation", "CropToFixed",
              "AdditiveGaussianNoise", "AdditivePoissonNoise",
              "RandomLabelToAffinities"}


def build_transforms(spec: Sequence[dict], seed: int = 47) -> Compose:
    """Config-driven pipeline factory (transforms.py:692-726):
    [{'name': 'RandomFlip'}, {'name': 'ToTensor', ...}, ...]."""
    rng = np.random.default_rng(seed)
    out = []
    for item in spec:
        item = dict(item)
        name = item.pop("name")
        if name not in _TRANSFORMS:
            raise ValueError(f"unknown transform {name!r}")
        cls = _TRANSFORMS[name]
        if name in _NEEDS_RNG:
            out.append(cls(rng, **item))
        else:
            out.append(cls(**item))
    return Compose(out)
