"""The port's device-side volumetric ops (``ops/volumetric.py``) against
the JAX package's, on the CPU in f32, on the same numpy volumes.

Tolerances: 1e-6 relative to max(1, max |JAX|) for the windowing,
scaling and crop + resize (the same index math in f32); 1e-5 for
``resize_volume`` (separable weight matrices contracted in another
order); boxes exactly.  A downsampling ``resize_volume`` is held where
``jax.image.resize``'s antialiasing shows: there torch's
``F.interpolate`` lies far from JAX, the port within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gfe_mamba_tpu.ops import volumetric as jv
from gfe_mamba_torch.ops import volumetric as tv


def _close(got, want, rel):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= rel, err


def _volume(shape, seed, lo=-100.0, hi=4000.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


@pytest.mark.parametrize("case", ["mixed", "all_negative", "constant",
                                  "channel"])
def test_adaptive_normal_matches_jax(case):
    img = {"mixed": _volume((24, 20, 16), 0),
           "all_negative": -np.abs(_volume((8, 8, 6), 1)) - 1.0,
           "constant": np.full((8, 6, 4), 7.5, np.float32),
           "channel": _volume((12, 10, 8, 1), 2)}[case]
    want = jax.jit(jv.adaptive_normal)(jnp.asarray(img))
    got = tv.adaptive_normal(torch.from_numpy(img))
    _close(got, want, 1e-6)
    if case == "all_negative":
        np.testing.assert_array_equal(got.numpy(), -1.0)
    if case == "constant":
        np.testing.assert_array_equal(got.numpy(), 1.0)


def test_scale_intensity_range_matches_jax():
    img = _volume((6, 5, 4), 3, -2.0, 3.0)
    for clip in (True, False):
        _close(tv.scale_intensity_range(torch.from_numpy(img), -1.0, 2.0,
                                        0.0, 1.0, clip),
               jv.scale_intensity_range(jnp.asarray(img), -1.0, 2.0, 0.0,
                                        1.0, clip), 1e-6)


@pytest.mark.parametrize("shape,size,method", [
    ((24, 20, 16), (12, 10, 6), "linear"),          # downsampling
    ((10, 12, 6, 2), (16, 20, 9), "linear"),        # upsampling, channel
    ((2, 20, 15, 12, 1), (8, 15, 5), "linear"),     # batched, one axis kept
    ((17, 9, 8), (7, 12, 8), "cubic"),
    ((16, 12, 10), (5, 25, 7), "nearest"),
])
def test_resize_volume_matches_jax(shape, size, method):
    img = _volume(shape, 4, -1.0, 1.0)
    want = np.asarray(jv.resize_volume(jnp.asarray(img), size, method))
    got = tv.resize_volume(torch.from_numpy(img), size, method)
    _close(got, want, 1e-5)
    if shape == (24, 20, 16):
        # the antialias shows: a plain trilinear interpolation is far off
        plain = F.interpolate(torch.from_numpy(img)[None, None], size=size,
                              mode="trilinear", align_corners=False)[0, 0]
        assert np.abs(plain.numpy() - want).max() > 1e-2
    with pytest.raises(ValueError):
        tv.resize_volume(torch.zeros(2, 2, 3, 4, 5, 1), size)


def test_foreground_boxes_and_crops_match_jax():
    rng = np.random.RandomState(5)
    label = (rng.rand(12, 11, 10) > 0.95).astype(np.float32)
    label[0] = 0.0
    img = _volume((12, 11, 10), 6)
    for margin in (0, 2):
        start, stop = jv.foreground_bbox(label, margin=margin)
        got = tv.foreground_bbox(torch.from_numpy(label), margin=margin)
        np.testing.assert_array_equal(got[0].numpy(), start)
        np.testing.assert_array_equal(got[1].numpy(), stop)
    np.testing.assert_array_equal(
        tv.crop_foreground(torch.from_numpy(img), torch.from_numpy(label)),
        jv.crop_foreground(img, label))
    start_j, stop_j = jax.jit(jv.foreground_bbox_jax)(jnp.asarray(label))
    start_t, stop_t = tv.foreground_bbox_jax(torch.from_numpy(label))
    np.testing.assert_array_equal(start_t.numpy(), np.asarray(start_j))
    np.testing.assert_array_equal(stop_t.numpy(), np.asarray(stop_j))
    # an empty label: the whole volume, and a channel dim reduced
    empty = np.zeros((5, 6, 7, 2), np.float32)
    for fn_t, fn_j in ((tv.foreground_bbox, jv.foreground_bbox),
                       (tv.foreground_bbox_jax, jv.foreground_bbox_jax)):
        got, want = fn_t(torch.from_numpy(empty)), fn_j(empty)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_crop_resize_matches_jax():
    rng = np.random.RandomState(7)
    img = rng.rand(16, 14, 12, 2).astype(np.float32)
    label = np.zeros((16, 14, 12), np.float32)
    label[4:13, 2:10, 3:9] = 1.0
    for size in ((8, 8, 8), (20, 5, 9)):
        start, stop = jv.foreground_bbox_jax(jnp.asarray(label))
        want = jax.jit(jv.crop_resize, static_argnums=3)(
            jnp.asarray(img), start, stop, size)
        t_start, t_stop = tv.foreground_bbox_jax(torch.from_numpy(label))
        got = tv.crop_resize(torch.from_numpy(img), t_start, t_stop, size)
        _close(got, want, 1e-6)
    # a host box in a list gives the same
    _close(tv.crop_resize(torch.from_numpy(img), [4, 2, 3], [13, 10, 9],
                          (8, 8, 8)),
           jv.crop_resize(jnp.asarray(img), jnp.asarray([4, 2, 3]),
                          jnp.asarray([13, 10, 9]), (8, 8, 8)), 1e-6)
