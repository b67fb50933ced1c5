"""The port's segmentation data layer on the CPU: the nested YAML reader
against PyYAML, ``data/h5.py`` both ways against h5py (each skipped
where the package is missing: the card's machine has neither), and the
slicers, transforms, HDF5 datasets and both sliding-window predictors
against the JAX package's on the same inputs.

The numpy parts are copies, so they are held to equality; the
predictors are given one numpy predict function on both sides, so their
outputs are equal too (the same f32 sums in the same order).
"""

import os

import numpy as np
import pytest

from gfe_mamba_tpu.segmentation import hdf5 as jax_hdf5
from gfe_mamba_tpu.segmentation import predictor as jax_predictor
from gfe_mamba_tpu.segmentation import slicers as jax_slicers
from gfe_mamba_tpu.segmentation import transforms as jax_transforms
from gfe_mamba_torch.config import (load_nested_config, parse_nested_yaml,
                                    parse_value)
from gfe_mamba_torch.data import h5
from gfe_mamba_torch.segmentation import hdf5, predictor, slicers, transforms

CONFIG = """
# a pytorch3dunet-style config
manual_seed: 0
model:
  name: UNet3D
  in_channels: 1
  out_channels: 2
  layer_order: gcr
  f_maps: [32, 64, 128]
  final_sigmoid: false
  is_segmentation: yes
trainer:
  checkpoint_dir: 'runs/ckpt'
  resume: null
  validate_after_iters: 1000
  eval_score_higher_is_better: True
optimizer:
  learning_rate: 2.0e-4
  weight_decay: 0.00001
loss:
  name: CrossEntropyLoss
  ignore_index: -1
lr_scheduler:
  kwargs: {}
loaders:
  dataset: lazy
  batch_size: 2
  raw_internal_path: /raw
  train:
    file_paths:
      - data/train
      - "data/extra.h5"
    slice_builder:
      name: FilterSliceBuilder
      patch_shape: [80, 170, 170]
      stride_shape: [20, 40, 40]
      threshold: 0.6
    transformer:
      - name: Standardize
      - name: RandomRotate
        axes: [[2, 1], [1, 0]]
        angle_spectrum: 45   # degrees
        mode: reflect
      - name: ToTensor
        expand_dims: true
  val:
    file_paths:
    - data/val
    slice_builder:
      patch_shape: [80, 170, 170]
      stride_shape: [80, 170, 170]
"""


def _yaml():
    return pytest.importorskip("yaml")


@pytest.mark.parametrize("text", [
    CONFIG.replace("kwargs: {}", "kwargs:"),
    "- a\n- - 1\n  - [2, [3, 4]]\n- b: 1\n  c:\n  - x\n  d: ~\n",
    "top:\n  deeper:\n    deepest:\n      - 1.5\n      - '2'\n  next: off\n",
])
def test_nested_yaml_reads_what_pyyaml_reads(text):
    assert parse_nested_yaml(text) == _yaml().safe_load(text)


@pytest.mark.parametrize("bad", [
    "a: &anchor 1\n", "a: *alias\n", "a: !!str 1\n", "a: |\n  block\n",
    "a: >\n  folded\n", "a: plain\n  continued\n", "a: {b: 1}\n",
    "a:\n  - 1\n b: 2\n"])
def test_nested_yaml_refuses_what_it_does_not_read(bad):
    with pytest.raises(ValueError):
        parse_nested_yaml(bad)


def test_overrides_as_the_jax_script(tmp_path):
    """``load_nested_config``'s overrides against ``seg_train.py``'s
    ``load_nested_config`` (PyYAML)."""
    _yaml()
    from seg_train import load_nested_config as jax_load
    path = tmp_path / "c.yaml"
    path.write_text(CONFIG.replace("kwargs: {}", "kwargs:"))
    overrides = ["trainer.max_num_iterations=7", "model.f_maps=[8, 16]",
                 "loaders.train.slice_builder.name='SliceBuilder'",
                 "new.branch.key=1e-3", "model.final_sigmoid=true",
                 "trainer.resume="]
    assert load_nested_config(str(path), overrides) == jax_load(
        str(path), overrides)
    assert parse_value(" [1, 'a', 2.5] ") == [1, "a", 2.5]


# ---------------------------------------------------------------------------
# data/h5.py

_ARRAYS = {
    "f32_4d": np.random.RandomState(0).rand(2, 9, 14, 11).astype(np.float32),
    "f64_2d": np.random.RandomState(1).randn(5, 7),
    "u8_3d": np.random.RandomState(2).randint(0, 4, (9, 20, 6)).astype(
        np.uint8),
    "i16_3d": np.random.RandomState(3).randint(-300, 300, (3, 4, 5)).astype(
        np.int16),
    "i64_1d": np.arange(-4, 13, dtype=np.int64),
    "f16_3d": np.random.RandomState(4).rand(4, 5, 6).astype(np.float16),
    "u32_3d": np.random.RandomState(5).randint(0, 2 ** 31, (4, 4, 4)).astype(
        np.uint32),
}
_LAYOUTS = [dict(), dict(compression="gzip"),
            dict(compression="gzip", shuffle=True)]


@pytest.mark.parametrize("layout", _LAYOUTS, ids=["contiguous", "gzip",
                                                  "gzip+shuffle"])
def test_h5_reads_what_h5py_writes(tmp_path, layout):
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / "a.h5")
    with h5py.File(path, "w") as f:
        for name, value in _ARRAYS.items():
            f.create_dataset(name, data=value, **layout)
        f.create_group("sub").create_dataset("raw", data=_ARRAYS["u8_3d"])
    with h5.File(path) as f:
        assert f.keys() == sorted([*_ARRAYS, "sub"])
        for name, value in _ARRAYS.items():
            got = f[name][...]
            assert got.dtype == value.dtype and np.array_equal(got, value)
        box = f["f32_4d"][1, 2:7, :, 3:4]
        assert np.array_equal(box, _ARRAYS["f32_4d"][1, 2:7, :, 3:4])
        assert np.array_equal(f["/sub/raw"][...], _ARRAYS["u8_3d"])
        assert "sub/raw" in f and "nothing" not in f


@pytest.mark.parametrize("compression", [None, "gzip"])
def test_h5py_reads_what_h5_writes(tmp_path, compression):
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / "b.h5")
    h5.write(path, _ARRAYS, compression=compression)
    with h5py.File(path, "r") as f:
        assert sorted(f) == sorted(_ARRAYS)
        for name, value in _ARRAYS.items():
            got = f[name][...]
            assert got.dtype == value.dtype and np.array_equal(got, value)
            assert f[name].compression == compression
            if compression:
                assert f[name].chunks == h5.guess_chunk(value.shape,
                                                        value.itemsize)
                assert f[name].compression_opts == 4


def test_h5_writes_many_chunks_and_many_datasets(tmp_path):
    """More chunks than one B-tree node holds (a two-level chunk B-tree)
    and 20 datasets (three symbol-table nodes), read back by h5py and by
    the reader."""
    h5py = pytest.importorskip("h5py")
    big = np.random.RandomState(6).rand(1, 64, 96, 96).astype(np.float32)
    many = {f"d{i:02d}": np.full((2, 3), i, np.int32) for i in range(20)}
    path = str(tmp_path / "c.h5")
    h5.write(path, {"big": big, **many})
    with h5py.File(path, "r") as f:
        assert np.array_equal(f["big"][...], big)
        grid = [len(range(0, n, c)) for n, c in zip(big.shape,
                                                     f["big"].chunks)]
        assert np.prod(grid) > 2 * h5.CHUNK_K
        assert all(np.array_equal(f[k][...], v) for k, v in many.items())
    with h5.File(path) as f:
        assert np.array_equal(f["big"][0, 5:30, 40:90, 1:2],
                              big[0, 5:30, 40:90, 1:2])


def test_h5_refuses_what_is_outside_its_subset(tmp_path):
    h5py = pytest.importorskip("h5py")
    cases = {
        "latest": (dict(libver="latest"), "raw", dict()),
        "bigendian": ({}, "raw", dict(dtype=">f4")),
        "compound": ({}, "raw", dict(dtype=[("a", "<f4"), ("b", "<i4")])),
        "fletcher32": ({}, "raw", dict(fletcher32=True)),
        "lzf": ({}, "raw", dict(compression="lzf")),
    }
    expect = {"latest": "superblock version", "bigendian": "big-endian",
              "compound": "compound", "fletcher32": "filter 3",
              "lzf": "filter 32000"}
    for name, (file_kw, dset, kw) in cases.items():
        path = str(tmp_path / f"{name}.h5")
        with h5py.File(path, "w", **file_kw) as f:
            f.create_dataset(dset, shape=(4, 4, 4), **kw)
        with pytest.raises(h5.H5Unsupported, match=expect[name]):
            with h5.File(path) as f:
                f[dset][...]
    (tmp_path / "plain.h5").write_bytes(b"not an hdf5 file" * 8)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        h5.File(str(tmp_path / "plain.h5"))
    with pytest.raises(h5.H5Unsupported):
        h5.write(str(tmp_path / "x.h5"), {"c": np.zeros(3, np.complex64)})


# ---------------------------------------------------------------------------
# slicers, transforms, datasets, predictors


def test_slicers_match_jax():
    label = (np.random.RandomState(7).rand(20, 18, 16) > 0.7).astype(
        np.float32)
    for args in [((20, 18, 16), (8, 8, 8), (4, 5, 8)),
                 ((20, 18, 16, 2), (20, 9, 5), (1, 9, 3))]:
        assert slicers.SliceBuilder(*args).raw_slices == \
            jax_slicers.SliceBuilder(*args).raw_slices
    kw = dict(label=label, threshold=0.25, slack_acceptance=0.3, seed=3)
    got = slicers.FilterSliceBuilder((20, 18, 16), (6, 6, 6), (3, 3, 3), **kw)
    want = jax_slicers.FilterSliceBuilder((20, 18, 16), (6, 6, 6), (3, 3, 3),
                                          **kw)
    every = slicers.SliceBuilder((20, 18, 16), (6, 6, 6), (3, 3, 3))
    assert got.raw_slices == want.raw_slices
    assert 0 < len(got) < len(every)


_PIPELINE = [
    {"name": "Standardize"}, {"name": "RandomFlip"},
    {"name": "RandomRotate90"},
    {"name": "RandomRotate", "axes": [[1, 0]], "angle_spectrum": 20},
    {"name": "RandomContrast", "execution_probability": 1.0},
    {"name": "ElasticDeformation", "execution_probability": 1.0,
     "sigma": 3, "alpha": 5, "spline_order": 1},
    {"name": "AdditiveGaussianNoise", "execution_probability": 1.0},
    {"name": "AdditivePoissonNoise", "execution_probability": 1.0},
    {"name": "CropToFixed", "size": [10, 9, 12]},
    {"name": "PercentileNormalizer"}, {"name": "Normalize"},
    {"name": "ToTensor", "expand_dims": True}]


def test_transforms_match_jax_with_the_same_seed():
    vol = np.random.RandomState(8).rand(12, 12, 10).astype(np.float32)
    got = transforms.build_transforms(_PIPELINE, seed=5)
    want = jax_transforms.build_transforms(_PIPELINE, seed=5)
    for _ in range(2):
        np.testing.assert_array_equal(got(vol), want(vol))
    lab = np.zeros((8, 8, 6), np.int64)
    lab[1:4, 2:6, 1:5], lab[5:8, 1:3, 2:6] = 1, 2
    for spec in ([{"name": "StandardLabelToBoundary", "append_label": True}],
                 [{"name": "LabelToAffinities", "offsets": [1, 2]}],
                 [{"name": "LabelToZAffinities", "offsets": [1]}],
                 [{"name": "RandomLabelToAffinities", "max_offset": 3}],
                 [{"name": "LabelToBoundaryAndAffinities", "xy_offsets": [1],
                   "z_offsets": [1], "foreground": True}]):
        np.testing.assert_array_equal(
            transforms.build_transforms(spec, 2)(lab),
            jax_transforms.build_transforms(spec, 2)(lab))


def _volumes(root, h5py):
    """Two files: a 4D raw (C, X, Y, Z) with a 3D label, written by the
    port; a 3D raw, written by h5py (gzip) where it is installed."""
    rng = np.random.RandomState(9)
    raw4 = rng.rand(2, 12, 10, 9).astype(np.float32)
    raw3 = rng.rand(12, 10, 9).astype(np.float32)
    label = (raw3 > 0.5).astype(np.uint8)
    os.makedirs(root)
    h5.write(os.path.join(root, "a.h5"), {"raw": raw4, "label": label})
    with h5py.File(os.path.join(root, "b.hdf5"), "w") as f:
        f.create_dataset("raw", data=raw3, compression="gzip")
        f.create_dataset("label", data=label, compression="gzip")
    return [os.path.join(root, "a.h5"), os.path.join(root, "b.hdf5")]


@pytest.mark.parametrize("lazy", [False, True])
def test_hdf5_dataset_matches_jax(tmp_path, lazy):
    h5py = pytest.importorskip("h5py")
    paths = _volumes(str(tmp_path / "vols"), h5py)
    assert hdf5.traverse_h5_paths([str(tmp_path / "vols")]) == \
        jax_hdf5.traverse_h5_paths([str(tmp_path / "vols")]) == paths
    sb = {"name": "FilterSliceBuilder", "patch_shape": [6, 5, 4],
          "stride_shape": [3, 5, 4], "threshold": 0.4,
          "slack_acceptance": 0.5}
    spec = [{"name": "RandomFlip"}, {"name": "Standardize"}]
    for path in paths:
        for phase in ("train", "test"):
            got = hdf5.HDF5Dataset(path, phase, sb, spec, lazy=lazy)
            want = jax_hdf5.HDF5Dataset(path, phase, sb, spec, lazy=lazy)
            assert len(got) == len(want) > 0
            for i in range(len(got)):
                a, b = got[i], want[i]
                assert sorted(a) == sorted(b)
                for key in a:
                    np.testing.assert_array_equal(a[key], b[key])


def _predict(x: np.ndarray) -> np.ndarray:
    return np.concatenate([np.tanh(x[..., :1] * 2.0) + x.mean(),
                           x[..., -1:] ** 2], axis=-1)


def test_predictors_match_jax(tmp_path):
    """Both predictors with a halo, on a 4D volume, and the saved files."""
    h5py = pytest.importorskip("h5py")
    vol = np.random.RandomState(10).rand(14, 12, 10, 2).astype(np.float32)
    kw = dict(halo_shape=(2, 1, 2), out_channels=2, batch_size=3)
    args = (vol, (6, 6, 5), (4, 3, 5))
    want = jax_predictor.sliding_window_predict(_predict, *args, **kw)
    got = predictor.sliding_window_predict(_predict, *args, **kw)
    np.testing.assert_array_equal(got, want)
    paths = [str(tmp_path / f"{n}.h5") for n in ("jax", "port")]
    jax_predictor.sliding_window_predict_lazy(_predict, *args, paths[0], **kw)
    predictor.sliding_window_predict_lazy(_predict, *args, paths[1], **kw)
    assert sorted(os.listdir(tmp_path)) == ["jax.h5", "port.h5"]
    with h5py.File(paths[0]) as a, h5py.File(paths[1]) as b:
        assert sorted(a) == sorted(b) == ["predictions"]
        np.testing.assert_array_equal(a["predictions"][...],
                                      b["predictions"][...])
        assert a["predictions"].chunks == b["predictions"].chunks
    jax_hdf5.save_predictions_h5(paths[0], want)
    hdf5.save_predictions_h5(paths[1], got)
    np.testing.assert_array_equal(h5.read(paths[1], "predictions"),
                                  h5.read(paths[0], "predictions"))
    seg = predictor.pmaps_to_segmentation(got[..., 0], 0.9)
    np.testing.assert_array_equal(
        seg, jax_predictor.pmaps_to_segmentation(want[..., 0], 0.9))
