"""The port's 2D DSB2018 data and prediction (``data/png.py``,
``segmentation/dsb.py``, ``segmentation/predictor.py::dsb_predict``) and
its DICOM path (``data/dicom.py``, ``cli/dcm2nii.py``) against PIL, h5py
and the JAX package's counterparts, on the CPU.

Everything here is exact: pixels, greyscale conversions, dataset items,
HDF5 datasets, DICOM slices and NIfTI volumes must be equal.  The PNGs
are written by this file's encoder, which cycles each image's rows
through the five row filters, in every colour type the reader takes.
"""

import os
import struct
import sys
import zlib

import numpy as np
import pytest

from gfe_mamba_torch.data import h5, png
from gfe_mamba_torch.data.nifti import load_nifti

_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_png(path, pixels, colour, palette=None, interlace=0, depth=8):
    """``pixels`` (H, W, samples) uint8 as a PNG whose row y takes filter
    y % 5."""
    h, w, bpp = pixels.shape
    lines, prior = [], np.zeros(w * bpp, np.int32)
    for y in range(h):
        cur = pixels[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        kind = y % 5
        pred = [np.zeros_like(cur), left, prior, (left + prior) >> 1,
                _paeth(left, prior, upleft)][kind]
        lines.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prior = cur
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    body = _chunk(b"IHDR", header)
    if palette is not None:
        body += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    body += _chunk(b"IDAT", zlib.compress(b"".join(lines), 6))
    with open(path, "wb") as f:
        f.write(png.SIGNATURE + body + _chunk(b"IEND", b""))


def _image(colour, shape=(13, 17), seed=0):
    rng = np.random.RandomState(seed)
    if colour == 3:
        palette = rng.randint(0, 256, (7, 3))
        return rng.randint(0, 7, shape + (1,)).astype(np.uint8), palette
    return rng.randint(0, 256, shape + (_SAMPLES[colour],)).astype(
        np.uint8), None


@pytest.mark.parametrize("colour", [0, 2, 3, 4, 6])
def test_png_reader_matches_pil(tmp_path, colour):
    Image = pytest.importorskip("PIL.Image")
    pixels, palette = _image(colour, seed=colour)
    path = str(tmp_path / f"c{colour}.png")
    write_png(path, pixels, colour, palette)
    got, kind, got_palette = png.read_png(path)
    assert kind == colour
    np.testing.assert_array_equal(got, pixels)
    with Image.open(path) as im:
        raw = np.asarray(im)
        grey = np.asarray(im.convert("L"))
    np.testing.assert_array_equal(got.reshape(raw.shape), raw)
    np.testing.assert_array_equal(png.load_grey(path), grey)
    if colour == 3:
        np.testing.assert_array_equal(got_palette, palette)


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    pixels, _ = _image(0)
    path = str(tmp_path / "i.png")
    write_png(path, pixels, 0, interlace=1)
    with pytest.raises(ValueError, match="Adam7"):
        png.read_png(path)
    write_png(path, pixels, 0, depth=16)
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(path)
    with open(path, "wb") as f:
        f.write(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(path)


def _dsb_tree(root, n=3):
    """DSB2018's layout: RGBA images, greyscale masks, one image without
    a mask."""
    os.makedirs(root / "images")
    os.makedirs(root / "masks")
    for i in range(n):
        pixels, _ = _image(6, (16, 12), seed=10 + i)
        write_png(str(root / "images" / f"im{i}.png"), pixels, 6)
        if i < n - 1:
            mask = (_image(0, (16, 12), seed=20 + i)[0] > 127) * 255
            write_png(str(root / "masks" / f"im{i}.png"),
                      mask.astype(np.uint8), 0)


@pytest.mark.parametrize("phase", ["train", "test"])
def test_dsb_dataset_matches_jax(tmp_path, phase):
    pytest.importorskip("PIL.Image")
    from gfe_mamba_tpu.segmentation.dsb import DSB2018Dataset as JaxDSB
    from gfe_mamba_torch.segmentation.dsb import DSB2018Dataset

    _dsb_tree(tmp_path)
    spec = [{"name": "RandomFlip"}, {"name": "RandomRotate90"},
            {"name": "ToTensor", "expand_dims": False}]
    for config in (None, spec):
        port = DSB2018Dataset(str(tmp_path), phase, config, seed=3)
        ref = JaxDSB(str(tmp_path), phase, config, seed=3)
        assert len(port) == len(ref) == 3
        for i in range(len(ref)):
            got, want = port[i], ref[i]
            assert sorted(got) == sorted(want)
            assert got["name"] == want["name"]
            for key in ("raw", "label"):
                if key in want:
                    assert got[key].dtype == want[key].dtype
                    np.testing.assert_array_equal(got[key], want[key])
        assert ("label" in port[0]) == (phase == "train")


def test_dsb_predict_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    from gfe_mamba_tpu.segmentation.predictor import \
        dsb_predict as jax_dsb_predict
    from gfe_mamba_torch.segmentation.predictor import dsb_predict

    rng = np.random.RandomState(4)
    single = rng.rand(12, 10, 1).astype(np.float32)
    batch = rng.rand(2, 12, 10, 1).astype(np.float32)

    def items(root):
        return [(single, str(root / "a.png")),
                (batch, [str(root / "b.png"), str(root / "c.png")])]

    def predict(x):
        return 1.0 / (1.0 + np.exp(-8.0 * (x - 0.5)))

    written = {}
    for tag, fn in (("port", dsb_predict), ("jax", jax_dsb_predict)):
        out = tmp_path / tag
        out.mkdir()
        written[tag] = fn(predict, items(tmp_path), str(out))
    assert [os.path.basename(p) for p in written["port"]] == \
        [os.path.basename(p) for p in written["jax"]] == \
        ["a_predictions.h5", "b_predictions.h5", "c_predictions.h5"]
    for mine, theirs in zip(written["port"], written["jax"]):
        with h5py.File(mine, "r") as f, h5py.File(theirs, "r") as g:
            assert sorted(f) == sorted(g) == ["predictions", "segmentation"]
            for name in f:
                assert f[name].dtype == g[name].dtype
                assert f[name].compression == "gzip"
                np.testing.assert_array_equal(f[name][...], g[name][...])
        # and the port's reader takes h5py's file
        np.testing.assert_array_equal(h5.read(theirs, "segmentation"),
                                      h5.read(mine, "segmentation"))
    assert dsb_predict(predict, [(single, str(tmp_path / "d.png"))],
                       str(tmp_path), save_segmentation=False)
    assert h5.File(str(tmp_path / "d_predictions.h5")).keys() == \
        ["predictions"]
    with pytest.raises(ValueError, match="one path per batch item"):
        dsb_predict(predict, [(batch, str(tmp_path / "e.png"))])


@pytest.mark.parametrize("explicit", [True, False])
def test_read_dicom_matches_jax(tmp_path, explicit):
    from gfe_mamba_tpu.data.dicom import read_dicom as jax_read_dicom
    from gfe_mamba_torch.data.dicom import read_dicom
    from test_dicom import write_dicom

    px = np.random.default_rng(0).integers(-500, 2000, (16, 12)).astype(
        np.int16)
    path = str(tmp_path / "a.dcm")
    write_dicom(path, px, explicit=explicit, position=(1.0, -2.0, 3.5))
    got, want = read_dicom(path), jax_read_dicom(path)
    for field in ("rows", "cols", "bits_allocated", "pixel_representation",
                  "rescale_slope", "rescale_intercept", "instance_number",
                  "series_uid", "patient_id", "study_date", "pixel_spacing",
                  "slice_thickness"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("position", "orientation", "pixels"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    np.testing.assert_array_equal(got.pixels, px)


@pytest.mark.parametrize("explicit", [True, False])
def test_stack_series_matches_jax(tmp_path, explicit):
    from gfe_mamba_tpu.data.dicom import stack_series as jax_stack_series
    from gfe_mamba_torch.data.dicom import stack_series
    from test_dicom import write_dicom

    rng = np.random.default_rng(1)
    vols = rng.integers(0, 100, (4, 8, 6)).astype(np.int16)
    for i, z in enumerate((2.5, 0.0, 7.5, 5.0)):
        write_dicom(str(tmp_path / f"s{i}.dcm"), vols[i], explicit=explicit,
                    position=(0, 0, z), instance=99 - i)
    # a slice of another series is left out
    write_dicom(str(tmp_path / "other.dcm"), vols[0], series="9.9",
                explicit=explicit)
    paths = sorted(str(tmp_path / f) for f in os.listdir(tmp_path))
    paths.remove(str(tmp_path / "other.dcm"))
    paths.append(str(tmp_path / "other.dcm"))
    (vol, meta), (want_vol, want_meta) = stack_series(paths), \
        jax_stack_series(paths)
    assert vol.dtype == want_vol.dtype and meta == want_meta
    np.testing.assert_array_equal(vol, want_vol)
    assert vol.shape == (8, 6, 4)


def test_dcm2nii_matches_the_jax_tool(tmp_path, monkeypatch):
    """Both drivers on one ADNI-shaped tree with no ``dcm2niix`` on
    PATH: the same file names and the same volumes and spacings."""
    import tools.dcm2nii as jax_d2n
    from gfe_mamba_torch.cli import dcm2nii
    from gfe_mamba_torch.data.datasets import parse_classify_filename
    from test_dicom import write_dicom

    monkeypatch.setenv("PATH", str(tmp_path / "empty_bin"))
    assert dcm2nii._dcm2niix() is None and jax_d2n._dcm2niix() is None
    rng = np.random.default_rng(2)
    for ptid, date, image in (("123_S_4567", "2024-01-31_09_10_11.0",
                               "I123456"),
                              ("002_S_0001", "2019-05-02_10_00_00.0",
                               "I77")):
        series = tmp_path / "adni" / ptid / "MPRAGE" / date / image
        series.mkdir(parents=True)
        for i in range(3):
            write_dicom(str(series / f"{i}.dcm"),
                        rng.integers(0, 500, (10, 9)).astype(np.int16),
                        ptid=ptid, position=(0, 0, 1.5 * i),
                        instance=i + 1)
    # one series without a DICOM file fails on both sides
    (tmp_path / "adni" / "003_S_0002" / "MPRAGE" / "2020-01-01_00_00_00.0"
     / "I5").mkdir(parents=True)

    dcm2nii.main([str(tmp_path / "adni"), str(tmp_path / "port"),
                  "--label", "0"])
    monkeypatch.setattr(sys, "argv", ["dcm2nii.py", str(tmp_path / "adni"),
                                      str(tmp_path / "jax"), "--label",
                                      "0"])
    jax_d2n.main()
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "002_S_0001-2019_05_02_10_00_00.0-0.nii.gz",
        "123_S_4567-2024_01_31_09_10_11.0-0.nii.gz"]
    for name in names:
        got, got_hdr = load_nifti(str(tmp_path / "port" / name))
        want, want_hdr = load_nifti(str(tmp_path / "jax" / name))
        np.testing.assert_array_equal(got, want)
        assert got.shape == (10, 9, 3)
        np.testing.assert_array_equal(got_hdr.pixdim, want_hdr.pixdim)
        assert parse_classify_filename(name)[2] == 0

    # --flat on one series
    series = tmp_path / "adni" / "002_S_0001" / "MPRAGE" / \
        "2019-05-02_10_00_00.0" / "I77"
    dcm2nii.main([str(series), str(tmp_path / "flat"), "--flat", "--name",
                  "sub1"])
    flat, _ = load_nifti(str(tmp_path / "flat" / "sub1-1.nii.gz"))
    np.testing.assert_array_equal(
        flat, load_nifti(str(tmp_path / "port" / names[0]))[0])
