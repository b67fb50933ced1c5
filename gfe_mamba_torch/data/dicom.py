"""A DICOM reader without pydicom, enough to stack an ADNI MR series
into a volume (counterpart of ``gfe_mamba_tpu/data/dicom.py``).

It reads what ADNI's structural MR uses: Part-10 files (or raw streams,
taken as implicit VR little-endian), explicit- or implicit-VR
little-endian, uncompressed PixelData, one slice per file.
``cli/dcm2nii.py`` prefers a ``dcm2niix`` binary on ``PATH`` and
otherwise uses this reader.  Big-endian and compressed transfer syntaxes
(JPEG, RLE) and multi-frame files raise ``ValueError``.  Host-only
(numpy and ``struct``).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# tag constants (group, elem)
_TS = (0x0002, 0x0010)
IMPLICIT_LE = "1.2.840.10008.1.2"
EXPLICIT_LE = "1.2.840.10008.1.2.1"

# VRs with a 2-byte reserved field + 4-byte length
_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN", b"OD", b"OL"}


@dataclass
class DicomSlice:
    rows: int = 0
    cols: int = 0
    bits_allocated: int = 16
    pixel_representation: int = 0
    rescale_slope: float = 1.0
    rescale_intercept: float = 0.0
    instance_number: int = 0
    series_uid: str = ""
    patient_id: str = ""
    study_date: str = ""
    position: Optional[np.ndarray] = None       # (3,) or None
    orientation: Optional[np.ndarray] = None    # (6,) or None
    pixel_spacing: tuple = (1.0, 1.0)
    slice_thickness: float = 1.0
    pixels: np.ndarray = field(default_factory=lambda: np.zeros((0, 0)))


def _read_exact(f, n):
    b = f.read(n)
    if len(b) != n:
        raise ValueError("truncated DICOM stream")
    return b


def _parse_elements(buf: memoryview, explicit: bool, want: dict,
                    stop_after_pixels: bool = True) -> dict:
    """Walk top-level data elements, collecting the tags in ``want``."""
    out = {}
    i = 0
    n = len(buf)
    while i + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, i)
        i += 4
        if explicit:
            vr = bytes(buf[i:i + 2])
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, i + 4)[0]
                i += 8
            else:
                length = struct.unpack_from("<H", buf, i + 2)[0]
                i += 4
        else:
            vr = b"UN"
            length = struct.unpack_from("<I", buf, i)[0]
            i += 4
        if length == 0xFFFFFFFF:
            if (group, elem) == (0x7FE0, 0x0010):
                raise ValueError("compressed (encapsulated) PixelData "
                                 "not supported")
            # undefined-length sequence: scan for its delimitation item
            # (FFFE,E0DD) -- none of the tags we collect live inside
            # sequences, so a byte scan is sufficient for this reader
            end = bytes(buf[i:]).find(b"\xfe\xff\xdd\xe0")
            if end < 0:
                break
            i += end + 8  # delimiter tag + zero length
            continue
        key = (group, elem)
        if key in want:
            out[key] = bytes(buf[i:i + length])
            if key == (0x7FE0, 0x0010) and stop_after_pixels:
                return out
        i += length
    return out


_WANT = {
    (0x0008, 0x0020): "study_date",
    (0x0010, 0x0020): "patient_id",
    (0x0020, 0x000E): "series_uid",
    (0x0020, 0x0013): "instance_number",
    (0x0020, 0x0032): "position",
    (0x0020, 0x0037): "orientation",
    (0x0028, 0x0010): "rows",
    (0x0028, 0x0011): "cols",
    (0x0028, 0x0030): "pixel_spacing",
    (0x0018, 0x0050): "slice_thickness",
    (0x0028, 0x0100): "bits_allocated",
    (0x0028, 0x0103): "pixel_representation",
    (0x0028, 0x1052): "rescale_intercept",
    (0x0028, 0x1053): "rescale_slope",
    (0x7FE0, 0x0010): "pixels",
}


def read_dicom(path: str) -> DicomSlice:
    """Parse one single-frame little-endian DICOM file."""
    with open(path, "rb") as f:
        head = f.read(132)
        if len(head) >= 132 and head[128:132] == b"DICM":
            data = f.read()
            # file meta group (group 0002): always explicit LE; walk it
            # element by element until the group changes
            ts = EXPLICIT_LE
            i = 0
            while i + 8 <= len(data):
                group, _elem = struct.unpack_from("<HH", data, i)
                if group != 0x0002:
                    break
                vr = data[i + 4:i + 6]
                if vr in _LONG_VRS:
                    length = struct.unpack_from("<I", data, i + 8)[0]
                    hdr = 12
                else:
                    length = struct.unpack_from("<H", data, i + 6)[0]
                    hdr = 8
                if (group, _elem) == _TS:
                    ts = data[i + hdr:i + hdr + length].decode(
                        "ascii", "ignore").strip("\x00 ")
                i += hdr + length
            body = data[i:]
        else:
            # raw (no preamble) -- assume implicit LE from the start
            f.seek(0)
            body = f.read()
            ts = IMPLICIT_LE
    if ts == IMPLICIT_LE:
        explicit = False
    elif ts == EXPLICIT_LE:
        explicit = True
    else:
        raise ValueError(f"unsupported transfer syntax {ts!r}")
    raw = _parse_elements(memoryview(body), explicit, _WANT)

    def txt(key, default=""):
        v = raw.get(key)
        return v.decode("ascii", "ignore").strip("\x00 ") if v else default

    def num(key, default=0.0):
        t = txt(key)
        try:
            return float(t)
        except ValueError:
            return default

    def us(key, default=0):
        v = raw.get(key)
        return struct.unpack("<H", v[:2])[0] if v and len(v) >= 2 else default

    sl = DicomSlice(
        rows=us((0x0028, 0x0010)), cols=us((0x0028, 0x0011)),
        bits_allocated=us((0x0028, 0x0100), 16),
        pixel_representation=us((0x0028, 0x0103), 0),
        rescale_slope=num((0x0028, 0x1053), 1.0) or 1.0,
        rescale_intercept=num((0x0028, 0x1052), 0.0),
        instance_number=int(num((0x0020, 0x0013), 0)),
        series_uid=txt((0x0020, 0x000E)),
        patient_id=txt((0x0010, 0x0020)),
        study_date=txt((0x0008, 0x0020)),
        slice_thickness=num((0x0018, 0x0050), 1.0) or 1.0,
    )
    pos = txt((0x0020, 0x0032))
    if pos:
        sl.position = np.asarray([float(x) for x in pos.split("\\")][:3])
    ori = txt((0x0020, 0x0037))
    if ori:
        sl.orientation = np.asarray([float(x) for x in ori.split("\\")][:6])
    spacing = txt((0x0028, 0x0030))
    if spacing:
        parts = [float(x) for x in spacing.split("\\")]
        sl.pixel_spacing = (parts[0], parts[1] if len(parts) > 1 else parts[0])

    pix = raw.get((0x7FE0, 0x0010))
    if pix is None:
        raise ValueError(f"no PixelData in {path}")
    if sl.bits_allocated == 16:
        dt = np.int16 if sl.pixel_representation else np.uint16
    elif sl.bits_allocated == 8:
        dt = np.int8 if sl.pixel_representation else np.uint8
    else:
        raise ValueError(f"unsupported bits_allocated {sl.bits_allocated}")
    need = sl.rows * sl.cols * np.dtype(dt).itemsize
    if len(pix) < need:
        raise ValueError(f"short PixelData in {path}")
    sl.pixels = np.frombuffer(pix[:need], dt).reshape(sl.rows, sl.cols)
    return sl


def stack_series(paths: list[str]):
    """Sort a series' single-slice files spatially and stack to a
    volume.  Returns (volume (rows, cols, nslices) float32, meta dict).

    Slice order: projection of ImagePositionPatient onto the slice
    normal (orientation row x col), falling back to InstanceNumber."""
    slices = [read_dicom(p) for p in paths]
    if not slices:
        raise ValueError("empty series")
    uid = slices[0].series_uid
    slices = [s for s in slices if s.series_uid == uid]

    normal = None
    if slices[0].orientation is not None:
        o = slices[0].orientation
        normal = np.cross(o[:3], o[3:])

    def key(s):
        if normal is not None and s.position is not None:
            return float(np.dot(s.position, normal))
        return float(s.instance_number)

    slices.sort(key=key)
    vol = np.stack([s.pixels.astype(np.float32) * s.rescale_slope
                    + s.rescale_intercept for s in slices], axis=-1)
    zs = [key(s) for s in slices]
    dz = (abs(zs[-1] - zs[0]) / (len(zs) - 1) if len(zs) > 1 and
          normal is not None and slices[0].position is not None
          else slices[0].slice_thickness)
    meta = {
        "patient_id": slices[0].patient_id,
        "study_date": slices[0].study_date,
        "series_uid": uid,
        "spacing": (*slices[0].pixel_spacing, dz or 1.0),
    }
    return vol, meta
