"""Minimal, dependency-free NIfTI-1 I/O (.nii / .nii.gz); a copy of
``gfe_mamba_tpu/data/nifti.py``.

Replaces the reference's nibabel/MONAI ``LoadImaged`` dependency
(threed_loader.py:55, pic_table_loader.py:51) with a self-contained
NIfTI-1 codec: 348-byte header parse (both endiannesses), scl_slope /
scl_inter scaling, Fortran-order data layout, gzip containers.  A C++
accelerated decode path (``data/native.py``) is used when the
shared library has been built; this module is the always-available
reference implementation and fallback.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass

import numpy as np

# NIfTI-1 datatype codes -> numpy dtypes
_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
    1024: np.int64, 1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HEADER_SIZE = 348


@dataclass
class NiftiHeader:
    shape: tuple
    dtype: np.dtype
    pixdim: tuple
    vox_offset: int
    scl_slope: float
    scl_inter: float
    affine: np.ndarray
    byteorder: str


def _read_bytes(path: str) -> bytes:
    if str(path).endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def parse_header(raw: bytes) -> NiftiHeader:
    if len(raw) < HEADER_SIZE:
        raise ValueError("file too small to be NIfTI-1")
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    bo = "<"
    if sizeof_hdr != HEADER_SIZE:
        (sizeof_hdr,) = struct.unpack_from(">i", raw, 0)
        if sizeof_hdr != HEADER_SIZE:
            raise ValueError("not a NIfTI-1 file (bad sizeof_hdr)")
        bo = ">"
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"bad NIfTI magic {magic!r}")

    dim = struct.unpack_from(f"{bo}8h", raw, 40)
    ndim = int(dim[0])
    if not 1 <= ndim <= 7:
        raise ValueError(f"bad ndim {ndim}")
    shape = tuple(int(d) for d in dim[1:1 + ndim])
    (datatype,) = struct.unpack_from(f"{bo}h", raw, 70)
    if datatype not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype code {datatype}")
    pixdim = struct.unpack_from(f"{bo}8f", raw, 76)
    (vox_offset,) = struct.unpack_from(f"{bo}f", raw, 108)
    scl_slope, scl_inter = struct.unpack_from(f"{bo}2f", raw, 112)
    srow = np.array(struct.unpack_from(f"{bo}12f", raw, 280),
                    dtype=np.float32).reshape(3, 4)
    affine = np.eye(4, dtype=np.float32)
    if np.any(srow):
        affine[:3] = srow
    else:
        affine[0, 0], affine[1, 1], affine[2, 2] = pixdim[1:4]
    return NiftiHeader(
        shape=shape, dtype=np.dtype(_DTYPES[datatype]),
        pixdim=tuple(pixdim[1:1 + ndim]), vox_offset=int(vox_offset),
        scl_slope=float(scl_slope), scl_inter=float(scl_inter),
        affine=affine, byteorder=bo,
    )


def load_nifti(path: str, *, dtype=np.float32, scaled: bool = True):
    """Load a .nii/.nii.gz volume -> (array, header).

    The array is Fortran-order reshaped (x fastest), matching
    nibabel's ``get_fdata`` layout, and scl_slope/inter scaled when
    present (scaled=True)."""
    raw = _read_bytes(path)
    hdr = parse_header(raw)
    count = int(np.prod(hdr.shape))
    arr_dtype = hdr.dtype.newbyteorder(hdr.byteorder)
    data = np.frombuffer(raw, dtype=arr_dtype, count=count,
                         offset=hdr.vox_offset)
    arr = np.asarray(data).reshape(hdr.shape, order="F").astype(dtype)
    if scaled and hdr.scl_slope not in (0.0, 1.0):
        arr = arr * hdr.scl_slope + hdr.scl_inter
    elif scaled and hdr.scl_inter not in (0.0,):
        arr = arr + hdr.scl_inter
    return arr, hdr


def save_nifti(path: str, array: np.ndarray, *, pixdim=None,
               affine: np.ndarray | None = None) -> None:
    """Write ``array`` as a NIfTI-1 single file (.nii or .nii.gz)."""
    array = np.asarray(array)
    code = _DTYPE_CODES.get(array.dtype)
    if code is None:
        array = array.astype(np.float32)
        code = _DTYPE_CODES[np.dtype(np.float32)]
    ndim = array.ndim
    if ndim > 7:
        raise ValueError("too many dims for NIfTI")
    hdr = bytearray(HEADER_SIZE + 4)  # +4: extension flag
    struct.pack_into("<i", hdr, 0, HEADER_SIZE)
    dim = [ndim] + list(array.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, array.dtype.itemsize * 8)  # bitpix
    pd = [1.0] * 8
    if pixdim is not None:
        for i, p in enumerate(pixdim):
            pd[i + 1] = float(p)
    struct.pack_into("<8f", hdr, 76, *pd)
    struct.pack_into("<f", hdr, 108, float(HEADER_SIZE + 4))  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # slope, inter
    if affine is None:
        affine = np.eye(4, dtype=np.float32)
        affine[0, 0], affine[1, 1], affine[2, 2] = pd[1], pd[2], pd[3]
    struct.pack_into("<h", hdr, 252, 1)  # qform_code... keep sform
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<12f", hdr, 280, *np.asarray(affine[:3], np.float32).ravel())
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + array.tobytes(order="F")
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=4) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)
