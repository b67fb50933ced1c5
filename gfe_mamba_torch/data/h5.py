"""HDF5 files without h5py: the subset that h5py writes by default.

Read: superblock version 0 or 1, version-1 object headers (with their
continuation blocks), groups as symbol tables (a version-1 B-tree of
symbol-table nodes over a local heap), and datasets whose dataspace is
simple, whose type is a little-endian integer or IEEE float, and whose
layout (message version 3) is contiguous, compact, or chunked (a
version-1 chunk B-tree) with the deflate and shuffle filters.  Anything
else raises ``H5Unsupported``, naming what it met.

Write: a new file of datasets at the root group, each contiguous or chunked
with gzip (deflate at h5py's default level 4), its chunk shape h5py's
``guess_chunk``. h5py opens what this writes.  Chunks are compressed and
written one at a time, so a dataset given as an ``np.memmap`` never sits in
memory whole.

All multi-byte fields are little-endian; offsets and lengths are 8 bytes.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Mapping

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
# B-tree fan-out this writer uses and HDF5's defaults assume (superblock
# version 0 stores the two group values; the chunk value is the
# library's default for files whose superblock does not store it)
GROUP_LEAF_K, GROUP_NODE_K, CHUNK_K = 4, 16, 32

# message types
_NIL, _DATASPACE, _DATATYPE, _FILL_OLD, _FILL = 0x0, 0x1, 0x3, 0x4, 0x5
_LINK, _EXTERNAL, _LAYOUT, _FILTERS = 0x6, 0x7, 0x8, 0xB
_CONTINUATION, _SYMBOL_TABLE = 0x10, 0x11
# messages that carry nothing a reader of the data needs
_IGNORED = {_NIL, _FILL_OLD, _FILL, 0x2, 0xA, 0xC, 0xD, 0xE, 0x12, 0x13,
            0x14, 0x15, 0x16, 0x17}
_DEFLATE, _SHUFFLE = 1, 2


class H5Unsupported(ValueError):
    """The file uses an HDF5 feature outside the supported subset."""


def _u(buf, off: int, n: int) -> int:
    return int.from_bytes(buf[off:off + n], "little")


# ---------------------------------------------------------------------------
# reading


class Dataset:
    """A dataset of an open :class:`File`: ``shape``, ``dtype``, ``ndim``,
    ``chunks``, and ``[...]`` / ``[slices]`` reading only the chunks a
    box of basic slices touches."""

    def __init__(self, file: "File", name: str, shape, dtype, layout,
                 filters):
        self.file, self.name = file, name
        self.shape, self.dtype = tuple(shape), dtype
        self.layout, self.filters = layout, filters
        self.chunks = tuple(layout["chunk"]) if layout["kind"] == 2 \
            else None

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def _box(self, key):
        if key is Ellipsis:
            key = ()
        if not isinstance(key, tuple):
            key = (key,)
        if any(k is Ellipsis for k in key):
            i = next(j for j, k in enumerate(key) if k is Ellipsis)
            key = key[:i] + (slice(None),) * (self.ndim - len(key) + 1) \
                + key[i + 1:]
        key = key + (slice(None),) * (self.ndim - len(key))
        box, squeeze = [], []
        for axis, (k, n) in enumerate(zip(key, self.shape)):
            if isinstance(k, slice):
                start, stop, step = k.indices(n)
                if step != 1:
                    raise H5Unsupported("strided reads")
                box.append((start, max(start, stop)))
            else:
                k = int(k) + (n if int(k) < 0 else 0)
                if not 0 <= k < n:
                    raise IndexError(f"index {k} out of range {n}")
                box.append((k, k + 1))
                squeeze.append(axis)
        return box, tuple(squeeze)

    def __getitem__(self, key) -> np.ndarray:
        box, squeeze = self._box(key)
        out = np.zeros([b - a for a, b in box], self.dtype)
        kind = self.layout["kind"]
        if kind == 2:
            self._read_chunks(box, out)
        else:
            whole = self._whole()
            out[...] = whole[tuple(slice(a, b) for a, b in box)]
        return out.squeeze(squeeze) if squeeze else out

    def _whole(self) -> np.ndarray:
        """The dataset as an array (compact) or a read-only memory map
        (contiguous: a box reads only its pages)."""
        if self.layout["kind"] == 0:
            return np.frombuffer(self.layout["data"], self.dtype,
                                 math.prod(self.shape)).reshape(self.shape)
        if self.layout["address"] == UNDEF or not math.prod(self.shape):
            return np.zeros(self.shape, self.dtype)
        return np.memmap(self.file.path, self.dtype, "r",
                         offset=self.layout["address"], shape=self.shape)

    def _read_chunks(self, box, out: np.ndarray) -> None:
        chunk = self.chunks
        for offset, nbytes, mask, address in self.file.chunk_index(
                self.layout["btree"], len(chunk) + 1):
            lo = [max(a, o) for (a, _), o in zip(box, offset)]
            hi = [min(b, o + c) for (_, b), o, c in zip(box, offset, chunk)]
            if any(h <= l for l, h in zip(lo, hi)):
                continue
            raw = self.file.read(address, nbytes)
            data = _unfilter(raw, self.filters, mask, self.dtype.itemsize)
            block = np.frombuffer(data, self.dtype,
                                  math.prod(chunk)).reshape(chunk)
            src = tuple(slice(l - o, h - o)
                        for l, h, o in zip(lo, hi, offset))
            dst = tuple(slice(l - a, h - a)
                        for l, h, (a, _) in zip(lo, hi, box))
            out[dst] = block[src]


def _unfilter(raw: bytes, filters, mask: int, itemsize: int) -> bytes:
    """Undo a chunk's filters, last first; bit i of ``mask`` set means
    filter i was skipped for this chunk."""
    for i in reversed(range(len(filters))):
        if mask >> i & 1:
            continue
        fid = filters[i]
        if fid == _DEFLATE:
            raw = zlib.decompress(raw)
        elif fid == _SHUFFLE:
            arr = np.frombuffer(raw, np.uint8)
            n = len(arr) // itemsize
            body = arr[:n * itemsize].reshape(itemsize, n).T.reshape(-1)
            raw = body.tobytes() + arr[n * itemsize:].tobytes()
    return raw


class File:
    """An HDF5 file opened for reading (the subset of the module
    docstring): ``name in f``, ``f[name]`` (a :class:`Dataset`; ``a/b``
    paths through subgroups), ``f.keys()``.  Use as a context manager."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        try:
            self._root = self._superblock()
        except BaseException:
            self._fh.close()
            raise

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        self._fh.close()

    def read(self, address: int, n: int) -> bytes:
        self._fh.seek(address)
        data = self._fh.read(n)
        if len(data) != n:
            raise ValueError(f"{self.path}: truncated at {address}")
        return data

    def _superblock(self) -> int:
        head = self.read(0, 24)
        if head[:8] != SIGNATURE:
            raise ValueError(f"{self.path}: not an HDF5 file (no signature "
                             f"at offset 0)")
        version = head[8]
        if version not in (0, 1):
            raise H5Unsupported(f"superblock version {version} (files "
                                f"written with libver 'latest')")
        if head[13] != 8 or head[14] != 8:
            raise H5Unsupported(f"{head[13]}-byte offsets / {head[14]}-byte "
                                f"lengths")
        at = 24 + (4 if version == 1 else 0)
        base = _u(self.read(at, 8), 0, 8)
        if base != 0:
            raise H5Unsupported(f"base address {base}")
        entry = self.read(at + 32, 40)
        return _u(entry, 8, 8)

    # object headers -------------------------------------------------------

    def messages(self, address: int) -> list[tuple[int, bytes]]:
        """(type, data) of each message of the version-1 object header at
        ``address``, continuation blocks followed."""
        head = self.read(address, 16)
        if head[0] != 1:
            raise H5Unsupported(f"object header version {head[0]} at "
                                f"{address} (libver 'latest')")
        count, size = _u(head, 2, 2), _u(head, 8, 4)
        blocks, out = [(address + 16, size)], []
        while blocks and len(out) < count:
            start, length = blocks.pop(0)
            buf, pos = self.read(start, length), 0
            while pos + 8 <= length and len(out) < count:
                mtype, msize, flags = _u(buf, pos, 2), _u(buf, pos + 2, 2), \
                    buf[pos + 4]
                data = buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if flags & 0x2:
                    raise H5Unsupported(f"shared message of type {mtype:#x}")
                if mtype == _CONTINUATION:
                    blocks.append((_u(data, 0, 8), _u(data, 8, 8)))
                out.append((mtype, data))
        return out

    # groups ---------------------------------------------------------------

    def _group(self, address: int) -> dict[str, int]:
        """name -> object header address of a group's members."""
        for mtype, data in self.messages(address):
            if mtype == _SYMBOL_TABLE:
                return self._symbols(_u(data, 0, 8), _u(data, 8, 8))
            if mtype == _LINK:
                raise H5Unsupported("link messages (new-style groups)")
        raise H5Unsupported(f"object at {address} is not a symbol-table "
                            f"group")

    def _symbols(self, btree: int, heap: int) -> dict[str, int]:
        head = self.read(heap, 32)
        if head[:4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {heap}")
        names = self.read(_u(head, 24, 8), _u(head, 8, 8))
        out = {}
        for snod in self._btree_children(btree, 0, 8):
            node = self.read(snod, 8)
            if node[:4] != b"SNOD":
                raise ValueError(f"{self.path}: no symbol node at {snod}")
            entries = self.read(snod + 8, 40 * _u(node, 6, 2))
            for e in range(_u(node, 6, 2)):
                off = _u(entries, 40 * e, 8)
                name = names[off:names.index(b"\0", off)].decode()
                out[name] = _u(entries, 40 * e + 8, 8)
        return out

    def _btree_nodes(self, address: int, node_type: int, key_size: int):
        """(level, keys, children) of every node of a version-1 B-tree,
        leaves included."""
        head = self.read(address, 24)
        if head[:4] != b"TREE" or head[4] != node_type:
            raise ValueError(f"{self.path}: no type-{node_type} B-tree "
                             f"node at {address}")
        level, used = head[5], _u(head, 6, 2)
        body = self.read(address + 24, used * (key_size + 8) + key_size)
        keys = [body[i * (key_size + 8):i * (key_size + 8) + key_size]
                for i in range(used + 1)]
        kids = [_u(body, i * (key_size + 8) + key_size, 8)
                for i in range(used)]
        yield level, keys, kids
        if level:
            for kid in kids:
                yield from self._btree_nodes(kid, node_type, key_size)

    def _btree_children(self, address: int, node_type: int, key_size: int):
        for level, _, kids in self._btree_nodes(address, node_type,
                                                key_size):
            if level == 0:
                yield from kids

    def chunk_index(self, btree: int, rank1: int):
        """(offset, nbytes, filter mask, address) of every chunk of a
        chunked dataset of rank ``rank1 - 1``."""
        key_size = 8 + 8 * rank1
        for level, keys, kids in self._btree_nodes(btree, 1, key_size):
            if level:
                continue
            for key, kid in zip(keys, kids):
                offset = [_u(key, 8 + 8 * d, 8) for d in range(rank1 - 1)]
                yield offset, _u(key, 0, 4), _u(key, 4, 4), kid

    # datasets -------------------------------------------------------------

    def _resolve(self, name: str) -> int:
        address = self._root
        for part in [p for p in name.split("/") if p]:
            members = self._group(address)
            if part not in members:
                raise KeyError(f"{self.path}: no object {name!r}")
            address = members[part]
        return address

    def __contains__(self, name: str) -> bool:
        try:
            self._resolve(name)
        except KeyError:
            return False
        return True

    def keys(self) -> list[str]:
        return sorted(self._group(self._root))

    def __getitem__(self, name: str) -> Dataset:
        msgs = self.messages(self._resolve(name))
        shape = dtype = layout = None
        filters = []
        for mtype, data in msgs:
            if mtype == _DATASPACE:
                shape = _dataspace(data)
            elif mtype == _DATATYPE:
                dtype = _datatype(data)
            elif mtype == _LAYOUT:
                layout = _layout(data)
            elif mtype == _FILTERS:
                filters = _filters(data)
            elif mtype == _EXTERNAL:
                raise H5Unsupported("external data files")
            elif mtype == _SYMBOL_TABLE:
                raise KeyError(f"{self.path}: {name!r} is a group")
            elif mtype not in _IGNORED and mtype != _CONTINUATION:
                raise H5Unsupported(f"header message type {mtype:#x} in "
                                    f"{name!r}")
        if shape is None or dtype is None or layout is None:
            raise ValueError(f"{self.path}: {name!r} is not a dataset")
        if filters and layout["kind"] != 2:
            raise H5Unsupported("filters on an unchunked dataset")
        return Dataset(self, name, shape, dtype, layout, filters)


def _dataspace(data: bytes) -> tuple[int, ...]:
    version, rank, flags = data[0], data[1], data[2]
    if version == 1:
        at = 8
    elif version == 2:
        if data[3] != 1:
            raise H5Unsupported(f"dataspace type {data[3]} (not simple)")
        at = 4
    else:
        raise H5Unsupported(f"dataspace message version {version}")
    if flags & 0x2:
        raise H5Unsupported("dataspace permutation")
    return tuple(_u(data, at + 8 * i, 8) for i in range(rank))


def _datatype(data: bytes) -> np.dtype:
    cls, version = data[0] & 0x0F, data[0] >> 4
    bits, size = _u(data, 1, 3), _u(data, 4, 4)
    if version != 1:
        raise H5Unsupported(f"datatype message version {version}")
    if bits & 0x1:
        raise H5Unsupported("big-endian data")
    if cls == 0 and size in (1, 2, 4, 8):
        return np.dtype(f"<{'i' if bits & 0x8 else 'u'}{size}")
    if cls == 1 and size in (2, 4, 8) and not bits & 0x40:
        return np.dtype(f"<f{size}")
    names = {0: "integer", 1: "float", 2: "time", 3: "string",
             4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
             8: "enum", 9: "variable-length", 10: "array"}
    raise H5Unsupported(f"{names.get(cls, cls)} datatype of {size} bytes")


def _layout(data: bytes) -> dict:
    if data[0] != 3:
        raise H5Unsupported(f"data layout message version {data[0]}")
    kind = data[1]
    if kind == 0:
        size = _u(data, 2, 2)
        return dict(kind=0, data=data[4:4 + size])
    if kind == 1:
        return dict(kind=1, address=_u(data, 2, 8), size=_u(data, 10, 8))
    if kind == 2:
        rank1 = data[2]
        dims = [_u(data, 11 + 4 * i, 4) for i in range(rank1)]
        return dict(kind=2, btree=_u(data, 3, 8), chunk=dims[:-1])
    raise H5Unsupported(f"layout class {kind}")


def _filters(data: bytes) -> list[int]:
    version, count = data[0], data[1]
    if version not in (1, 2):
        raise H5Unsupported(f"filter pipeline message version {version}")
    pos, out = (8 if version == 1 else 2), []
    for _ in range(count):
        fid = _u(data, pos, 2)
        has_name = version == 1 or fid >= 256
        name_len = _u(data, pos + 2, 2) if has_name else 0
        pos += 4 if has_name else 2
        nvals = _u(data, pos + 2, 2)
        pos += 4
        pos += -(-name_len // 8) * 8 if version == 1 else name_len
        pos += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
        if fid not in (_DEFLATE, _SHUFFLE):
            raise H5Unsupported(f"filter {fid} (only deflate and shuffle)")
        out.append(fid)
    return out


def read(path: str, name: str) -> np.ndarray:
    """The whole dataset ``name`` of the file at ``path``."""
    with File(path) as f:
        return f[name][...]


# ---------------------------------------------------------------------------
# writing

CHUNK_BASE, CHUNK_MIN, CHUNK_MAX = 16 * 1024, 8 * 1024, 1024 * 1024
GZIP_LEVEL = 4


def guess_chunk(shape, itemsize: int) -> tuple[int, ...]:
    """h5py's chunk shape for ``chunks=True`` (``filters.guess_chunk``):
    halve the axes in turn until a chunk is near a target size that grows
    with the dataset's, between 8 KiB and 1 MiB."""
    chunks = np.array([x if x else 1024 for x in shape], dtype="=f8")
    size = math.prod(chunks) * itemsize
    target = CHUNK_BASE * 2 ** math.log10(size / (1024.0 * 1024))
    target = min(max(target, CHUNK_MIN), CHUNK_MAX)
    idx = 0
    while True:
        chunk_bytes = math.prod(chunks) * itemsize
        if (chunk_bytes < target or abs(chunk_bytes - target) / target
                < 0.5) and chunk_bytes < CHUNK_MAX:
            break
        if math.prod(chunks) == 1:
            break
        chunks[idx % len(shape)] = math.ceil(chunks[idx % len(shape)] / 2.0)
        idx += 1
    return tuple(int(x) for x in chunks)


def _message(mtype: int, data: bytes) -> bytes:
    data += b"\0" * (-len(data) % 8)
    return struct.pack("<HHB3x", mtype, len(data), 0) + data


def _object_header(messages: list[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _dtype_message(dtype: np.dtype) -> bytes:
    dtype = np.dtype(dtype)
    if dtype.kind in "iu" and dtype.itemsize in (1, 2, 4, 8):
        bits = 0x8 if dtype.kind == "i" else 0
        return struct.pack("<B3sIHH", 0x10, bits.to_bytes(3, "little"),
                           dtype.itemsize, 0, 8 * dtype.itemsize)
    spec = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}
    if dtype.kind == "f" and dtype.itemsize in spec:
        eloc, esize, msize, bias = spec[dtype.itemsize]
        nbits = 8 * dtype.itemsize
        bits = 0x20 | (nbits - 1) << 8
        return struct.pack("<B3sIHHBBBBI", 0x11, bits.to_bytes(3, "little"),
                           dtype.itemsize, 0, nbits, eloc, esize, 0, msize,
                           bias)
    raise H5Unsupported(f"cannot write dtype {dtype}")


def _dataspace_message(shape) -> bytes:
    return struct.pack("<BBB5x", 1, len(shape), 0) + b"".join(
        struct.pack("<Q", n) for n in shape)


def _deflate_message() -> bytes:
    """A filter pipeline (version 1) of deflate at ``GZIP_LEVEL``."""
    return struct.pack("<BB6xHHHH", 1, 1, _DEFLATE, 8, 1, 1) + b"deflate\0" \
        + struct.pack("<I4x", GZIP_LEVEL)


class _Writer:
    def __init__(self, fh):
        self.fh = fh

    def tell(self) -> int:
        return self.fh.tell()

    def put(self, data: bytes) -> int:
        at = self.fh.tell()
        self.fh.write(data)
        return at

    def btree_node(self, node_type: int, level: int, keys: list[bytes],
                   kids: list[int], capacity: int) -> int:
        """One version-1 B-tree node, allocated for ``capacity`` children
        (HDF5 reads a node at its full size)."""
        key_size = len(keys[0])
        body = b"".join(k + struct.pack("<Q", c) for k, c in zip(keys, kids))
        body += keys[len(kids)]
        body += b"\0" * ((capacity - len(kids)) * (key_size + 8))
        head = b"TREE" + struct.pack("<BBHQQ", node_type, level, len(kids),
                                     UNDEF, UNDEF)
        return self.put(head + body)

    def btree(self, node_type: int, keys: list[bytes], kids: list[int],
              capacity: int) -> int:
        """A B-tree over ``kids`` (``len(kids) + 1`` keys, the last
        closing the range), levels added until one node holds them."""
        level = 0
        while True:
            if len(kids) <= capacity:
                return self.btree_node(node_type, level, keys, kids,
                                       capacity)
            up_keys, up_kids = [], []
            for i in range(0, len(kids), capacity):
                part = slice(i, i + capacity)
                up_kids.append(self.btree_node(
                    node_type, level, keys[part] + [keys[min(
                        i + capacity, len(kids))]], kids[part], capacity))
                up_keys.append(keys[i])
            up_keys.append(keys[-1])
            keys, kids, level = up_keys, up_kids, level + 1

    def dataset(self, array: np.ndarray, chunks) -> int:
        """Write the data of ``array`` and its object header; returns the
        header's address."""
        dtype = array.dtype.newbyteorder("<")
        msgs = [_message(_DATASPACE, _dataspace_message(array.shape)),
                _message(_DATATYPE, _dtype_message(dtype))]
        if chunks is None:
            raw = np.ascontiguousarray(array, dtype).tobytes()
            address = self.put(raw) if raw else UNDEF
            msgs.append(_message(_FILL, bytes([2, 2, 2, 0])))
            msgs.append(_message(_LAYOUT, struct.pack(
                "<BBQQ", 3, 1, address, len(raw))))
        else:
            keys, kids = self.chunks(array, dtype, chunks)
            btree = self.btree(1, keys, kids, 2 * CHUNK_K)
            rank1 = array.ndim + 1
            msgs.append(_message(_FILL, bytes([2, 3, 2, 0])))
            msgs.append(_message(_LAYOUT, struct.pack(
                "<BBBQ", 3, 2, rank1, btree) + b"".join(
                struct.pack("<I", c) for c in (*chunks, dtype.itemsize))))
            msgs.append(_message(_FILTERS, _deflate_message()))
        return self.put(_object_header(msgs))

    def chunks(self, array, dtype, chunks):
        """Compress and write every chunk (edge chunks padded with zeros
        to the full chunk shape), in row-major chunk order; the chunk
        B-tree's keys and children."""
        grid = [range(0, n, c) for n, c in zip(array.shape, chunks)]
        keys, kids = [], []
        last = None
        for offset in np.ndindex(*[len(g) for g in grid]):
            start = [g[i] for g, i in zip(grid, offset)]
            block = np.zeros(chunks, dtype)
            src = tuple(slice(s, min(s + c, n))
                        for s, c, n in zip(start, chunks, array.shape))
            block[tuple(slice(0, s.stop - s.start) for s in src)] = \
                array[src]
            raw = zlib.compress(block.tobytes(), GZIP_LEVEL)
            kids.append(self.put(raw))
            keys.append(struct.pack("<II", len(raw), 0) + b"".join(
                struct.pack("<Q", s) for s in (*start, 0)))
            last = start
        end = [s + c for s, c in zip(last, chunks)] + [dtype.itemsize]
        keys.append(struct.pack("<II", 0, 0) + b"".join(
            struct.pack("<Q", s) for s in end))
        return keys, kids


def write(path: str, datasets: Mapping[str, np.ndarray], *,
          compression: str | None = "gzip") -> None:
    """A new HDF5 file at ``path`` holding ``datasets`` (name -> array, at
    the root group).  ``compression`` 'gzip' writes each chunked (h5py's
    chunk shape) through deflate; None writes each contiguous.  The file
    is written under a temporary name and then renamed."""
    if compression not in ("gzip", None):
        raise H5Unsupported(f"compression {compression!r}")
    names = sorted(datasets)
    if len(names) > 2 * GROUP_LEAF_K * 2 * GROUP_NODE_K:
        raise H5Unsupported(f"{len(names)} datasets in one group")
    if any("/" in n or not n for n in names):
        raise H5Unsupported("dataset names must be plain names at the root")
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        w = _Writer(fh)
        w.put(b"\0" * 96)                     # the superblock, at the end
        headers = {}
        for name in names:
            array = np.asarray(datasets[name]) if not isinstance(
                datasets[name], np.memmap) else datasets[name]
            shape = None if compression is None else guess_chunk(
                array.shape, array.dtype.itemsize)
            headers[name] = w.dataset(array, shape)
        # the root group: local heap of names, symbol nodes, group B-tree
        heap, offsets = bytearray(b"\0" * 8), {}
        for name in names:
            offsets[name] = len(heap)
            heap += name.encode() + b"\0"
            heap += b"\0" * (-len(heap) % 8)
        heap_data = w.put(bytes(heap))
        # free-list offset 1: HDF5's "no free block"
        heap_addr = w.put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1,
                                                heap_data))
        per = 2 * GROUP_LEAF_K
        snods, keys = [], [struct.pack("<Q", 0)]
        for i in range(0, len(names), per) or [0]:
            part = names[i:i + per]
            entries = b"".join(struct.pack("<QQII16x", offsets[n], headers[n],
                                           0, 0) for n in part)
            entries += b"\0" * (40 * (per - len(part)))
            snods.append(w.put(b"SNOD" + struct.pack("<BBH", 1, 0, len(part))
                               + entries))
            keys.append(struct.pack("<Q", offsets[part[-1]] if part else 0))
        btree = w.btree(0, keys, snods, 2 * GROUP_NODE_K)
        root = w.put(_object_header([_message(_SYMBOL_TABLE, struct.pack(
            "<QQ", btree, heap_addr))]))
        eof = w.tell()
        fh.seek(0)
        fh.write(SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                 + struct.pack("<HHI", GROUP_LEAF_K, GROUP_NODE_K, 0)
                 + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
                 + struct.pack("<QQII", 0, root, 1, 0)
                 + struct.pack("<QQ", btree, heap_addr))
    os.replace(tmp, path)
