"""Orbax checkpoints without JAX: the port's reader and writer of the step
directories that ``avjepa_tpu/utils/checkpoint.py``'s ``CheckpointManager``
keeps (``<tag>-ckpt/<step>``), and a manager with that class's surface.

Orbax (``StandardSave`` over OCDBT and zarr v2) lays a step out as:

- ``<dir>/<step>/_CHECKPOINT_METADATA``: JSON, written last (the commit marker);
  a step is written under ``<step>.orbax-checkpoint-tmp-<ns>`` and renamed;
- ``<step>/default/_METADATA``: JSON, ``tree_metadata`` keyed by key paths,
  ``"use_ocdbt": true``, ``"use_zarr3": false``;
- an OCDBT key-value store under ``<step>/default``: ``manifest.ocdbt`` names
  the latest version's B-tree root in a data file (``d/<hash>``, or
  ``ocdbt.process_<i>/d/<hash>`` for the stores of a multi-process save).
  Manifest and node files are framed (magic ``0c db 3a 2a`` or ``0c db 20
  de``, length u64le, version, compression 0 = none or 1 = zstd, payload,
  CRC-32C u32le over all before it). Leaf entries hold prefix-compressed
  keys and values inline or as references (data file, offset, length) into
  data files holding the values raw. Interior entries name a child node and
  the key prefix its subtree shares, which the child's keys omit;
- in that store, one zarr v2 array a leaf: ``<a.b.c>/.zarray`` (JSON:
  ``chunks``, ``compressor`` zstd or null, ``dtype``, ``fill_value``,
  ``shape``) and chunk keys ``<a.b.c>/<i>.<j>`` (``0`` at rank 0), each the
  chunk's C-order bytes, whole at the edges, zstd-compressed or raw.

Reading compressed data (everything Orbax writes) needs ``libzstd.so.1``,
bound with ``ctypes``; a missing library raises naming it. The writer stores
nodes and chunks uncompressed and needs no library; the JAX package's
manager restores what it writes.
Trees are nested dicts keyed as ``_METADATA`` keys them; the reader's leaves
are CPU tensors, the writer takes tensors or numpy arrays.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import shutil
import struct
import time
import uuid
from typing import Iterator, Optional

import numpy as np
import torch

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
ITEM = "default"  # StandardSave's item name
COMMIT_FILE = "_CHECKPOINT_METADATA"
TMP_SUFFIX = ".orbax-checkpoint-tmp"
_NO_ROOT = 2 ** 64 - 1  # the root offset of an empty tree

# ---------------------------------------------------------------------------
# zstd, through the system's libzstd
# ---------------------------------------------------------------------------

_zstd_lib: Optional[ctypes.CDLL] = None


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def _zstd() -> ctypes.CDLL:
    """libzstd, loaded once; OSError naming it when the host lacks it."""
    global _zstd_lib
    if _zstd_lib is None:
        try:
            lib = ctypes.CDLL("libzstd.so.1")
        except OSError:
            raise OSError("libzstd.so.1 is not installed: reading a zstd-compressed Orbax "
                          "checkpoint (what Orbax writes) needs it") from None
        sz, ptr = ctypes.c_size_t, ctypes.c_void_p
        lib.ZSTD_getFrameContentSize.argtypes = [ptr, sz]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_decompress.argtypes = [ptr, sz, ptr, sz]
        lib.ZSTD_decompress.restype = sz
        lib.ZSTD_compress.argtypes = [ptr, sz, ptr, sz, ctypes.c_int]
        lib.ZSTD_compress.restype = sz
        lib.ZSTD_compressBound.argtypes = [sz]
        lib.ZSTD_compressBound.restype = sz
        lib.ZSTD_isError.argtypes = [sz]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_getErrorName.argtypes = [sz]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_createDStream.argtypes = []
        lib.ZSTD_createDStream.restype = ptr
        lib.ZSTD_freeDStream.argtypes = [ptr]
        lib.ZSTD_freeDStream.restype = sz
        lib.ZSTD_initDStream.argtypes = [ptr]
        lib.ZSTD_initDStream.restype = sz
        lib.ZSTD_decompressStream.argtypes = [ptr, ctypes.POINTER(_OutBuffer),
                                              ctypes.POINTER(_InBuffer)]
        lib.ZSTD_decompressStream.restype = sz
        _zstd_lib = lib
    return _zstd_lib


def zstd_available() -> bool:
    try:
        _zstd()
    except OSError:
        return False
    return True


def _zcheck(lib: ctypes.CDLL, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd {what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def _bytes_view(a: np.ndarray) -> np.ndarray:
    """The bytes of an array as a flat uint8 array (a view when contiguous)."""
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _addr(buf) -> int:
    """Address of a writable buffer (bytearray or numpy array)."""
    return np.frombuffer(buf, np.uint8).ctypes.data


def zstd_decompress(src: bytes, size: Optional[int] = None, out=None):
    """Decompress the zstd frame(s) in ``src``. With ``size`` (or a frame
    header that states it) in one call, into ``out`` when given (a writable
    buffer of ``size`` bytes, returned); else by streaming. Returns bytes."""
    lib = _zstd()
    src = bytes(src)
    if size is None:
        n = lib.ZSTD_getFrameContentSize(src, len(src))
        size = None if n >= 2 ** 64 - 2 else n  # unknown, or an error: stream
    if size is not None:
        dst = out if out is not None else bytearray(size)
        got = _zcheck(lib, lib.ZSTD_decompress(_addr(dst) if size else None, size, src,
                                               len(src)), "decompress")
        if got != size:
            raise ValueError(f"zstd frame holds {got} bytes, expected {size}")
        return dst if out is not None else bytes(dst)
    stream = lib.ZSTD_createDStream()
    try:
        _zcheck(lib, lib.ZSTD_initDStream(stream), "init")
        chunk = bytearray(1 << 20)
        inb = _InBuffer(ctypes.cast(ctypes.c_char_p(src), ctypes.c_void_p), len(src), 0)
        parts = []
        while True:
            outb = _OutBuffer(_addr(chunk), len(chunk), 0)
            ret = _zcheck(lib, lib.ZSTD_decompressStream(stream, ctypes.byref(outb),
                                                         ctypes.byref(inb)), "stream")
            parts.append(bytes(chunk[:outb.pos]))
            if inb.pos == inb.size and outb.pos < outb.size:
                if ret != 0:
                    raise ValueError("zstd stream ends inside a frame")
                return b"".join(parts)
    finally:
        lib.ZSTD_freeDStream(stream)


def zstd_compress(data, level: int = 1) -> bytes:
    """One zstd frame of ``data`` (bytes or a contiguous array)."""
    lib = _zstd()
    src = np.frombuffer(data, np.uint8) if isinstance(data, bytes) else _bytes_view(data)
    cap = lib.ZSTD_compressBound(src.size)
    dst = bytearray(cap)
    n = _zcheck(lib, lib.ZSTD_compress(_addr(dst), cap, src.ctypes.data if src.size else None,
                                       src.size, level), "compress")
    return bytes(dst[:n])


# ---------------------------------------------------------------------------
# OCDBT: encoding primitives
# ---------------------------------------------------------------------------

def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT frames its files."""
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("OCDBT record ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        n, shift = 0, 0
        while True:
            b = self.u8()
            n |= (b & 0x7F) << shift
            if b < 0x80:
                return n
            shift += 7

    def varints(self, count: int) -> list[int]:
        return [self.varint() for _ in range(count)]


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _unframe(data: bytes, magic: int, what: str) -> bytes:
    """The payload of a manifest or node file: checks magic, length, CRC."""
    if len(data) < 18 or struct.unpack(">I", data[:4])[0] != magic:
        raise ValueError(f"not an OCDBT {what}")
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise ValueError(f"OCDBT {what} is {len(data)} bytes, its header says {length}")
    if crc32c(data[:-4]) != struct.unpack("<I", data[-4:])[0]:
        raise ValueError(f"OCDBT {what}: checksum mismatch")
    c = _Cursor(data[:-4])
    c.pos = 12
    if c.varint() != 0:
        raise ValueError(f"OCDBT {what}: unknown format version")
    compression = c.varint()
    body = data[c.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd_decompress(body)
    raise ValueError(f"OCDBT {what}: unknown compression {compression}")


def _frame(payload: bytes, magic: int) -> bytes:
    head = struct.pack(">I", magic)
    body = _varint(0) + _varint(0) + payload  # version 0, uncompressed
    length = 4 + 8 + len(body) + 4
    data = head + struct.pack("<Q", length) + body
    return data + struct.pack("<I", crc32c(data))


def _read_file_table(c: _Cursor) -> list[str]:
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    c.varints(n)  # the base-path lengths: where each path's base ends
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + c.take(s)
        paths.append(prev.decode())
    return paths


def _file_table(paths: list[str]) -> bytes:
    """The data-file table of ``paths`` (no shared prefixes, no base path)."""
    return (_varint(len(paths)) + _varints(0 for _ in paths[1:]) + _varints(len(p) for p in paths)
            + _varints(0 for _ in paths) + b"".join(p.encode() for p in paths))


# ---------------------------------------------------------------------------
# OCDBT: reading
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Ref:
    path: str  # relative to the store's root
    offset: int
    length: int


class OcdbtStore:
    """The latest version of the OCDBT store under ``root``, its keys read
    whole: ``key in store`` and ``read(key)``, values inline or read from
    data files."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "manifest.ocdbt"), "rb") as f:
            c = _Cursor(_unframe(f.read(), MANIFEST_MAGIC, "manifest"))
        c.take(16)  # uuid
        if c.varint() != 0:
            raise ValueError(f"{root}: numbered OCDBT manifests are not supported")
        c.varint()  # max_inline_value_bytes
        c.varint()  # max_decoded_node_bytes
        c.u8()  # version_tree_arity_log2
        if c.varint() == 1:
            c.take(4)  # zstd level
        files = _read_file_table(c)
        n = c.varint()
        gen = c.varints(n)
        height = [c.u8() for _ in range(n)]
        file_id, offset, length = c.varints(n), c.varints(n), c.varints(n)
        self.values: dict[bytes, object] = {}
        self.height = None  # the latest version's B-tree height; None: empty
        if not n:
            return
        i = max(range(n), key=gen.__getitem__)  # the latest version
        if offset[i] != _NO_ROOT:
            self.height = height[i]
            self._walk(_Ref(files[file_id[i]], offset[i], length[i]), b"", height[i])

    def _read_ref(self, ref: _Ref) -> bytes:
        with open(os.path.join(self.root, ref.path), "rb") as f:
            f.seek(ref.offset)
            data = f.read(ref.length)
        if len(data) != ref.length:
            raise ValueError(f"{ref.path}: {ref.length} bytes at {ref.offset} not there")
        return data

    def _walk(self, ref: _Ref, prefix: bytes, height: int) -> None:
        c = _Cursor(_unframe(self._read_ref(ref), NODE_MAGIC, "B-tree node"))
        if c.u8() != height:
            raise ValueError(f"{ref.path}: B-tree node at {ref.offset} has the wrong height")
        files = _read_file_table(c)
        n = c.varint()
        kprefix = [0] + c.varints(n - 1) if n else []
        ksuffix = c.varints(n)
        common = c.varints(n) if height else None
        keys, prev = [], b""
        for p, s in zip(kprefix, ksuffix):
            prev = prev[:p] + c.take(s)
            keys.append(prev)
        if height:
            file_id, offset, length = c.varints(n), c.varints(n), c.varints(n)
            for k, cp, f, o, ln in zip(keys, common, file_id, offset, length):
                self._walk(_Ref(files[f], o, ln), prefix + k[:cp], height - 1)
            return
        vlen = c.varints(n)
        kind = c.varints(n)
        n_ref = sum(1 for k in kind if k == 1)
        file_id, offset = c.varints(n_ref), c.varints(n_ref)
        refs = iter(zip(file_id, offset))
        for k, ln, kd in zip(keys, vlen, kind):
            if kd == 0:
                self.values[prefix + k] = c.take(ln)
            elif kd == 1:
                f, o = next(refs)
                self.values[prefix + k] = _Ref(files[f], o, ln)
            else:
                raise ValueError(f"{ref.path}: unknown value kind {kd}")

    def __contains__(self, key: str) -> bool:
        return key.encode() in self.values

    def read(self, key: str, out=None):
        """The value at ``key``; a data-file value goes straight into
        ``out`` (a writable buffer of its length) when given."""
        v = self.values[key.encode()]
        if not isinstance(v, _Ref):
            if out is None:
                return v
            if len(v) != len(out):
                raise ValueError(f"{key}: {len(v)} bytes, expected {len(out)}")
            memoryview(out).cast("B")[:] = v
            return out
        if out is None:
            return self._read_ref(v)
        with open(os.path.join(self.root, v.path), "rb") as f:
            f.seek(v.offset)
            if f.readinto(out) != v.length:
                raise ValueError(f"{v.path}: {v.length} bytes at {v.offset} not there")
        return out


# ---------------------------------------------------------------------------
# OCDBT: writing (one version, one leaf, values in one data file)
# ---------------------------------------------------------------------------

def _write_store(root: str, values: list[tuple[str, object]]) -> None:
    """An OCDBT store at ``root`` holding ``values`` (key, bytes or a
    contiguous array), uncompressed: every value is written raw into one
    data file, then the leaf node that refers to them, then the manifest."""
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    data_path = f"d/{uuid.uuid4().hex}"
    values = sorted(values, key=lambda kv: kv[0].encode())
    keys = [k.encode() for k, _ in values]
    if len(set(keys)) != len(keys):
        raise ValueError("duplicate OCDBT keys")
    offsets, lengths = [], []
    with open(os.path.join(root, data_path), "wb") as f:
        for _, v in values:
            offsets.append(f.tell())
            f.write(v if isinstance(v, (bytes, bytearray)) else _bytes_view(v))
            lengths.append(f.tell() - offsets[-1])
        kprefix = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
        node = _frame(
            bytes([0]) + _file_table([data_path]) + _varint(len(keys)) + _varints(kprefix)
            + _varints(len(k) - p for k, p in zip(keys, [0] + kprefix))
            + b"".join(k[p:] for k, p in zip(keys, [0] + kprefix))
            + _varints(lengths) + _varints(1 for _ in keys) + _varints(0 for _ in keys)
            + _varints(offsets), NODE_MAGIC)
        node_at = f.tell()
        f.write(node)
    config = (uuid.uuid4().bytes + _varint(0) + _varint(1024) + _varint(100_000_000)
              + bytes([4]) + _varint(0))
    version = (_varint(1) + _varint(1) + bytes([0]) + _varint(0) + _varint(node_at)
               + _varint(len(node)) + _varint(len(keys)) + _varint(len(node))
               + _varint(sum(lengths)) + struct.pack("<Q", time.time_ns()))
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(_frame(config + _file_table([data_path]) + version + _varint(0),
                       MANIFEST_MAGIC))


# ---------------------------------------------------------------------------
# zarr v2 arrays
# ---------------------------------------------------------------------------

# zarr dtype -> (numpy dtype the bytes are read as, torch dtype of the leaf)
_DTYPES = {
    "<f4": (np.float32, torch.float32), "<f8": (np.float64, torch.float64),
    "<f2": (np.float16, torch.float16), "bfloat16": (np.int16, torch.bfloat16),
    "<i4": (np.int32, torch.int32), "<i8": (np.int64, torch.int64),
    "<i2": (np.int16, torch.int16), "|i1": (np.int8, torch.int8),
    "|u1": (np.uint8, torch.uint8), "|b1": (np.bool_, torch.bool),
}
_ZARR_OF_TORCH = {t: z for z, (_, t) in _DTYPES.items()}


def _fill(meta: dict, torch_dtype):
    """The array's fill value (null, as Orbax writes it: 0), as the numpy
    scalar its chunks' bytes are read as."""
    v = meta.get("fill_value")
    t = torch.tensor(0 if v is None else v, dtype=torch_dtype)
    return (t.view(torch.int16) if torch_dtype == torch.bfloat16 else t).numpy()


def _chunk_key(name: str, index: tuple, sep: str) -> str:
    return f"{name}/{sep.join(map(str, index)) if index else '0'}"


def read_zarr(store: OcdbtStore, name: str) -> torch.Tensor:
    """The zarr v2 array ``name`` of ``store``, whole, as a CPU tensor: any
    chunk grid (edge chunks cut), rank 0, compressor zstd or null, missing
    chunks at the fill value."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2 or meta.get("filters"):
        raise ValueError(f"{name}: only zarr v2 arrays without filters are read")
    if meta["dtype"] not in _DTYPES:
        raise ValueError(f"{name}: dtype {meta['dtype']!r} is not supported")
    np_dtype, torch_dtype = _DTYPES[meta["dtype"]]
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor.get('id')!r} is not supported")
    order, sep = meta.get("order", "C"), meta.get("dimension_separator", ".")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    itemsize = np.dtype(np_dtype).itemsize
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * itemsize

    def load(key: str, out=None):
        """The chunk at ``key`` as an array of the chunk's shape, read into
        ``out``'s bytes when given."""
        if out is None:
            out = np.empty(chunks, np_dtype, order=order)
        buf = out.reshape(-1, order="A").view(np.uint8)
        if compressor is None:
            store.read(key, buf)
        else:
            zstd_decompress(store.read(key), chunk_bytes, buf)
        return out

    whole = tuple(shape) == chunks and order == "C"
    if whole:  # one chunk, the array itself: read in place
        out = np.empty(shape, np_dtype)
        if _chunk_key(name, (0,) * len(shape), sep) in store:
            load(_chunk_key(name, (0,) * len(shape), sep), out)
        else:
            out.fill(_fill(meta, torch_dtype))
    else:
        out = np.full(shape, _fill(meta, torch_dtype), np_dtype)
        grid = [-(-s // c) for s, c in zip(shape, chunks)]
        for index in np.ndindex(*grid):
            key = _chunk_key(name, index, sep)
            if key not in store:
                continue
            chunk = load(key)
            sel = tuple(slice(i * c, min((i + 1) * c, s))
                        for i, c, s in zip(index, chunks, shape))
            out[sel] = chunk[tuple(slice(0, s.stop - s.start) for s in sel)]
    t = torch.from_numpy(out)
    return t.view(torch.bfloat16) if torch_dtype == torch.bfloat16 else t


def _as_array(leaf) -> tuple[np.ndarray, str]:
    """(C-contiguous host array of the leaf's bytes, zarr dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype not in _ZARR_OF_TORCH:
            raise ValueError(f"dtype {t.dtype} cannot be written")
        z = _ZARR_OF_TORCH[t.dtype]
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy(), z
    a = np.asarray(leaf, order="C")
    if a.dtype.name == "bfloat16":  # an ml_dtypes array
        return a.view(np.int16), "bfloat16"
    for z, (np_dtype, torch_dtype) in _DTYPES.items():
        if torch_dtype != torch.bfloat16 and a.dtype == np_dtype:
            return a, z
    raise ValueError(f"dtype {a.dtype} cannot be written")


def _zarray(shape: tuple, zdtype: str) -> bytes:
    meta = {
        "chunks": [max(s, 1) for s in shape],
        "compressor": None,
        "dimension_separator": ".", "dtype": zdtype, "fill_value": None, "filters": None,
        "order": "C", "shape": list(shape), "zarr_format": 2,
    }
    return json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()


# ---------------------------------------------------------------------------
# trees and step directories
# ---------------------------------------------------------------------------

def flatten(tree: dict, path: tuple = ()) -> Iterator[tuple[tuple, object]]:
    """(key path, leaf) of a nested dict, in key order."""
    for k in sorted(tree, key=str):
        v = tree[k]
        if isinstance(v, dict):
            yield from flatten(v, path + (k,))
        else:
            yield path + (k,), v


def unflatten(items) -> dict:
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


@dataclasses.dataclass(frozen=True)
class ArrayMeta:
    shape: tuple
    dtype: torch.dtype


def _tree_metadata(item_dir: str) -> list[tuple[tuple, dict]]:
    with open(os.path.join(item_dir, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{item_dir}: only OCDBT + zarr v2 checkpoints are read")
    out = []
    for entry in meta["tree_metadata"].values():
        path = tuple(k["key"] for k in entry["key_metadata"])
        out.append((path, entry["value_metadata"]))
    return out


def _param_name(path: tuple) -> str:
    return ".".join(str(k) for k in path)


def read_item(item_dir: str, subtree: tuple = ()) -> dict:
    """The tree saved in ``item_dir`` (a step's ``default/``), or only its
    ``subtree`` (a key path) when given."""
    store = OcdbtStore(item_dir)
    items = []
    for path, vm in _tree_metadata(item_dir):
        if path[:len(subtree)] != tuple(subtree):
            continue
        path = path[len(subtree):]
        if vm.get("skip_deserialize"):
            items.append((path, None))
            continue
        leaf = read_zarr(store, _param_name(subtree + path))
        items.append((path, leaf.item() if vm.get("value_type") == "scalar" else leaf))
    if not items:
        raise KeyError(f"{item_dir}: no leaves under {subtree}")
    return unflatten(items)


def item_metadata(item_dir: str) -> dict:
    """The tree's shapes and dtypes (``ArrayMeta``), from ``_METADATA`` and
    each array's ``.zarray``."""
    store = OcdbtStore(item_dir)
    items = []
    for path, _ in _tree_metadata(item_dir):
        meta = json.loads(store.read(f"{_param_name(path)}/.zarray"))
        items.append((path, ArrayMeta(tuple(meta["shape"]), _DTYPES[meta["dtype"]][1])))
    return unflatten(items)


def write_item(item_dir: str, tree: dict) -> None:
    """``tree`` as Orbax's ``StandardSave`` lays out an item (numpy leaves):
    ``_METADATA`` and an OCDBT store of zarr v2 arrays, one chunk each."""
    os.makedirs(item_dir)
    tree_meta, values = {}, []
    for path, leaf in flatten(tree):
        if not all(isinstance(k, str) for k in path):
            raise ValueError(f"tree keys must be strings: {path}")
        a, zdtype = _as_array(leaf)
        name = _param_name(path)
        tree_meta[str(path)] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in path],
            "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False},
        }
        values.append((f"{name}/.zarray", _zarray(a.shape, zdtype)))
        if a.size:
            values.append((_chunk_key(name, (0,) * a.ndim, "."), a))
    _write_store(item_dir, values)
    with open(os.path.join(item_dir, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

class CheckpointManager:
    """``avjepa_tpu.utils.checkpoint.CheckpointManager`` without JAX: one
    ``StandardSave`` item a step, ``<directory>/<step>``. A step counts once
    its directory has an integer name and ``_CHECKPOINT_METADATA`` (Orbax
    writes it last, then renames the temporary directory into place)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory) if re.fullmatch(r"\d+", n)
                      and os.path.isfile(os.path.join(self.directory, n, COMMIT_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _item(self, step: int) -> str:
        return os.path.join(self.directory, str(step), ITEM)

    def save(self, step: int, tree: dict, force: bool = False) -> None:
        """Write ``tree`` as step ``step``; ``force`` drops an existing one
        (else it raises, as Orbax does), then steps beyond ``max_to_keep``
        are pruned, oldest first."""
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):
            if not force:
                raise FileExistsError(f"step {step} already exists in {self.directory}")
            shutil.rmtree(final)
        start = time.time_ns()
        tmp = f"{final}{TMP_SUFFIX}-{start}"
        try:
            write_item(os.path.join(tmp, ITEM), tree)
            with open(os.path.join(tmp, COMMIT_FILE), "w") as f:
                json.dump({"item_handlers": {ITEM: "orbax.checkpoint._src.handlers."
                                             "standard_checkpoint_handler."
                                             "StandardCheckpointHandler"},
                           "metrics": {}, "performance_metrics": {},
                           "init_timestamp_nsecs": start,
                           "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}, f)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.all_steps()[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step: Optional[int] = None, subtree: tuple = ()) -> Optional[dict]:
        """The tree of ``step`` (default the latest), or its ``subtree``;
        None without a step."""
        step = self.latest_step() if step is None else step
        return None if step is None else read_item(self._item(step), subtree)

    def item_metadata(self, step: int) -> dict:
        return item_metadata(self._item(step))

    def close(self) -> None:
        """Nothing to release (saves finish before ``save`` returns)."""
