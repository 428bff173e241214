"""Reader of ``sed_tpu``'s orbax checkpoints, without orbax, tensorstore or
zstandard.

``sed_tpu`` writes ``save_checkpoint(..., backend="orbax")`` as an orbax
``PyTreeCheckpointer`` directory ``iteration_{n}.ckpt.orbax`` of
``flax.serialization.to_state_dict`` of its train state
(``sed_tpu/train/checkpoint.py``).  With orbax's defaults that directory is
an OCDBT key-value database (tensorstore's "optionally-cooperative
distributed B+tree", https://google.github.io/tensorstore/kvstore/ocdbt/)
holding one zarr v2 array per leaf, and a ``_METADATA`` JSON naming the
leaves:

  * ``_METADATA``: ``{"tree_metadata": {"('params', 'Dense_0', 'bias')":
    {"key_metadata": [{"key": "params", "key_type": 2}, ...],
    "value_metadata": {"value_type": "np.ndarray", ...}}, ...}}``; key type
    2 is a dict key, 1 a sequence index.  Leaf ``('a', 'b')`` is the zarr
    array under the key prefix ``a.b/``;
  * ``manifest.ocdbt``, the database's root: a config (uuid, manifest
    kind, limits, compression) and the inline version list, of which the
    latest version's root node is read.  Per-process subtrees
    (``ocdbt.process_0/``) are reached through the data files the nodes
    name;
  * every manifest and B+tree node is an envelope: a 4-byte big-endian
    magic (``0x0cdb3a2a`` a manifest, ``0x0cdb20de`` a node), the 8-byte
    little-endian length of the whole envelope, a varint format version
    (0), a varint compression (0 none, 1 zstd), the body, and a CRC-32C of
    everything before it (little-endian);
  * a node body: its height (0 a leaf), its table of data files (paths
    front-coded, relative to the node's own base path), then its entries'
    keys (front-coded); a leaf's values are inline bytes or (data file,
    offset, length) references, an interior node's children are (data file,
    offset, length) of a node whose keys continue after the entry's
    ``subtree_common_prefix``;
  * the arrays: ``<name>/.zarray`` (JSON: shape, chunks, dtype, order
    "C", compressor ``{"id": "zstd"}`` or none, fill_value,
    ``dimension_separator``) and chunks ``<name>/i.j.k`` ("0" for a
    scalar's ``chunks: []``), each a zstd frame of the chunk's C-order
    bytes; edge chunks are stored whole and cropped.

zstd frames are decoded by the system's ``libzstd.so.1`` through ctypes
(its streaming API: the frames carry no content size).  A missing library
raises; nothing is skipped.  Anything outside this subset raises
``ValueError`` naming the file and the byte offset, as
:mod:`sed_tpu_torch.train.flax_ckpt` does.

:func:`read_orbax_checkpoint` returns what
:func:`sed_tpu_torch.train.flax_ckpt.read_flax_checkpoint` returns for the
msgpack save of the same state: the nested dict of numpy arrays
(bfloat16 widened to float32).
"""

from __future__ import annotations

import ast
import ctypes
import json
import os
import struct

import numpy as np

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
COMPRESSION_NONE, COMPRESSION_ZSTD = 0, 1
MANIFEST_SINGLE = 0
VALUE_INLINE, VALUE_INDIRECT = 0, 1
KEY_SEQUENCE, KEY_DICT = 1, 2
ARRAY_TYPES = ("np.ndarray", "jax.Array", "scalar")
METADATA = "_METADATA"
MANIFEST = "manifest.ocdbt"
STATE_KEYS = ("step", "params", "batch_stats", "opt_state")
ZSTD_LIBRARY = "libzstd.so.1"


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli), as the envelopes' footers carry it."""
    c = 0xFFFFFFFF
    table = _CRC32C
    for b in bytes(data):
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Buffer(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


_zstd = None


def zstd_library():
    """The system's libzstd (``libzstd.so.1``), loaded once; raises
    ``RuntimeError`` when it is missing."""
    global _zstd
    if _zstd is None:
        try:
            lib = ctypes.CDLL(ZSTD_LIBRARY)
        except OSError as e:
            raise RuntimeError(f"reading an orbax checkpoint needs the system's zstd library "
                               f"({ZSTD_LIBRARY}), which did not load: {e}") from None
        lib.ZSTD_createDStream.restype = ctypes.c_void_p
        lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
        lib.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
        lib.ZSTD_initDStream.restype = ctypes.c_size_t
        lib.ZSTD_decompressStream.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Buffer),
                                              ctypes.POINTER(_Buffer)]
        lib.ZSTD_decompressStream.restype = ctypes.c_size_t
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_versionNumber.restype = ctypes.c_uint
        _zstd = lib
    return _zstd


def zstd_decompress(data: bytes, limit: int, where: str) -> bytes:
    """The concatenated zstd frames of ``data`` decoded, at most ``limit``
    bytes; ``where`` names the file and offset in errors."""
    lib = zstd_library()
    src = ctypes.create_string_buffer(bytes(data), len(data))
    inp = _Buffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
    cap = max(1 << 12, min(limit, 4 * len(data) + (1 << 12)))
    out_mem = ctypes.create_string_buffer(cap)
    out = _Buffer(ctypes.cast(out_mem, ctypes.c_void_p), cap, 0)
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise RuntimeError("ZSTD_createDStream failed")
    try:
        ret = lib.ZSTD_initDStream(stream)
        if lib.ZSTD_isError(ret):
            raise RuntimeError(f"ZSTD_initDStream: {lib.ZSTD_getErrorName(ret).decode()}")
        while True:
            ret = lib.ZSTD_decompressStream(stream, ctypes.byref(out), ctypes.byref(inp))
            if lib.ZSTD_isError(ret):
                raise ValueError(f"orbax checkpoint: {where}: zstd: "
                                 f"{lib.ZSTD_getErrorName(ret).decode()}")
            if ret == 0 and inp.pos == inp.size:
                break
            if out.pos == out.size:
                if cap >= limit:
                    raise ValueError(f"orbax checkpoint: {where}: zstd data decodes to more "
                                     f"than {limit} bytes")
                cap = min(limit, 2 * cap)
                grown = ctypes.create_string_buffer(cap)
                ctypes.memmove(grown, out_mem, out.pos)
                out_mem = grown
                out = _Buffer(ctypes.cast(out_mem, ctypes.c_void_p), cap, out.pos)
            elif inp.pos == inp.size:
                raise ValueError(f"orbax checkpoint: {where}: truncated zstd frame")
        return out_mem.raw[:out.pos]
    finally:
        lib.ZSTD_freeDStream(stream)


class _Reader:
    """Sequential decoding of one body; errors name ``path`` and the file
    offset (``base`` is the body's first byte in the file, or the envelope's
    when the body was decompressed)."""

    def __init__(self, data: bytes, path: str, base: int, compressed: bool):
        self.data, self.path, self.base, self.compressed = data, path, base, compressed
        self.pos = 0

    def fail(self, what: str):
        at = (f"in the compressed body at byte {self.base}, decoded offset {self.pos}"
              if self.compressed else f"at byte {self.base + self.pos}")
        raise ValueError(f"orbax checkpoint: {self.path}: {what} {at}")

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail(f"truncated (needs {n} more bytes)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def varint(self) -> int:
        value = shift = 0
        for _ in range(10):
            b = self.u8()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
        self.fail("a varint longer than 10 bytes")

    def varints(self, n: int):
        return [self.varint() for _ in range(n)]

    def end(self):
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} trailing bytes")


class _DataFile:
    __slots__ = ("base", "rel")

    def __init__(self, base: str, rel: str):
        self.base, self.rel = base, rel

    @property
    def path(self) -> str:
        return self.base + self.rel


class OcdbtReader:
    """The key-value view of one OCDBT database directory ``root``:
    :meth:`items` walks the latest version's B+tree."""

    def __init__(self, root: str):
        self.root = root
        self._files = {}
        body, path, base, compressed = self._envelope(_DataFile("", MANIFEST), 0, None,
                                                      MANIFEST_MAGIC, 1 << 24)
        r = _Reader(body, path, base, compressed)
        r.take(16)                                   # uuid
        kind = r.varint()
        if kind != MANIFEST_SINGLE:
            r.fail(f"manifest kind {kind} (only 0, a single manifest file, is read)")
        self.max_inline = r.varint()
        self.max_node_bytes = r.varint()
        r.u8()                                       # version_tree_arity_log2
        method = r.varint()
        if method == COMPRESSION_ZSTD:
            r.u32()                                  # zstd level
        elif method != COMPRESSION_NONE:
            r.fail(f"compression method {method}")
        files = self._table(r, "")
        n = r.varint()
        if n < 1:
            r.fail("a manifest with no version")
        generations = r.varints(n)
        heights = [r.u8() for _ in range(n)]
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        num_keys = r.varints(n)
        r.varints(n)                                 # num_tree_bytes
        r.varints(n)                                 # num_indirect_value_bytes
        [r.u64() for _ in range(n)]                  # commit_time
        if r.varint() != 0:
            r.fail("version tree nodes outside the manifest")
        r.end()
        last = max(range(n), key=lambda k: generations[k])
        self.root_ref = None
        if num_keys[last]:
            if ids[last] >= len(files):
                r.fail(f"data file id {ids[last]} of {len(files)}")
            self.root_ref = (files[ids[last]], offsets[last], lengths[last], heights[last])

    def _open(self, f: _DataFile) -> bytes:
        if f.path not in self._files:
            full = os.path.join(self.root, f.path)
            if os.path.isabs(f.path) or ".." in f.path.split("/"):
                raise ValueError(f"orbax checkpoint: {self.root}: a data file path "
                                 f"{f.path!r} outside the checkpoint")
            try:
                with open(full, "rb") as fh:
                    self._files[f.path] = fh.read()
            except OSError as e:
                raise ValueError(f"orbax checkpoint: {full}: {e.strerror}") from None
        return self._files[f.path]

    def _envelope(self, f: _DataFile, offset: int, length, magic: int, limit: int):
        """(body, path, offset of the body or envelope, compressed) of the
        envelope at ``offset`` of ``f``, its CRC and length checked."""
        data = self._open(f)
        path = os.path.join(self.root, f.path)
        if length is None:
            length = len(data) - offset
        blob = data[offset:offset + length]
        r = _Reader(blob, path, offset, False)
        if len(blob) != length or length < 4 + 8 + 2 + 4:
            r.fail(f"an envelope of {length} bytes past the file's end or too short")
        got = struct.unpack(">I", r.take(4))[0]
        if got != magic:
            r.fail(f"magic 0x{got:08x}, expected 0x{magic:08x}")
        declared = r.u64()
        if declared != length:
            r.fail(f"an envelope length {declared} for a {length}-byte reference")
        crc = struct.unpack("<I", blob[-4:])[0]
        if crc32c(blob[:-4]) != crc:
            r.pos = length - 4
            r.fail("a CRC-32C mismatch")
        version = r.varint()
        if version != FORMAT_VERSION:
            r.fail(f"format version {version}")
        method = r.varint()
        body = blob[r.pos:-4]
        if method == COMPRESSION_NONE:
            return body, path, offset + r.pos, False
        if method == COMPRESSION_ZSTD:
            return (zstd_decompress(body, limit, f"{path} at byte {offset + r.pos}"),
                    path, offset + r.pos, True)
        r.fail(f"compression {method}")

    @staticmethod
    def _table(r: _Reader, base: str):
        """A data file table; paths relative to the base path ``base`` of
        the file holding it."""
        n = r.varint()
        prefix = [0] + r.varints(n - 1) if n else []
        suffix = r.varints(n)
        base_len = r.varints(n)
        files, prev = [], b""
        for k in range(n):
            if prefix[k] > len(prev):
                r.fail(f"a path prefix of {prefix[k]} bytes after a {len(prev)}-byte path")
            path = prev[:prefix[k]] + r.take(suffix[k])
            if base_len[k] > len(path):
                r.fail(f"a base path of {base_len[k]} bytes in a {len(path)}-byte path")
            prev = path
            try:
                text = path.decode("utf-8")
            except UnicodeDecodeError:
                r.fail("a data file path that is not UTF-8")
            files.append(_DataFile(base + text[:base_len[k]], text[base_len[k]:]))
        return files

    @staticmethod
    def _keys(r: _Reader, n: int, extra: bool):
        prefix = [0] + r.varints(n - 1) if n else []
        suffix = r.varints(n)
        common = r.varints(n) if extra else None
        keys, prev = [], b""
        for k in range(n):
            if prefix[k] > len(prev):
                r.fail(f"a key prefix of {prefix[k]} bytes after a {len(prev)}-byte key")
            prev = prev[:prefix[k]] + r.take(suffix[k])
            keys.append(prev)
        return keys, common

    def items(self):
        """``{key: value}``: every key of the latest version, its value
        as bytes (inline or read from its data file)."""
        out = {}
        if self.root_ref is not None:
            f, offset, length, height = self.root_ref
            self._walk(f, offset, length, height, b"", out)
        return out

    def _walk(self, f: _DataFile, offset: int, length: int, height: int, prefix: bytes,
              out: dict):
        body, path, base, compressed = self._envelope(f, offset, length, NODE_MAGIC,
                                                      self.max_node_bytes)
        r = _Reader(body, path, base, compressed)
        got = r.u8()
        if got != height:
            r.pos -= 1
            r.fail(f"a node of height {got} where its parent says {height}")
        files = self._table(r, f.base)
        n = r.varint()
        if n == 0:
            r.fail("a node with no entry")

        def file_of(k):
            if k >= len(files):
                r.fail(f"data file id {k} of {len(files)}")
            return files[k]

        if height == 0:
            keys, _ = self._keys(r, n, False)
            lengths = r.varints(n)
            kinds = r.varints(n)
            indirect = [k for k in range(n) if kinds[k] == VALUE_INDIRECT]
            if any(kind not in (VALUE_INLINE, VALUE_INDIRECT) for kind in kinds):
                r.fail(f"value kinds {sorted(set(kinds))}")
            ids = r.varints(len(indirect))
            offsets = r.varints(len(indirect))
            refs = dict(zip(indirect, zip(ids, offsets)))
            for k in range(n):
                if k in refs:
                    fid, off = refs[k]
                    data = self._open(file_of(fid))
                    if off + lengths[k] > len(data):
                        r.fail(f"a value at {off}+{lengths[k]} past the end of "
                               f"{file_of(fid).path}")
                    out[prefix + keys[k]] = data[off:off + lengths[k]]
                else:
                    out[prefix + keys[k]] = r.take(lengths[k])
            r.end()
            return
        keys, common = self._keys(r, n, True)
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)                             # num_keys, tree bytes, indirect bytes
        r.end()
        for k in range(n):
            if common[k] > len(keys[k]):
                r.fail(f"a subtree prefix of {common[k]} bytes for a {len(keys[k])}-byte key")
            self._walk(file_of(ids[k]), offsets[k], lengths[k], height - 1,
                       prefix + keys[k][:common[k]], out)


def _zarr_dtype(name: str, where: str):
    if name == "bfloat16":
        return "bfloat16"
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"orbax checkpoint: {where}: zarr dtype {name!r}") from None
    if dtype.hasobject or dtype.fields is not None:
        raise ValueError(f"orbax checkpoint: {where}: zarr dtype {name!r}")
    return dtype


def read_zarr_array(kv: dict, name: str, where: str) -> np.ndarray:
    """The zarr v2 array stored under ``name/`` in the key-value dict
    ``kv`` (``where``: the checkpoint, for errors)."""
    meta_key = f"{name}/.zarray".encode()
    if meta_key not in kv:
        raise ValueError(f"orbax checkpoint: {where}: no array {name!r} (no {name}/.zarray)")
    try:
        meta = json.loads(kv[meta_key])
        shape = [int(d) for d in meta["shape"]]
        chunks = [int(d) for d in meta["chunks"]]
        dtype_name = meta["dtype"]
        order = meta.get("order", "C")
        compressor = meta.get("compressor")
        sep = meta.get("dimension_separator", ".")
        fill = meta.get("fill_value")
        filters = meta.get("filters")
        zarr_format = meta.get("zarr_format", 2)
    except (ValueError, KeyError, TypeError) as e:
        raise ValueError(f"orbax checkpoint: {where}: {name}/.zarray: {e!r}") from None
    at = f"{where}: {name}"
    if zarr_format != 2 or order != "C" or filters or len(chunks) != len(shape) \
            or any(c <= 0 for c in chunks):
        raise ValueError(f"orbax checkpoint: {at}: zarr layout {meta} (zarr v2, C order, "
                         f"no filters, one chunk size a dimension is read)")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"orbax checkpoint: {at}: compressor {compressor}")
    dtype = _zarr_dtype(dtype_name, at)
    store = np.dtype("<u2") if dtype == "bfloat16" else dtype
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    out = np.empty(shape, store)
    if fill is None:
        out[...] = 0
    else:
        try:
            out[...] = fill
        except (TypeError, ValueError):
            raise ValueError(f"orbax checkpoint: {at}: fill_value {fill!r}") from None
    nbytes = int(np.prod(chunks, dtype=np.int64)) * store.itemsize
    for index in np.ndindex(*grid):
        key = f"{name}/{sep.join(str(i) for i in index) if index else '0'}".encode()
        if key not in kv:
            continue                                 # a chunk of fill values
        raw = kv[key]
        if compressor is not None:
            raw = zstd_decompress(raw, nbytes, f"{at}, chunk {key.decode()}")
        if len(raw) != nbytes:
            raise ValueError(f"orbax checkpoint: {at}: chunk {key.decode()} holds "
                             f"{len(raw)} bytes, expected {nbytes}")
        chunk = np.frombuffer(raw, store).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    if dtype == "bfloat16":   # the upper half of a float32: widen exactly
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out


def _leaf_keys(entry: dict, where: str):
    keys = []
    for km in entry["key_metadata"]:
        if km.get("key_type") not in (KEY_DICT, KEY_SEQUENCE):
            raise ValueError(f"orbax checkpoint: {where}: key type {km.get('key_type')}")
        keys.append(str(km["key"]))
    return keys


def read_orbax_checkpoint(path: str) -> dict:
    """``{"step", "params", "batch_stats", "opt_state"}`` of a ``sed_tpu``
    ``.ckpt.orbax`` directory, numpy arrays at the leaves, as
    :func:`sed_tpu_torch.train.flax_ckpt.read_flax_checkpoint` returns for
    the msgpack save of the same state."""
    path = path.rstrip(os.sep) or path
    meta_path = os.path.join(path, METADATA)
    if not os.path.isfile(meta_path) or not os.path.isfile(os.path.join(path, MANIFEST)):
        raise ValueError(f"orbax checkpoint: {path}: not an orbax OCDBT checkpoint "
                         f"directory (no {METADATA} and {MANIFEST}) at byte 0")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        tree_meta = meta["tree_metadata"]
    except (ValueError, KeyError, TypeError) as e:
        raise ValueError(f"orbax checkpoint: {meta_path}: {e!r} at byte 0") from None
    if meta.get("use_zarr3"):
        raise ValueError(f"orbax checkpoint: {meta_path}: zarr v3 arrays (only v2 is read) "
                         f"at byte 0")
    kv = OcdbtReader(path).items()
    tree = {}
    for name, entry in tree_meta.items():
        try:
            keys = _leaf_keys(entry, meta_path)
            value_type = entry["value_metadata"]["value_type"]
        except (KeyError, TypeError) as e:
            raise ValueError(f"orbax checkpoint: {meta_path}: leaf {name}: {e!r}") from None
        if keys != [str(k) for k in ast.literal_eval(name)]:
            raise ValueError(f"orbax checkpoint: {meta_path}: leaf {name} has keys {keys}")
        if value_type not in ARRAY_TYPES:
            raise ValueError(f"orbax checkpoint: {meta_path}: leaf {name} of type "
                             f"{value_type!r} (arrays are read)")
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = read_zarr_array(kv, ".".join(keys), path)
    if not set(STATE_KEYS) <= set(tree):
        raise ValueError(f"{path}: not a sed_tpu train state (top level {sorted(tree)}, "
                         f"expected {list(STATE_KEYS)}) at byte 0")
    return tree
